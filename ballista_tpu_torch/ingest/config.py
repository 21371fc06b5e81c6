"""Ingest pipeline knobs (env-resolved once, ``reconfigure()`` re-reads).
A copy of the JAX package's ``ingest/config.py``.

- ``BALLISTA_INGEST_THREADS``: workers on the shared ingest pool —
  the cross-table parallelism bound. Default ``min(cpu_count, 8)``
  (scan-side work is CPU parse; past the core count extra workers only
  thrash, and the native scanner already multi-threads within one file
  via ``BALLISTA_SCAN_THREADS``). ``1`` serializes tables against each
  other while still overlapping producer and consumer.
- ``BALLISTA_PREFETCH_BATCHES``: bounded prefetch queue depth per scan.
  Default ``2`` (double buffering: one batch in flight to the consumer,
  one being parsed).
  ``0`` disables the pipeline entirely — scans run inline on the
  consuming thread, byte-for-byte the old serial behavior.
"""

from __future__ import annotations

import os
from typing import Optional

_DEFAULT_MAX_THREADS = 8

_threads: Optional[int] = None
_prefetch: Optional[int] = None


def _read_int(name: str, default: int, floor: int = 0) -> int:
    raw = os.environ.get(name, "")
    try:
        val = int(raw)
    except ValueError:
        return default
    return max(val, floor)


def ingest_threads() -> int:
    """Shared ingest pool width (>= 1)."""
    global _threads
    if _threads is None:
        _threads = _read_int(
            "BALLISTA_INGEST_THREADS",
            min(os.cpu_count() or 1, _DEFAULT_MAX_THREADS),
            floor=1,
        )
    return _threads


def prefetch_batches() -> int:
    """Per-scan prefetch queue depth; 0 = pipeline off (serial scans)."""
    global _prefetch
    if _prefetch is None:
        _prefetch = _read_int("BALLISTA_PREFETCH_BATCHES", 2, floor=0)
    return _prefetch


def reconfigure() -> None:
    """Re-read the env and rebuild the pool (tests flip knobs
    mid-process)."""
    global _threads, _prefetch
    _threads = None
    _prefetch = None
    from .pipeline import _reset_pool

    _reset_pool()
