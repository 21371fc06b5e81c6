"""Shape canonicalization: the row-count bucket ladder.

Every distinct batch capacity is a fresh XLA trace + compile, so the
engine quantizes capacities onto a small geometric ladder instead of
tracking exact row counts. A 6M-row scan and its 8 unevenly-sized
shuffle partitions then hit a handful of canonical signatures, and the
persistent compilation cache (keyed by HLO hash) gets a real chance to
hit across batches, runs, and fresh processes — the same batch-bucketing
technique static-shape inference stacks use for serving.

The ladder is ``floor * growth^k`` with both knobs power-of-two (XLA
tilings stay happy):

- ``BALLISTA_SHAPE_BUCKETS``         on/off (default on)
- ``BALLISTA_SHAPE_BUCKETS_FLOOR``   smallest rung (default 1024)
- ``BALLISTA_SHAPE_BUCKETS_GROWTH``  geometric step (default 2)

Correctness rides the engine's existing mask invariants: every batch
carries a ``selection`` live-row mask and a ``num_rows`` live count, and
padding rows are dead by construction (``ColumnBatch.from_numpy`` marks
rows past the logical count unselected), so a bucket-padded batch is
row-identical to an exactly-sized one for every operator.

With buckets off, ``bucket_capacity`` degrades to the exact power-of-two
rounding (``round_capacity``) the engine always used.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

DEFAULT_FLOOR = 1024
DEFAULT_GROWTH = 2

_cfg: Optional[Tuple[bool, int, int]] = None


def next_pow2(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= n (>= minimum). Local copy of
    columnar.round_capacity so this module has no engine imports."""
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap


def _read_config() -> Tuple[bool, int, int]:
    enabled = os.environ.get("BALLISTA_SHAPE_BUCKETS", "on").lower() \
        not in ("0", "off", "false")
    try:
        floor = int(os.environ.get("BALLISTA_SHAPE_BUCKETS_FLOOR",
                                   str(DEFAULT_FLOOR)))
    except ValueError:
        floor = DEFAULT_FLOOR
    try:
        growth = int(os.environ.get("BALLISTA_SHAPE_BUCKETS_GROWTH",
                                    str(DEFAULT_GROWTH)))
    except ValueError:
        growth = DEFAULT_GROWTH
    # both knobs snap to powers of two so every rung is a power of two
    floor = next_pow2(max(floor, 8))
    growth = next_pow2(max(growth, 2), minimum=2)
    return enabled, floor, growth


def _config() -> Tuple[bool, int, int]:
    global _cfg
    if _cfg is None:
        _cfg = _read_config()
    return _cfg


def reconfigure() -> None:
    """Re-read the BALLISTA_SHAPE_BUCKETS* env (tests flip it)."""
    global _cfg
    _cfg = None


def buckets_enabled() -> bool:
    return _config()[0]


def bucket_capacity(n: int, minimum: int = 8) -> int:
    """Canonical capacity for ``n`` rows: the smallest ladder rung that
    holds them (never below ``minimum``). The batch-entry replacement
    for ``round_capacity`` — scans, shuffle reads, repartition outputs
    and compaction targets all quantize through here, so downstream jit
    caches see ladder rungs, not per-partition row counts."""
    enabled, floor, growth = _config()
    if not enabled:
        return next_pow2(n, minimum)
    cap = max(floor, next_pow2(max(minimum, 8)))
    while cap < n:
        cap *= growth
    return cap


def bucket_ladder(max_rows: int, minimum: int = 8) -> List[int]:
    """The ladder rungs covering [1, max_rows] — the bound on distinct
    capacities (and so on per-signature compiles) any input of up to
    ``max_rows`` rows can produce."""
    rungs: List[int] = []
    cap = bucket_capacity(1, minimum)
    while True:
        rungs.append(cap)
        if cap >= max_rows:
            return rungs
        cap = bucket_capacity(cap + 1, minimum)
