"""Ingest phase timing: parse / H2D attribution with zero hot-path cost.

A copy of the JAX package's ``ingest/phases.py``. On a card the ``h2d``
phase times the host's side of an upload: staging into pinned memory
and queueing the asynchronous copy, not the copy itself.

The io layer brackets its work in :func:`phase` blocks. Each block:

- accumulates into PROCESS totals (``phase_totals()``), which a caller
  joins with wall time for the parse/H2D/execute attribution;
- routes to the thread-bound :class:`PhaseRecorder` (if any), which
  forwards onto the owning operator's ``MetricsSet`` as
  ``elapsed_parse``/``elapsed_h2d`` timers (``pretty_metrics`` shows
  the split per scan);
- emits an ``ingest.<name>`` span under ``BALLISTA_TRACE=1`` — spans
  from prefetch producer threads carry their own tids, which is what
  makes the overlap *observable* rather than inferred.

Scan counters (:func:`count`, :func:`scan_counters`): the scans that
parsed on the card (``scans_on_card``) and on the host
(``scans_on_host``, and ``scans_on_host.<reason>``), the bytes parsed on
the card (``device_parsed_bytes``, also on the scan's ``MetricsSet``) and
the utf8 values that shared a 64-bit hash with another
(``hash_collisions``).

Binding is per-``next()`` (:func:`bound_iter`) or per-producer-loop
(PrefetchHandle), never per-generator-scope, so interleaved generators
on one thread can't cross-attribute. Nested same-name phases don't
double count.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

from ..observability.tracing import trace_span

_tls = threading.local()
_totals_lock = threading.Lock()
_totals: Dict[str, float] = {}
_counts: Dict[str, int] = {}


class PhaseRecorder:
    """Forwards phase timers / pipeline counters onto an operator's
    ``MetricsSet`` (or swallows them when metrics are disabled). The
    same benign-race policy as MetricsSet applies: producer and
    consumer threads may interleave updates to display values."""

    __slots__ = ("_metrics",)

    def __init__(self, metrics=None):
        self._metrics = metrics

    def record(self, name: str, secs: float) -> None:
        if self._metrics is not None:
            self._metrics.add_time("elapsed_" + name, secs)  # metric-names: elapsed_parse elapsed_h2d

    def add_wait(self, secs: float) -> None:
        """Time the consumer spent blocked on the prefetch queue — the
        pipeline's residual stall (≪ elapsed_parse when overlapped)."""
        if self._metrics is not None:
            self._metrics.add_time("elapsed_prefetch_wait", secs)

    def count_prefetched(self, n: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.add_counter("prefetched_batches", n)

    def count_device_parsed(self, nbytes: int) -> None:
        """Bytes of text this scan parsed on the card."""
        if self._metrics is not None:
            # the port's own counter: observability/registry.py stays a
            # verbatim copy of the JAX package's, which parses on the host
            # ballista: ignore[metric-names]
            self._metrics.add_counter("device_parsed_bytes", nbytes)


@contextmanager
def bind(recorder: Optional[PhaseRecorder]):
    """Route :func:`phase` timings on THIS thread to ``recorder``."""
    prev = getattr(_tls, "recorder", None)
    _tls.recorder = recorder
    try:
        yield
    finally:
        _tls.recorder = prev


@contextmanager
def phase(name: str, **attrs):
    """Time a parse/H2D block (see module docstring). Reentrant same-name
    blocks are transparent — only the outermost records."""
    active = getattr(_tls, "active", None)
    if active is None:
        active = _tls.active = set()
    if name in active:
        yield
        return
    active.add(name)
    span = trace_span("ingest." + name, **attrs)
    span.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        active.discard(name)
        span.__exit__(None, None, None)
        with _totals_lock:
            _totals[name] = _totals.get(name, 0.0) + dt
        rec = getattr(_tls, "recorder", None)
        if rec is not None:
            rec.record(name, dt)


def bound_iter(gen: Iterator, recorder: Optional[PhaseRecorder]):
    """Drive ``gen`` with ``recorder`` bound only while it advances —
    the serial (pipeline-off) scan path's attribution wrapper."""
    while True:
        with bind(recorder):
            try:
                item = next(gen)
            except StopIteration:
                return
        yield item


def phase_totals() -> Dict[str, float]:
    """Process-wide cumulative seconds per phase (thread time: under
    overlap the sum can legitimately exceed wall time)."""
    with _totals_lock:
        out = dict(_totals)
    out.setdefault("parse", 0.0)
    out.setdefault("h2d", 0.0)
    return out


def reset_phase_totals() -> None:
    with _totals_lock:
        _totals.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process scan counter ``name``; ``device_parsed_bytes``
    also goes to the bound scan's ``MetricsSet``."""
    with _totals_lock:
        _counts[name] = _counts.get(name, 0) + int(n)
    rec = getattr(_tls, "recorder", None)
    if rec is not None and name == "device_parsed_bytes":
        rec.count_device_parsed(int(n))


def scan_counters() -> Dict[str, int]:
    """Process-wide scan counters (see the module docstring)."""
    with _totals_lock:
        out = dict(_counts)
    for name in ("scans_on_card", "scans_on_host", "device_parsed_bytes",
                 "hash_collisions"):
        out.setdefault(name, 0)
    return out


def reset_scan_counters() -> None:
    with _totals_lock:
        _counts.clear()
