"""Per-operator metrics: a minimal, JAX-free port of the JAX package's
``observability/metrics.py``.

Every ``PhysicalPlan.execute`` is wrapped by ``instrument_execute``, which
records output batches, output rows and the host time spent inside the
operator's generator (``elapsed_compute``, children included, as in the
JAX package). Row counts are kept as device scalars and summed only when
read, so recording never forces a device sync. The process-wide switch,
memory gauges, tracing spans, exporters and query ledger of the JAX module
are not ported yet.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List


class MetricsSet:
    """Per-operator metric store: counters (ints), timers (seconds), plus
    the pending device row-count scalars, resolved at read time."""

    __slots__ = ("_counters", "_timers", "_pending_rows")

    def __init__(self):
        self._counters: Dict[str, int] = {}
        self._timers: Dict[str, float] = {}
        self._pending_rows: List = []

    def add_counter(self, name: str, value: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + value

    def add_time(self, name: str, secs: float) -> None:
        self._timers[name] = self._timers.get(name, 0.0) + secs

    def reset(self) -> None:
        self._counters.clear()
        self._timers.clear()
        self._pending_rows.clear()

    def record_output_batch(self, batch) -> None:
        """Bump the batch counter and keep the batch's live-row count (a
        device scalar) without syncing."""
        self.add_counter("output_batches")
        self._pending_rows.append(batch.num_rows)

    def values(self) -> Dict[str, float]:
        """Resolved snapshot: counters as ints, timers as floats."""
        if self._pending_rows:
            pending, self._pending_rows = self._pending_rows, []
            self.add_counter("output_rows", sum(int(c) for c in pending))
        out: Dict[str, float] = dict(self._counters)
        out.update(self._timers)
        return out

    def summary(self) -> str:
        """Compact ``k=v`` rendering, stable order: rows, batches, timers,
        the rest."""
        vals = self.values()
        parts = []
        for key in ("output_rows", "output_batches"):
            if key in vals:
                parts.append(f"{key}={int(vals.pop(key))}")
        for key in sorted(k for k in vals if k.startswith("elapsed_")):
            parts.append(f"{key}={vals.pop(key) * 1e3:.3f}ms")
        for key in sorted(vals):
            parts.append(f"{key}={vals[key]}")
        return ", ".join(parts)


def instrument_execute(fn):
    """Wrap a PhysicalPlan.execute generator so each call records output
    rows/batches and cumulative host time on the operator's MetricsSet.
    Idempotent via the ``_obs_wrapped`` marker."""
    if getattr(fn, "_obs_wrapped", False):
        return fn

    @functools.wraps(fn)
    def execute(self, partition: int):
        m = self.metrics()
        it = fn(self, partition)
        acc = 0.0
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    acc += time.perf_counter() - t0
                    return
                acc += time.perf_counter() - t0
                m.record_output_batch(batch)
                yield batch
        finally:
            # a consumer abandoning the stream early must still flush
            m.add_time("elapsed_compute", acc)

    execute._obs_wrapped = True
    return execute
