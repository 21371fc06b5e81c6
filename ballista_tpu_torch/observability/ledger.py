"""Per-query latency ledger: always-on phase attribution for every query.

Every query — standalone or cluster, traced or not — accumulates a
small fixed-schema dict of phase durations so "p99 regressed"
localizes to "queue wait" vs "compile" vs "device" without a trace
rerun. Unlike the profiler's lane decomposition (export.compute_lanes,
which needs a trace/profile session), the ledger is assembled from
cheap stamps and counters that are already maintained on the hot path:

- the client stamps its envelope phases (``host_decode``,
  ``result_transfer``) through the thread-local collect window;
- the scheduler stamps ``admission_wait`` / ``queue_wait`` /
  ``planning`` around the gate, the admission queue and the planner;
- executors ship per-task phase deltas back on ``CompletedTask`` as
  ``ledger.<phase>`` keys riding the existing ``TaskProfile.phases``
  dict (no proto change), summed at job-terminal time;
- the standalone recorder extracts the same phases from the
  flight-recorder window it already mines for lanes.

The assembled ledger feeds the process-global :class:`LedgerLog`
(``system.latency``) and the SLO histograms + exemplar store in
``observability/metrics.py`` (``ballista_latency_*`` families,
``system.exemplars``). ``BALLISTA_LEDGER=0`` disables recording (the
overhead gate's control arm); the stamps themselves are cheap enough
to stay unconditional.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional

# The fixed phase schema. Every ledger carries every phase (0.0 when a
# path doesn't exercise it) so downstream consumers never key-check.
LEDGER_PHASES = (
    "admission_wait",    # scheduler: time inside the admission gate
    "queue_wait",        # scheduler: time held in the admission queue
    "planning",          # logical->physical planning (+fusion)
    "compile",           # XLA trace/lower/compile attributed to the query
    "device_execute",    # task execution time not otherwise attributed
    "shuffle_fetch",     # shuffle partition fetches (data plane reads)
    "shuffle_write",     # partition/shuffle IPC writes
    "cache_lookup",      # table/result cache probes (hit or miss)
    "host_decode",       # result bytes -> host arrays -> DataFrame
    "result_transfer",   # client-side result partition fetches
)

# Span name -> ledger phase, for phases extracted from flight-recorder
# windows (per-task on executors, per-collect standalone). The
# lane-coverage analysis pass reads this map (plus export.LANE_SPANS)
# to catch span names no attribution surface knows about.
LEDGER_SPANS = {
    "shuffle.fetch": "shuffle_fetch",
    "dataplane.write": "shuffle_write",
    "cache.lookup": "cache_lookup",
}

_TRUTHY_OFF = ("0", "off", "false", "no")

_enabled: Optional[bool] = None
_enabled_lock = threading.Lock()


def ledger_enabled() -> bool:
    """``BALLISTA_LEDGER`` (default on): record per-query ledgers into
    the process log + SLO histograms. Cached; reconfigure() re-reads
    (same pattern as metrics_enabled)."""
    global _enabled
    with _enabled_lock:
        if _enabled is None:
            _enabled = os.environ.get(
                "BALLISTA_LEDGER", "on").lower() not in _TRUTHY_OFF
        return _enabled


def reconfigure() -> None:
    global _enabled
    with _enabled_lock:
        _enabled = None


# -- thread-local collect window ----------------------------------------------
# The client paths stamp phases measured around code they own (planning,
# host decode, result transfer) into a per-thread dict bound for the
# duration of one collect. stamp() is a no-op outside a window, so
# library code can stamp unconditionally.

_tls = threading.local()


def begin_collect() -> None:
    _tls.stamps = {}


def take_collect() -> Dict[str, float]:
    """Detach and return this thread's stamp window ({} when none)."""
    stamps = getattr(_tls, "stamps", None)
    _tls.stamps = None
    return stamps or {}


def stamp(phase: str, seconds: float) -> None:
    stamps = getattr(_tls, "stamps", None)
    if stamps is not None:
        stamps[phase] = stamps.get(phase, 0.0) + float(seconds)


@contextmanager
def ledger_phase(phase: str):
    """Accumulate the block's wall time into the active collect window
    (no-op when no window is bound — a perf_counter pair either way)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stamp(phase, time.perf_counter() - t0)


# -- assembly -----------------------------------------------------------------

def span_phase_sums(records: Iterable[dict]) -> Dict[str, float]:
    """Sum LEDGER_SPANS durations out of a flight-recorder window."""
    out: Dict[str, float] = {}
    for r in records:
        phase = LEDGER_SPANS.get(r.get("name"))
        if phase is not None:
            out[phase] = out.get(phase, 0.0) + float(r.get("dur", 0.0))
    return out


def task_phase_key(phase: str) -> str:
    """The ``TaskProfile.phases`` key a per-task ledger delta rides
    (``ledger.<phase>`` — plain phase totals keep their own names)."""
    return "ledger." + phase


def task_ledger_phases(records: Iterable[dict], wall_seconds: float,
                       compile_seconds: float = 0.0) -> Dict[str, float]:
    """Per-task ledger deltas an executor ships with CompletedTask:
    span-derived phases plus compile, with ``device_execute`` as the
    task's unattributed remainder (device + host compute)."""
    phases = span_phase_sums(records)
    if compile_seconds > 0:
        phases["compile"] = phases.get("compile", 0.0) + compile_seconds
    measured = sum(phases.values())
    phases["device_execute"] = max(0.0, float(wall_seconds) - measured)
    return {task_phase_key(k): round(v, 6) for k, v in phases.items()}


def merge_task_phases(payloads: Iterable[dict]) -> Dict[str, float]:
    """Sum the ``ledger.*`` deltas out of per-task profile payloads
    (one entry per completed task, any number of executors — summing is
    the merge: phases are disjoint slices of task wall time)."""
    out: Dict[str, float] = {}
    for p in payloads or ():
        for key, v in (p.get("phases") or {}).items():
            if key.startswith("ledger."):
                phase = key[len("ledger."):]
                try:
                    out[phase] = out.get(phase, 0.0) + float(v)
                except (TypeError, ValueError):
                    continue
    return out


def build_ledger(job_id: str, wall_seconds: float, origin: str,
                 status: str,
                 phases: Optional[Dict[str, float]] = None) -> dict:
    """Normalize to the fixed schema: every LEDGER_PHASES key present,
    unknown keys dropped, ``unattributed_seconds`` as the remainder so
    phases + unattributed always reconstruct the wall time."""
    full = {name: 0.0 for name in LEDGER_PHASES}
    for k, v in (phases or {}).items():
        if k in full:
            try:
                full[k] = round(max(float(v), 0.0), 6)
            except (TypeError, ValueError):
                continue
    wall = max(float(wall_seconds or 0.0), 0.0)
    return {
        "job_id": job_id,
        "origin": origin,
        "status": status,
        "wall_seconds": round(wall, 6),
        "phases": full,
        "unattributed_seconds": round(
            max(0.0, wall - sum(full.values())), 6),
    }


def assemble_job_ledger(job_id: str, wall_seconds: float, status: str,
                        stamps: Optional[Dict[str, float]] = None,
                        task_payloads: Optional[List[dict]] = None,
                        origin: str = "cluster") -> dict:
    """The scheduler's job-terminal assembly: its own stamps
    (admission/queue/planning) + the summed per-task deltas."""
    phases = dict(stamps or {})
    for phase, v in merge_task_phases(task_payloads).items():
        phases[phase] = phases.get(phase, 0.0) + v
    return build_ledger(job_id, wall_seconds, origin, status, phases)


# -- the process log (system.latency) -----------------------------------------

def _log_capacity() -> int:
    try:
        return max(int(os.environ.get("BALLISTA_LEDGER_LOG", "256")), 1)
    except ValueError:
        return 256


class LedgerLog:
    """Bounded ring of recent query ledgers, per process."""

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(
            maxlen=capacity if capacity is not None else _log_capacity())

    def record(self, ledger: dict) -> None:
        entry = dict(ledger)
        entry.setdefault("recorded_at", time.time())
        with self._lock:
            self._ring.append(entry)

    def entries(self, since: Optional[float] = None) -> List[dict]:
        with self._lock:
            snap = list(self._ring)
        if since is not None:
            snap = [e for e in snap
                    if float(e.get("recorded_at", 0.0)) >= since]
        return snap

    def last(self) -> Optional[dict]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def rows(self) -> List[dict]:
        """``system.latency``: one row per recent query per phase
        (plus the ``unattributed`` remainder row), oldest query first."""
        out: List[dict] = []
        for e in self.entries():
            wall = float(e.get("wall_seconds", 0.0))
            phases = dict(e.get("phases") or {})
            phases["unattributed"] = float(
                e.get("unattributed_seconds", 0.0))
            for phase in (*LEDGER_PHASES, "unattributed"):
                secs = float(phases.get(phase, 0.0))
                out.append({
                    "job_id": e.get("job_id"),
                    "origin": e.get("origin"),
                    "status": e.get("status"),
                    "phase": phase,
                    "seconds": round(secs, 6),
                    "fraction": round(secs / wall, 6) if wall > 0 else 0.0,
                    "wall_seconds": round(wall, 6),
                })
        return out


_log_lock = threading.Lock()
_process_log: Optional[LedgerLog] = None


def process_ledger_log() -> LedgerLog:
    global _process_log
    with _log_lock:
        if _process_log is None:
            _process_log = LedgerLog()
        return _process_log


def reset_process_log() -> None:
    """Test hook: drop the process log (capacity re-read from env)."""
    global _process_log
    with _log_lock:
        _process_log = None


def latency_rows() -> List[dict]:
    return process_ledger_log().rows()


def record_ledger(ledger: dict) -> None:
    """Record one assembled ledger: process log + SLO histograms with
    exemplars. The single gate the overhead knob controls."""
    if not ledger_enabled():
        return
    process_ledger_log().record(ledger)
    try:
        from .metrics import observe_query_ledger

        observe_query_ledger(ledger)
    except Exception:  # noqa: BLE001 - observability only
        pass
