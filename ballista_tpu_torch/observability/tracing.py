"""Span-style tracing: ``BALLISTA_TRACE=1`` -> JSON-lines trace file per
process.

Coverage (each site tags its span name with the subsystem): scheduler
events (``scheduler.plan_job``, ``scheduler.task_dispatch``), executor
task execution (``executor.task``), shuffle fetch (``shuffle.fetch``),
dataplane I/O (``dataplane.write``), ingest phases (``ingest.*``),
compile activity (``compile.capture``: a governed program's first
call), host dictionary work (``host.dictionary``) and blocking device
syncs (``device.block``).
A span line is::

    {"name": ..., "ts": <epoch start>, "dur": <seconds>, "pid": ...,
     "tid": ..., "sid": <span id>, "psid": <parent span id>, <attrs>}

Instant events carry no ``dur``/``sid`` (only the enclosing ``psid``).
``sid``/``psid`` are process-local monotonic ids kept on a per-thread
span stack, so the profiler (``observability/profiler.py``) can rebuild
the call tree instead of guessing from timestamps. Cross-process /
cross-thread flow correlation is STRUCTURAL: :func:`flow` binds
``job``/``stage``/``task`` attributes on the current thread, every
record emitted under it inherits them (explicit span attrs win), and
:func:`current_flow` lets pool handoffs (ingest producers) re-bind the
creator's flow on the worker thread.

Files land in ``BALLISTA_TRACE_DIR`` (default: the system temp dir) as
``ballista-trace-<pid>.jsonl`` so a multi-process cluster writes one
file per scheduler/executor process with no cross-process locking;
``BALLISTA_TRACE_FILE`` pins an exact path instead. Hygiene knobs:
``BALLISTA_TRACE_TRUNCATE=1`` opens the file fresh instead of appending
(long benchmark loops otherwise grow one file forever), and
``BALLISTA_TRACE_MAX_MB=<n>`` caps the file — once the cap is reached a
single ``trace.capped`` marker is written and further records are
dropped (never raising into the traced code). Writes are line-buffered
under a process-local lock — tracing is for diagnosis runs, not the
steady-state hot path, and the disabled path is a single cached boolean
check.

**Flight recorder**: independent of the trace FILE, every span/event
record is also appended to a bounded in-memory ring (a deque of the
most recent ``BALLISTA_FLIGHT_RECORDER_SPANS`` records, default 4096;
``BALLISTA_FLIGHT_RECORDER=0`` disables). The ring is always on by
default — it is what lets a query that crosses
``BALLISTA_SLOW_QUERY_SECS`` dump a RETROACTIVE profile artifact, and
what executors mine for the per-task profile windows shipped back with
``CompletedTask`` (observability/distributed.py). Ring appends build
the same record dict a file write would but skip the JSON encode and
the lock, so the measured warm-query overhead stays under the 5% gate.

**Process identity**: :func:`set_process_identity` stamps a role
(``scheduler`` / ``executor``) and short executor id onto every record
emitted by this process (``role`` / ``exec`` keys), so a merged
multi-process artifact can place each record on the right process
track. First writer wins — an in-process LocalCluster (scheduler and
executors sharing one tracer) relies on per-task window extraction to
re-tag executor records instead.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

from . import hostclock

_lock = threading.Lock()
_state: dict = {"configured": False, "fh": None, "ring": None}
_span_ids = itertools.count(1)
_tls = threading.local()
# (role, short executor id) — set once per process; survives
# reconfigure() (identity is who the process IS, not how it traces)
_identity: dict = {}


def _configure_locked() -> None:
    # "configured" must be published LAST: _fh() double-checks it
    # WITHOUT the lock, so flipping it before the file handle exists
    # opens a window where a concurrent thread (ingest pipeline
    # producers trace from pool workers) reads fh=None and silently
    # drops its event
    prev_ring = _state.pop("prev_ring", None)
    if os.environ.get("BALLISTA_FLIGHT_RECORDER", "").lower() in (
            "0", "off", "false"):
        _state["ring"] = None
    else:
        try:
            cap = int(os.environ.get("BALLISTA_FLIGHT_RECORDER_SPANS",
                                     "4096"))
        except ValueError:
            cap = 4096
        ring = deque(maxlen=max(cap, 16)) if cap > 0 else None
        if ring is not None and prev_ring:
            # the flight recorder survives trace-FILE reconfiguration
            # (the profiler reconfigures at window start/stop; losing
            # the ring there would blind the retroactive dump)
            ring.extend(prev_ring)
        _state["ring"] = ring
    if os.environ.get("BALLISTA_TRACE", "").lower() not in ("1", "on",
                                                            "true"):
        _state["fh"] = None
        _state["configured"] = True
        return
    path = os.environ.get("BALLISTA_TRACE_FILE")
    if not path:
        trace_dir = os.environ.get("BALLISTA_TRACE_DIR",
                                   tempfile.gettempdir())
        path = os.path.join(trace_dir, f"ballista-trace-{os.getpid()}.jsonl")
    truncate = os.environ.get("BALLISTA_TRACE_TRUNCATE", "").lower() in (
        "1", "on", "true")
    try:
        _state["max_bytes"] = int(
            float(os.environ.get("BALLISTA_TRACE_MAX_MB", "0")) * 1e6)
    except ValueError:
        _state["max_bytes"] = 0
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        mode = "w" if truncate else "a"
        # the size cap covers the WHOLE file, appended history included
        _state["bytes"] = (os.path.getsize(path)
                           if not truncate and os.path.exists(path) else 0)
        _state["capped"] = False
        _state["fh"] = open(path, mode, buffering=1)
        _state["path"] = path
    except OSError:
        _state["fh"] = None
    _state["configured"] = True


def _fh():
    if not _state["configured"]:
        with _lock:
            if not _state["configured"]:
                _configure_locked()
    return _state["fh"]


def _ring():
    if not _state["configured"]:
        with _lock:
            if not _state["configured"]:
                _configure_locked()
    return _state["ring"]


def _recording() -> bool:
    """True when spans must be materialized at all: a trace file is
    open OR the flight-recorder ring is on."""
    if not _state["configured"]:
        with _lock:
            if not _state["configured"]:
                _configure_locked()
    return _state["fh"] is not None or _state["ring"] is not None


def trace_enabled() -> bool:
    return _fh() is not None


def flight_recorder_enabled() -> bool:
    return _ring() is not None


def trace_path() -> Optional[str]:
    return _state.get("path") if _fh() is not None else None


def reconfigure() -> None:
    """Re-read the BALLISTA_TRACE* env (tests flip it mid-process; a
    forked executor inherits env and configures itself on first use)."""
    with _lock:
        fh = _state.get("fh")
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass
        ring = _state.get("ring")
        _state.clear()
        _state.update({"configured": False, "fh": None, "ring": None,
                       "prev_ring": ring})


def set_process_identity(role: str, executor_id: Optional[str] = None
                         ) -> None:
    """Stamp this process's role (and short executor id) onto every
    record emitted from now on. First writer wins: in an in-process
    LocalCluster the scheduler and executors share one tracer, and
    executor records are re-tagged at per-task window extraction
    instead (observability/distributed.py)."""
    with _lock:
        # under the lock, "first writer wins" is exact: two concurrent
        # claimants (executor start racing a scheduler start in one
        # LocalCluster process) can no longer interleave role/exec
        if _identity:
            return
        _identity["role"] = role
        if executor_id:
            _identity["exec"] = executor_id[:8]


def process_identity() -> dict:
    return dict(_identity)


def ring_records(since: Optional[float] = None,
                 job: Optional[str] = None,
                 task: Optional[str] = None) -> list:
    """Snapshot of flight-recorder records, optionally filtered to those
    OVERLAPPING ``since`` (a span started before but still running past
    it counts) and/or carrying the given ``job``/``task`` flow attrs.
    Returns the ring's record dicts — callers must copy before
    mutating."""
    ring = _ring()
    if ring is None:
        return []
    snap = list(ring)
    if since is not None:
        # records append at emit time — span END order (spans emit at
        # __exit__ with end == ts + dur == now; events have dur 0) — so
        # the ring is end-time ordered: walk from the RIGHT and stop at
        # the first record ending before the window. Extraction cost is
        # bounded by the WINDOW size, not the ring size (per-task and
        # slow-query windows are tiny against a 4096-record ring).
        cut = since - 1e-6
        lo = len(snap)
        while lo > 0:
            r = snap[lo - 1]
            if float(r.get("ts", 0.0)) + float(r.get("dur", 0.0)) < cut:
                break
            lo -= 1
        snap = snap[lo:]
    if job is None and task is None:
        return snap
    out = []
    for r in snap:
        if job is not None and r.get("job") != job:
            continue
        if task is not None and r.get("task") != task:
            continue
        out.append(r)
    return out


# -- flow correlation ---------------------------------------------------------


def current_flow() -> dict:
    """The flow attributes bound on this thread (``{}`` when none).
    Pool handoffs capture this at submit time and re-bind it on the
    worker via :func:`flow` so producer spans stay correlated with the
    query/task that spawned them."""
    return dict(getattr(_tls, "flow", None) or {})


@contextmanager
def flow(**attrs):
    """Bind flow-correlation attributes (``job=...``, ``stage=...``,
    ``task=...``) on the current thread: every span/event emitted inside
    inherits them. Nested flows layer (inner keys win)."""
    prev = getattr(_tls, "flow", None)
    merged = dict(prev or {})
    merged.update({k: v for k, v in attrs.items() if v is not None})
    _tls.flow = merged
    try:
        yield
    finally:
        _tls.flow = prev


def _span_stack() -> list:
    st = getattr(_tls, "spans", None)
    if st is None:
        st = _tls.spans = []
    return st


def _emit(record: dict) -> None:
    ring = _ring()
    if ring is not None:
        # deque.append is atomic under the GIL; no lock, no JSON encode
        ring.append(record)
    fh = _fh()
    if fh is None:
        return
    line = json.dumps(record, default=str)
    with _lock:
        if _state.get("capped"):
            return
        cap = _state.get("max_bytes") or 0
        if cap and _state.get("bytes", 0) + len(line) + 1 > cap:
            _state["capped"] = True
            marker = json.dumps({"name": "trace.capped",
                                 "ts": time.time(), "pid": os.getpid(),
                                 "max_mb": cap / 1e6})
            try:
                fh.write(marker + "\n")
            except (OSError, ValueError):
                pass
            return
        try:
            fh.write(line + "\n")
            _state["bytes"] = _state.get("bytes", 0) + len(line) + 1
        except (OSError, ValueError):  # closed/full: drop, never raise
            pass


def _base_record(name: str, attrs: dict) -> dict:
    rec = {"name": name, "ts": time.time(),
           "pid": os.getpid(), "tid": threading.get_ident()}
    if _identity:
        rec.update(_identity)
    fl = getattr(_tls, "flow", None)
    if fl:
        rec.update(fl)
    rec.update(attrs)
    return rec


def trace_event(name: str, **attrs) -> None:
    """Instant event (no duration). Carries the enclosing span's id as
    ``psid`` so it nests in the reconstructed tree."""
    if not _recording():
        return
    rec = _base_record(name, attrs)
    st = _span_stack()
    if st:
        rec["psid"] = st[-1]
    _emit(rec)


def record_span(name: str, start: float, seconds: float, **attrs) -> None:
    """One span line whose duration the caller measured: an operator's
    own time summed over the batches of one call, which a ``with``
    block around a generator cannot give (it would also hold its input's
    and its consumer's time). ``start`` is the epoch time it began."""
    if not _recording():
        return
    rec = _base_record(name, attrs)
    rec["ts"] = start
    rec["dur"] = seconds
    rec["sid"] = next(_span_ids)
    st = _span_stack()
    if st:
        rec["psid"] = st[-1]
    _emit(rec)


class trace_span:
    """``with trace_span("executor.task", task=key): ...`` — records one
    line with the span's start time and duration (exceptions are noted
    as ``error=<ExcType>`` and re-raised). Each span gets a process-
    local ``sid`` and its enclosing span's ``psid``. A ``device.block``
    span also charges its time to the thread's ``device_wait`` host
    clock (``hostclock.py``), recorded or not."""

    __slots__ = ("name", "attrs", "_t0", "_sid", "_psid")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        if self.name == "device.block":
            hostclock.enter(hostclock.DEVICE_WAIT)
        if not _recording():
            self._t0 = None
            return self
        self._t0 = time.time()
        st = _span_stack()
        self._psid = st[-1] if st else None
        self._sid = next(_span_ids)
        st.append(self._sid)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.name == "device.block":
            hostclock.leave()
        if self._t0 is not None:
            st = _span_stack()
            if st and st[-1] == self._sid:
                st.pop()
            rec = _base_record(self.name, self.attrs)
            rec["ts"] = self._t0
            rec["dur"] = time.time() - self._t0
            rec["sid"] = self._sid
            if self._psid is not None:
                rec["psid"] = self._psid
            if exc_type is not None:
                rec["error"] = exc_type.__name__
            _emit(rec)
        return False
