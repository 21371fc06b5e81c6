"""Live query progress & per-session resource metering plane.

Everything the observability stack built before this module is
*post-hoc*: the profiler, the ``system.*`` tables and the lane
histograms describe queries that already finished. This module answers
the live questions — "what is job X doing right now, how far along is
it, and how much has this session consumed?" — the data plane the
multi-tenant serving work (ROADMAP item 5: admission control,
per-session quotas) reads its signals from.

Three cooperating pieces, ONE snapshot shape on both execution paths:

- **Executor-side sampling.** Each running task's operator
  ``MetricsSet`` is sampled on a bounded cadence
  (``BALLISTA_PROGRESS_INTERVAL_SECS``) without forcing a device sync
  (:meth:`MetricsSet.snapshot_rows` resolves only already-ready
  scalars), and compact ``TaskProgress`` records piggyback on the
  existing ``PollWork`` heartbeat. Reports are best-effort by
  contract: a dropped, delayed or failed report must never affect
  scheduling or results (the ``scheduler.progress_report`` fault point
  pins that in the chaos sweep).

- **The scheduler's live job model.** :class:`JobProgressTracker`
  folds progress samples and task-state transitions into per-stage
  completion fractions (observed rows vs the task's own
  ``estimated_rows()`` leaf estimate — exact for shuffle readers,
  file-size heuristics for scans), a rate-based ETA, and
  running/queued/completed task counts. Served through the extended
  ``GetJobStatus`` RPC, ``/debug/jobs[/<job_id>]``, Prometheus gauges
  (``ballista_job_progress_fraction``, ``ballista_tasks_running``) and
  the live ``system.tasks`` / ``system.stages`` tables. Job fractions
  are clamped monotone non-decreasing and reach exactly 1.0 at the
  completed terminal transition.

- **Per-session metering.** :class:`SessionMeter` accumulates, per
  client session (``session.id`` travels with the query settings),
  queries run, wall/task seconds, device-blocked seconds, shuffle
  bytes and peak host/device bytes — fed from the same
  completed-task stream at the job's terminal transition (standalone
  collects feed it from :class:`StandaloneQueryRecorder`). Durable
  next to the query-history log (``sessions.json`` under
  ``BALLISTA_QUERY_LOG_DIR``), served as ``system.sessions``.

Standalone parity: every standalone collect registers a
:class:`LocalQueryHandle`; a sampler thread over the executing plan's
``MetricsSet`` drives ``df.collect(on_progress=cb)`` and the same
handle feeds ``system.tasks`` / ``system.stages`` / in-flight
``system.queries`` rows, so both paths report through one shape.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("ballista.progress")

# the ONE snapshot shape (pinned by tests/test_progress.py)
JOB_PROGRESS_KEYS = frozenset({
    "job_id", "status", "fraction", "eta_seconds", "wall_seconds",
    "tasks_total", "tasks_running", "tasks_queued", "tasks_completed",
    "stages",
})
STAGE_PROGRESS_KEYS = frozenset({
    "stage_id", "tasks_total", "tasks_running", "tasks_completed",
    "fraction", "eta_seconds", "rows_so_far", "bytes_so_far",
})

# a running task never reports more than this fraction complete — only
# its completion report can close the gap (keeps fractions honest under
# row-estimate error and guarantees 1.0 is reached exactly once)
RUNNING_TASK_FRACTION_CAP = 0.95


def progress_interval_secs() -> Optional[float]:
    """``BALLISTA_PROGRESS_INTERVAL_SECS``: cadence of executor
    progress piggybacks and ambient standalone sampling. Default 1.0;
    ``0``/``off`` disables the plane (collect(on_progress=) still
    samples, at its own default cadence)."""
    v = os.environ.get("BALLISTA_PROGRESS_INTERVAL_SECS", "1.0")
    if v.lower() in ("off", "false", "no", ""):
        return None
    try:
        f = float(v)
    except ValueError:
        return 1.0
    if f <= 0:  # "0", "0.0", negatives: all mean OFF
        return None
    return max(f, 0.05)


def speculation_lag_factor() -> float:
    """``BALLISTA_SPECULATION_LAG_FACTOR`` (default 3.0): duplicate a
    running task when its observed row rate times this factor still
    trails its stage's median sampled rate. Values <= 1 disable the
    rate trigger (age fallback only)."""
    try:
        return float(os.environ.get(
            "BALLISTA_SPECULATION_LAG_FACTOR", "3.0") or 3.0)
    except ValueError:
        return 3.0


def executor_stale_secs() -> float:
    """``BALLISTA_EXECUTOR_STALE_SECS``: heartbeat age past which
    ``system.executors`` marks a row ``stale=true``."""
    try:
        return max(float(os.environ.get(
            "BALLISTA_EXECUTOR_STALE_SECS", "15") or 15), 0.1)
    except ValueError:
        return 15.0


# ---------------------------------------------------------------------------
# Plan sampling (shared by the executor piggyback and the standalone
# sampler): rows/bytes so far + current operator, no device sync forced
# ---------------------------------------------------------------------------


def _plan_nodes_with_depth(plan) -> List[Tuple[int, object]]:
    out: List[Tuple[int, object]] = []

    def walk(node, depth):
        out.append((depth, node))
        for c in node.children():
            walk(c, depth + 1)

    walk(plan, 0)
    return out


def plan_input_estimate(plan, per_partition: bool = False) -> int:
    """Total estimated input rows of the plan's LEAF operators (scans,
    shuffle readers — exact for the latter). 0 = unknown (any leaf
    declining makes the total untrustworthy for a fraction).

    ``per_partition=True`` divides each leaf's estimate by its
    partition count: a cluster task executes ONE partition of the
    shared stage plan, so its denominator is the stage input's
    per-partition share, not the whole stage (assumes an even split —
    advisory, and the running-task fraction cap absorbs skew)."""
    total = 0.0
    for _, node in _plan_nodes_with_depth(plan):
        if node.children():
            continue
        try:
            est = node.estimated_rows()
        except Exception:  # noqa: BLE001 - advisory
            est = None
        if est is None:
            return 0
        if per_partition:
            try:
                n = node.output_partitioning().num_partitions or 1
            except Exception:  # noqa: BLE001 - advisory
                n = 1
            est = est / max(int(n), 1)
        total += est
    return int(total)


def sample_plan(plan, input_rows_total: Optional[int] = None) -> dict:
    """One progress sample off an executing plan's MetricsSets:
    ``rows_so_far`` (leaf output rows — input consumed), ``bytes_so_far``
    (shuffle bytes read), ``input_rows_total`` and the shallowest
    operator observed producing output (the pipeline's current head).
    Never blocks on in-flight device compute."""
    rows = 0
    bytes_ = 0
    operator = ""
    op_depth = None
    for depth, node in _plan_nodes_with_depth(plan):
        m = node.metrics()
        if not node.children():
            rows += m.snapshot_rows()
        br = m._counters.get("bytes_read", 0)
        if br:
            bytes_ += int(br)
        active = m._counters.get("output_batches", 0) or m._pending_rows
        if active and (op_depth is None or depth < op_depth):
            op_depth = depth
            operator = node.display()
    if input_rows_total is None:
        input_rows_total = plan_input_estimate(plan)
    return {
        "rows_so_far": int(rows),
        "bytes_so_far": int(bytes_),
        "input_rows_total": int(input_rows_total or 0),
        "operator": operator,
    }


def _fraction_of(sample: Optional[dict]) -> float:
    """Partial completion of one RUNNING task from its latest sample."""
    if not sample:
        return 0.0
    est = int(sample.get("input_rows_total") or 0)
    if est <= 0:
        return 0.0
    f = sample.get("rows_so_far", 0) / est
    return max(0.0, min(f, RUNNING_TASK_FRACTION_CAP))


def _copy_snap(snap: dict) -> dict:
    """Copy a snapshot one level deeper than dict(): the stage dicts
    must not be shared between the tracker's cache/final stores and
    callers — finish() mutates stage rows in place."""
    out = dict(snap)
    out["stages"] = [dict(s) for s in snap.get("stages") or []]
    return out


def force_completed(snap: dict) -> dict:
    """Make a snapshot report exact completion — job AND stage rows.
    The ONE terminal-forcing rule, shared by the tracker's frozen
    final snapshot and the client's terminal callback (which can
    observe the completed KV before the tracker's finish() runs)."""
    snap["fraction"] = 1.0
    snap["eta_seconds"] = 0.0
    snap["tasks_running"] = snap["tasks_queued"] = 0
    snap["tasks_completed"] = snap["tasks_total"]
    for s in snap.get("stages") or []:
        s["fraction"] = 1.0
        s["eta_seconds"] = 0.0
        s["tasks_running"] = 0
        s["tasks_completed"] = s["tasks_total"]
    return snap


def _eta(fraction: float, wall: float) -> Optional[float]:
    """Rate-based remaining-time estimate: assumes progress continues
    at the observed average rate. None below 2% (the rate is noise)."""
    if fraction < 0.02 or wall <= 0:
        return None
    if fraction >= 1.0:
        return 0.0
    return round(wall * (1.0 - fraction) / fraction, 3)


# ---------------------------------------------------------------------------
# Scheduler-side live job model
# ---------------------------------------------------------------------------


class JobProgressTracker:
    """Folds executor ``TaskProgress`` samples + scheduler task state
    into live per-stage/job progress snapshots.

    Owned by the SchedulerService; reads task statuses from the
    scheduler state at snapshot time (no second event stream to drift).
    Bounded: at most ``cap`` jobs tracked (oldest evicted); terminal
    jobs keep ONE final snapshot so ``/debug/jobs/<id>`` can answer for
    recently finished work."""

    def __init__(self, state=None, cap: int = 128):
        self._state = state
        self._cap = cap
        self._lock = threading.Lock()
        # job_id -> {"t0", "samples": {(sid, pid): sample},
        #            "last_fraction", "final": dict | None}
        self._jobs: "OrderedDict[str, dict]" = OrderedDict()

    def register_job(self, job_id: str) -> None:
        with self._lock:
            if job_id not in self._jobs:
                self._jobs[job_id] = {"t0": time.time(), "samples": {},
                                      "last_fraction": 0.0, "final": None}
                while len(self._jobs) > self._cap:
                    self._jobs.popitem(last=False)

    def record_report(self, job_id: str, stage_id: int, partition_id: int,
                      sample: dict) -> None:
        """One TaskProgress report off a PollWork. Unknown jobs are
        registered on the fly (scheduler restart); everything is
        advisory, so no validation beyond bounds."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                # evicted / post-restart job: seed t0 from the durable
                # start stamp, else wall_seconds (and the rate-based
                # ETA built on it) would restart from this report
                t0 = None
                if self._state is not None:
                    try:
                        t0 = self._state.job_started_at(job_id)
                    except Exception:  # noqa: BLE001 - advisory
                        t0 = None
                self._jobs[job_id] = job = {
                    "t0": t0 or time.time(), "samples": {},
                    "last_fraction": 0.0, "final": None}
                while len(self._jobs) > self._cap:
                    self._jobs.popitem(last=False)
            key = (int(stage_id), int(partition_id))
            prev = job["samples"].get(key)
            if prev is not None and int(sample.get("stage_version", 0)) \
                    < int(prev.get("stage_version", 0)):
                return  # superseded attempt: an adaptive re-plan bumped
                # the stage version — the dead task's counts must not
                # pollute the new attempt's fraction
            # runaway guard: updates to known tasks always land, a
            # pathological key space stops growing at the bound
            if prev is not None or len(job["samples"]) < 4096:
                job["samples"][key] = sample
                # fresh data: the next snapshot must see it (the cache
                # only dedupes polls BETWEEN heartbeats)
                job.pop("cache", None)

    # -- rate-based speculation (ROADMAP 5a: the scheduler CONSUMES the
    # progress model) ---------------------------------------------------------

    # a sample younger than this carries too little signal for a rate
    MIN_RATE_ELAPSED_SECS = 1.0

    def _stage_rates(self, job_id: str, stage_id: int
                     ) -> List[Tuple[int, float]]:
        """(partition_id, rows/sec) for every usably-sampled task of
        the stage — one locked pass over the sample map."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return []
            samples = [(k[1], s) for k, s in job["samples"].items()
                       if k[0] == int(stage_id)]
        out: List[Tuple[int, float]] = []
        for pid, s in samples:
            elapsed = float(s.get("elapsed_seconds") or 0.0)
            if elapsed < self.MIN_RATE_ELAPSED_SECS:
                continue
            out.append((pid, float(s.get("rows_so_far", 0)) / elapsed))
        return out

    @staticmethod
    def _lag_verdict(rates: List[Tuple[int, float]], partition_id: int,
                     factor: float) -> Optional[bool]:
        mine: Optional[float] = None
        sibling_rates: List[float] = []
        for pid, rate in rates:
            if pid == int(partition_id):
                mine = rate
            else:
                sibling_rates.append(rate)
        if mine is None or not sibling_rates:
            return None
        sibling_rates.sort()
        median = sibling_rates[len(sibling_rates) // 2]
        if median <= 0:
            return None
        return mine * factor < median

    def is_lagging(self, job_id: str, stage_id: int, partition_id: int,
                   factor: Optional[float] = None) -> Optional[bool]:
        """Rate verdict for one running task, from the stage's latest
        progress samples: True = its observed row rate times
        ``BALLISTA_SPECULATION_LAG_FACTOR`` still trails the median
        rate of its stage SIBLINGS (duplicate it); False = measurably
        keeping up (do not); None = no verdict — the task or its stage
        has no usable samples, the caller falls back to the age
        trigger. A sampled task stuck at 0 rows reads rate 0 and lags
        any progressing stage."""
        if factor is None:
            factor = speculation_lag_factor()
        if factor <= 1.0:
            return None
        return self._lag_verdict(self._stage_rates(job_id, stage_id),
                                 partition_id, factor)

    def speculation_lag_fn(self):
        """The ``lag_fn`` SchedulerState.speculative_task consumes, or
        None when the progress plane is off (pure age fallback). The
        returned closure is built fresh per speculation SCAN and caches
        one rate snapshot per (job, stage) — the scan calls it for
        every running task, and rescanning the sample map (plus the env
        read) per task would be O(tasks x samples) on the PollWork
        handler thread."""
        if progress_interval_secs() is None:
            return None
        factor = speculation_lag_factor()
        if factor <= 1.0:
            return None
        rate_cache: Dict[Tuple[str, int], List[Tuple[int, float]]] = {}

        def lag(t) -> Optional[bool]:
            key = (t.partition.job_id, t.partition.stage_id)
            rates = rate_cache.get(key)
            if rates is None:
                rates = rate_cache[key] = self._stage_rates(*key)
            return self._lag_verdict(rates, t.partition.partition_id,
                                     factor)

        return lag

    # -- snapshots -----------------------------------------------------------

    def _task_states(self, job_id: str):
        st = self._state
        if st is None:
            return []
        try:
            return st.get_task_statuses(job_id)
        except Exception:  # noqa: BLE001 - diagnosis plane
            return []

    def snapshot(self, job_id: str) -> Optional[dict]:
        """The job's live progress snapshot (the ONE shape), or None
        when the tracker never saw the job. Briefly cached (half the
        progress cadence): building a snapshot prefix-scans and
        unpickles every task status, and clients poll GetJobStatus at
        100ms — the RPC handler threads must not pay O(tasks) per poll
        for information that only changes on heartbeats."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            if job["final"] is not None:
                return _copy_snap(job["final"])
            cached = job.get("cache")
            if cached is not None and \
                    time.time() - cached[0] < self._snapshot_ttl():
                return _copy_snap(cached[1])
            samples = dict(job["samples"])
            t0 = job["t0"]
            last_fraction = job["last_fraction"]
        status = "running"
        st = self._state
        if st is not None:
            try:
                js = st.get_job_status(job_id)
                if js is not None:
                    status = js.state
            except Exception:  # noqa: BLE001
                pass
        wall = max(time.time() - t0, 0.0)
        stages: Dict[int, dict] = {}
        totals = running = queued = completed = 0
        for t in self._task_states(job_id):
            sid = t.partition.stage_id
            srow = stages.setdefault(sid, {
                "stage_id": sid, "tasks_total": 0, "tasks_running": 0,
                "tasks_completed": 0, "fraction": 0.0, "eta_seconds": None,
                "rows_so_far": 0, "bytes_so_far": 0, "_units": 0.0,
                "_t0": None,
            })
            srow["tasks_total"] += 1
            totals += 1
            if t.started_at:
                srow["_t0"] = min(srow["_t0"] or t.started_at,
                                  t.started_at)
            if t.state == "completed":
                srow["tasks_completed"] += 1
                completed += 1
                srow["_units"] += 1.0
                # keep the units the shape promises (leaf input rows
                # consumed / wire bytes): the task's last retained
                # sample — its output stats are a DIFFERENT unit, and
                # on a selective stage swapping to them at completion
                # makes the counter jump backwards
                sample = samples.get((sid, t.partition.partition_id))
                if sample:
                    srow["rows_so_far"] += int(sample.get("rows_so_far", 0))
                    srow["bytes_so_far"] += \
                        int(sample.get("bytes_so_far", 0))
                else:  # plane off / task outran the first heartbeat
                    stats = t.stats or {}
                    srow["rows_so_far"] += int(stats.get("num_rows", 0))
                    srow["bytes_so_far"] += int(stats.get("num_bytes", 0))
            elif t.state == "running":
                srow["tasks_running"] += 1
                running += 1
                sample = samples.get((sid, t.partition.partition_id))
                srow["_units"] += _fraction_of(sample)
                if sample:
                    srow["rows_so_far"] += int(sample.get("rows_so_far", 0))
                    srow["bytes_so_far"] += \
                        int(sample.get("bytes_so_far", 0))
            else:
                queued += 1
        stage_rows = []
        now = time.time()
        for sid in sorted(stages):
            srow = stages[sid]
            units = srow.pop("_units")
            st0 = srow.pop("_t0")
            n = srow["tasks_total"]
            f = units / n if n else 0.0
            if status == "completed":
                f = 1.0
            srow["fraction"] = round(f, 4)
            # a stage's rate is measured from ITS first task start —
            # the job wall includes upstream stages' runtime and would
            # inflate a late stage's ETA by orders of magnitude
            stage_wall = max(now - st0, 0.0) if st0 else wall
            srow["eta_seconds"] = _eta(f, stage_wall)
            stage_rows.append(srow)
        fraction = (sum(s["fraction"] * s["tasks_total"]
                        for s in stage_rows) / totals) if totals else 0.0
        if status == "completed":
            fraction, running, queued = 1.0, 0, 0
            completed = totals
        # monotone non-decreasing per job (estimates fluctuating between
        # samples must never show progress going backwards)
        fraction = max(fraction, last_fraction)
        fraction = min(fraction, 1.0)
        snap = {
            "job_id": job_id,
            "status": status,
            "fraction": round(fraction, 4),
            "eta_seconds": _eta(fraction, wall),
            "wall_seconds": round(wall, 3),
            "tasks_total": totals,
            "tasks_running": running,
            "tasks_queued": queued,
            "tasks_completed": completed,
            "stages": stage_rows,
        }
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None and job["final"] is None:
                job["last_fraction"] = fraction
                job["cache"] = (time.time(), _copy_snap(snap))
        return snap

    @staticmethod
    def _snapshot_ttl() -> float:
        return min(max((progress_interval_secs() or 1.0) / 2, 0.05), 0.5)

    def finish(self, job_id: str, status: str) -> None:
        """Terminal transition: freeze one final snapshot (fraction
        exactly 1.0 for completed jobs) and drop the sample store."""
        snap = self.snapshot(job_id)
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or snap is None:
                return
            # own copy before mutating: snapshot() may have handed the
            # same stage dicts to a concurrent reader via the cache
            snap = _copy_snap(snap)
            snap["status"] = status
            if status == "completed":
                force_completed(snap)
            job["final"] = snap
            job["samples"] = {}

    def live_snapshots(self) -> List[dict]:
        """Snapshots of every non-terminal tracked job (the /debug/jobs
        list, the Prometheus gauges, system.stages)."""
        with self._lock:
            live = [j for j, rec in self._jobs.items()
                    if rec["final"] is None]
        out = []
        for job_id in live:
            snap = self.snapshot(job_id)
            if snap is not None and snap["status"] in ("queued", "running"):
                out.append(snap)
        return out

    def task_rows(self) -> List[dict]:
        """``system.tasks``: one row per RUNNING task of every live
        job, joined with the latest progress sample."""
        with self._lock:
            live = {j: dict(rec["samples"])
                    for j, rec in self._jobs.items()
                    if rec["final"] is None}
        rows: List[dict] = []
        now = time.time()
        for job_id, samples in live.items():
            for t in self._task_states(job_id):
                if t.state != "running":
                    continue
                sample = samples.get(
                    (t.partition.stage_id, t.partition.partition_id)) or {}
                elapsed = (now - t.started_at) if t.started_at else None
                rows.append({
                    "job_id": job_id,
                    "stage_id": t.partition.stage_id,
                    "partition_id": t.partition.partition_id,
                    "executor_id": t.executor_id or "",
                    "operator": sample.get("operator"),
                    "rows_so_far": sample.get("rows_so_far"),
                    "bytes_so_far": sample.get("bytes_so_far"),
                    "elapsed_seconds": round(elapsed, 3)
                    if elapsed is not None else None,
                })
        return rows

    def stage_rows(self) -> List[dict]:
        """``system.stages``: the per-stage progress rows of every live
        job."""
        rows: List[dict] = []
        for snap in self.live_snapshots():
            for s in snap["stages"]:
                rows.append({"job_id": snap["job_id"], **s})
        return rows


# ---------------------------------------------------------------------------
# Per-session resource metering (system.sessions)
# ---------------------------------------------------------------------------

_SESSIONS_FILE = "sessions.json"
SESSION_SETTING = "session.id"


class SessionMeter:
    """Cumulative per-session resource accounting.

    One record per client session id: queries run, wall seconds,
    task seconds (summed executor task time — the cluster's "cpu"
    proxy), device-blocked seconds (from the lane decomposition, when
    it lands), shuffle bytes, peak host/device bytes. Durable when a
    directory is given: the whole (small, bounded) map is atomically
    rewritten and reloaded at construction, so metering survives
    restarts next to the query-history log. Disk writes are DEBOUNCED
    (at most one per ``SAVE_INTERVAL_SECS``, plus a ``flush()`` at
    interpreter exit) — the save must not tax the collect/terminal hot
    paths per query; a hard kill can lose the last interval's updates,
    best-effort like the rest of the plane. Saves re-read
    the file and keep session ids this process never touched, so
    concurrent writers (scheduler + a standalone process sharing the
    dir) don't erase each other's sessions — same-session counters
    from two processes remain last-writer-wins (best-effort, like the
    rest of the plane)."""

    CAP = 256
    SAVE_INTERVAL_SECS = 2.0

    def __init__(self, directory: Optional[str] = None):
        self._lock = threading.Lock()
        self._dir = directory
        self._sessions: "OrderedDict[str, dict]" = OrderedDict()
        self._last_save = 0.0
        self._dirty = False
        if directory:
            self._load()

    def _path(self) -> Optional[str]:
        if not self._dir:
            return None
        return os.path.join(self._dir, _SESSIONS_FILE)

    def _load(self) -> None:
        path = self._path()
        try:
            with open(path) as fh:
                data = json.load(fh)
            if isinstance(data, dict):
                for sid, rec in data.items():
                    if isinstance(rec, dict):
                        self._sessions[str(sid)] = rec
        except (OSError, ValueError):
            pass  # no file yet / corrupt: start fresh

    def _maybe_save_locked(self) -> None:
        """Debounced durability: write through at most once per
        ``SAVE_INTERVAL_SECS`` — per-query file I/O on the collect /
        terminal-transition paths is exactly what the overhead gates
        forbid. ``flush()`` (registered atexit for process meters)
        writes out whatever the debounce skipped."""
        self._dirty = True
        if self._path() is None:
            return
        if time.time() - self._last_save >= self.SAVE_INTERVAL_SECS:
            self._save_locked()

    def flush(self) -> None:
        with self._lock:
            if self._dirty:
                self._save_locked()

    def _save_locked(self) -> None:
        path = self._path()
        if path is None:
            return
        self._last_save = time.time()
        self._dirty = False
        merged: Dict[str, dict] = {}
        try:
            with open(path) as fh:
                data = json.load(fh)
            if isinstance(data, dict):
                for sid, rec in data.items():
                    if isinstance(rec, dict) and sid not in self._sessions:
                        merged[str(sid)] = rec
        except (OSError, ValueError):
            pass  # no file yet / corrupt: write only what we know
        merged.update(self._sessions)
        if len(merged) > self.CAP:
            drop = sorted(merged, key=lambda s: merged[s].get(
                "last_active", 0.0))[:len(merged) - self.CAP]
            for sid in drop:
                merged.pop(sid, None)
        try:
            os.makedirs(self._dir, exist_ok=True)
            tmp = "%s.tmp.%d" % (path, os.getpid())
            with open(tmp, "w") as fh:
                json.dump(merged, fh)
            os.replace(tmp, path)
        except OSError:
            log.warning("session meter save failed (%s)", self._dir,
                        exc_info=True)

    def record(self, session_id: str, wall_seconds: float = 0.0,
               task_seconds: float = 0.0,
               device_blocked_seconds: float = 0.0,
               bytes_shuffled: int = 0,
               peak_host_bytes: int = 0,
               peak_device_bytes: int = 0) -> None:
        """Accumulate one finished query into the session's record."""
        sid = str(session_id or "anonymous")
        now = time.time()
        with self._lock:
            rec = self._sessions.pop(sid, None)
            if rec is None:
                rec = {"session_id": sid, "queries": 0,
                       "wall_seconds": 0.0, "task_seconds": 0.0,
                       "device_blocked_seconds": 0.0,
                       "bytes_shuffled": 0, "peak_host_bytes": 0,
                       "peak_device_bytes": 0,
                       "table_cache_hits": 0, "result_cache_hits": 0,
                       "started_at": now}
            rec["queries"] += 1
            rec["wall_seconds"] = round(
                rec["wall_seconds"] + float(wall_seconds), 4)
            rec["task_seconds"] = round(
                rec["task_seconds"] + float(task_seconds), 4)
            rec["device_blocked_seconds"] = round(
                rec["device_blocked_seconds"]
                + float(device_blocked_seconds), 4)
            rec["bytes_shuffled"] += int(bytes_shuffled)
            rec["peak_host_bytes"] = max(rec["peak_host_bytes"],
                                         int(peak_host_bytes or 0))
            rec["peak_device_bytes"] = max(rec["peak_device_bytes"],
                                           int(peak_device_bytes or 0))
            rec["last_active"] = now
            self._sessions[sid] = rec  # re-insert: LRU order
            while len(self._sessions) > self.CAP:
                self._sessions.popitem(last=False)
            self._maybe_save_locked()

    def annotate(self, session_id: str,
                 device_blocked_seconds: float = 0.0) -> None:
        """Late-arriving facts (the lane decomposition lands on the
        deferred merge worker, after the terminal record)."""
        if not device_blocked_seconds:
            return
        sid = str(session_id or "anonymous")
        with self._lock:
            rec = self._sessions.get(sid)
            if rec is None:
                return
            rec["device_blocked_seconds"] = round(
                rec["device_blocked_seconds"]
                + float(device_blocked_seconds), 4)
            rec["last_active"] = time.time()
            self._maybe_save_locked()

    def annotate_cache(self, session_id: str, table_cache_hits: int = 0,
                       result_cache_hits: int = 0) -> None:
        """Warm-path cache attribution for an already-recorded query —
        like :meth:`annotate`, this never bumps the ``queries`` count
        (a result-cache hit IS a query; its hit flag arrives
        separately)."""
        if not table_cache_hits and not result_cache_hits:
            return
        sid = str(session_id or "anonymous")
        with self._lock:
            rec = self._sessions.get(sid)
            if rec is None:
                # annotation can land before the recorder's terminal
                # record() (first query of a session): seed a zero-query
                # record, record() accumulates into it
                rec = self._sessions[sid] = {
                    "session_id": sid, "queries": 0,
                    "wall_seconds": 0.0, "task_seconds": 0.0,
                    "device_blocked_seconds": 0.0,
                    "bytes_shuffled": 0, "peak_host_bytes": 0,
                    "peak_device_bytes": 0,
                    "table_cache_hits": 0, "result_cache_hits": 0,
                    "started_at": time.time()}
            # pre-cache records loaded from disk lack the fields
            rec["table_cache_hits"] = (
                int(rec.get("table_cache_hits", 0)) + int(table_cache_hits))
            rec["result_cache_hits"] = (
                int(rec.get("result_cache_hits", 0))
                + int(result_cache_hits))
            rec["last_active"] = time.time()
            self._maybe_save_locked()

    def rows(self) -> List[dict]:
        with self._lock:
            return [dict(rec) for rec in self._sessions.values()]


_meter_lock = threading.Lock()
_meters: Dict[Optional[str], SessionMeter] = {}


def process_session_meter() -> SessionMeter:
    """The process's session meter for the current
    ``BALLISTA_QUERY_LOG_DIR`` (in-memory only when unset). Shared by
    the standalone recorder, the scheduler's terminal hook and the
    ``system.sessions`` scans of this process."""
    from .systables import query_log_dir

    d = query_log_dir()
    with _meter_lock:
        meter = _meters.get(d)
        if meter is None:
            meter = _meters[d] = SessionMeter(d)
            if d:
                # durability backstop for the save debounce
                atexit.register(meter.flush)
        return meter


def _reset_process_state_for_tests() -> None:
    with _meter_lock:
        _meters.clear()
    with _local_lock:
        _LOCAL.clear()


# ---------------------------------------------------------------------------
# Standalone parity: local query handles + the on_progress sampler
# ---------------------------------------------------------------------------

_local_lock = threading.Lock()
_LOCAL: "OrderedDict[str, LocalQueryHandle]" = OrderedDict()
_tls = threading.local()


class LocalQueryHandle:
    """One in-flight standalone collect, visible to the live surfaces
    (system.tasks / system.stages / in-flight system.queries) and
    driving the ``on_progress`` sampler. The executed plan attaches
    lazily (planning happens after the recorder starts) and is held
    weakly — a handle must never pin a plan tree."""

    def __init__(self, job_id: str, session_id: str = "",
                 plan_digest: str = ""):
        self.job_id = job_id
        self.session_id = session_id
        self.plan_digest = plan_digest
        self.t0 = time.time()
        self.status = "running"
        self._plan_ref = None
        self._input_total = 0
        self._last_fraction = 0.0
        self._last_sample: dict = {}

    def attach_plan(self, phys) -> None:
        self._plan_ref = weakref.ref(phys)
        try:
            self._input_total = plan_input_estimate(phys)
        except Exception:  # noqa: BLE001 - advisory
            self._input_total = 0

    def sample(self) -> dict:
        plan = self._plan_ref() if self._plan_ref is not None else None
        if plan is None:
            return dict(self._last_sample)
        try:
            s = sample_plan(plan, input_rows_total=self._input_total)
        except Exception:  # noqa: BLE001 - advisory
            return dict(self._last_sample)
        self._last_sample = s
        return s

    def snapshot(self) -> dict:
        """The ONE progress shape, standalone face: a single synthetic
        stage 0 with one task."""
        wall = max(time.time() - self.t0, 0.0)
        done = self.status == "completed"
        if done:
            f = 1.0
        elif self.status in ("failed", "cancelled"):
            f = self._last_fraction
        else:
            f = max(_fraction_of(self.sample()), self._last_fraction)
        self._last_fraction = f
        running = 0 if self.status != "running" else 1
        s = self._last_sample
        stage = {
            "stage_id": 0, "tasks_total": 1, "tasks_running": running,
            "tasks_completed": 1 if done else 0,
            "fraction": round(f, 4), "eta_seconds": _eta(f, wall),
            "rows_so_far": int(s.get("rows_so_far", 0)),
            "bytes_so_far": int(s.get("bytes_so_far", 0)),
        }
        return {
            "job_id": self.job_id,
            "status": self.status,
            "fraction": round(f, 4),
            "eta_seconds": _eta(f, wall),
            "wall_seconds": round(wall, 3),
            "tasks_total": 1,
            "tasks_running": running,
            "tasks_queued": 0,
            "tasks_completed": 1 if done else 0,
            "stages": [stage],
        }


def start_local_query(job_id: str, session_id: str = "",
                      plan_digest: str = "") -> LocalQueryHandle:
    """Register one standalone collect with the live surfaces. Also
    pushed onto a thread-local stack so the collect path can attach
    the executed plan without threading the handle through every
    layer."""
    h = LocalQueryHandle(job_id, session_id, plan_digest)
    with _local_lock:
        _LOCAL[job_id] = h
        while len(_LOCAL) > 64:
            _LOCAL.popitem(last=False)
    stack = getattr(_tls, "handles", None)
    if stack is None:
        stack = _tls.handles = []
    stack.append(h)
    return h


def attach_current_plan(phys) -> None:
    """Attach the executed physical plan to this thread's active
    handle (no-op outside a recorded collect — df.profile() and
    EXPLAIN drive the inner path directly)."""
    stack = getattr(_tls, "handles", None)
    if stack:
        try:
            stack[-1].attach_plan(phys)
        except Exception:  # noqa: BLE001 - advisory
            pass


def finish_local_query(handle: LocalQueryHandle, status: str) -> None:
    handle.status = status
    stack = getattr(_tls, "handles", None)
    if stack and handle in stack:
        stack.remove(handle)
    with _local_lock:
        _LOCAL.pop(handle.job_id, None)


def local_live_handles() -> List[LocalQueryHandle]:
    with _local_lock:
        return list(_LOCAL.values())


def local_stage_rows() -> List[dict]:
    """Standalone ``system.stages``: one row per in-flight collect."""
    rows = []
    for h in local_live_handles():
        snap = h.snapshot()
        for s in snap["stages"]:
            rows.append({"job_id": snap["job_id"], **s})
    return rows


def local_task_rows() -> List[dict]:
    """Standalone ``system.tasks``: one row per in-flight collect."""
    rows = []
    for h in local_live_handles():
        s = h.sample()
        rows.append({
            "job_id": h.job_id,
            "stage_id": 0,
            "partition_id": 0,
            "executor_id": "standalone",
            "operator": s.get("operator"),
            "rows_so_far": s.get("rows_so_far"),
            "bytes_so_far": s.get("bytes_so_far"),
            "elapsed_seconds": round(time.time() - h.t0, 3),
        })
    return rows


def local_live_query_records() -> List[dict]:
    """In-flight ``system.queries`` / ``/debug/queries`` rows for
    running standalone collects (status="running", live wall seconds);
    removed on completion (the terminal record replaces them)."""
    from .systables import build_query_record

    out = []
    for h in local_live_handles():
        out.append(build_query_record(
            h.job_id, "running", time.time() - h.t0,
            plan_digest=h.plan_digest or None,
            started_at=h.t0, origin="standalone",
        ))
    return out


def emit_if_changed(cb, snap: dict, last_key):
    """Deliver one progress snapshot to a caller's ``on_progress``
    callback when it meaningfully changed vs ``last_key``; returns the
    new key to carry forward. The ONE dedup + protect contract for
    both delivery paths (cluster status poll, standalone sampler):
    best-effort — a raising callback is logged, never the query's
    problem."""
    key = (snap["fraction"], snap["tasks_completed"], snap["status"])
    if key == last_key:
        return last_key
    try:
        cb(snap)
    except Exception:  # noqa: BLE001 - observability only
        log.warning("on_progress callback failed", exc_info=True)
    return key


class LocalProgressSampler:
    """Background sampler driving ``df.collect(on_progress=cb)`` on the
    standalone path: one daemon thread polls the handle's snapshot on
    the progress cadence and invokes the callback when it changes
    (callbacks run on the sampler thread; a raising callback is
    dropped, never the query). ``finish()`` emits the terminal
    snapshot (fraction exactly 1.0 on success) from the collect
    thread."""

    def __init__(self, handle: LocalQueryHandle,
                 on_progress: Callable[[dict], None],
                 interval: Optional[float] = None):
        self._handle = handle
        self._cb = on_progress
        self._interval = interval if interval is not None else \
            (progress_interval_secs() or 0.2)
        self._stop = threading.Event()
        self._last: Optional[tuple] = None
        # serializes callbacks across the sampler and collect threads:
        # the terminal snapshot must be the LAST callback even when a
        # user callback blocks past finish()'s join timeout
        self._emit_lock = threading.Lock()
        self._terminal = False
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"progress-{handle.job_id}")
        self._thread.start()

    def _emit(self, snap: dict, terminal: bool = False) -> None:
        # the terminal emit runs on the COLLECT thread: bound the wait
        # so a user callback blocked inside the sampler thread cannot
        # wedge df.collect() past query completion (the terminal
        # callback is then skipped — the callback is already stuck)
        if not self._emit_lock.acquire(timeout=2.0 if terminal else -1):
            log.warning("terminal on_progress skipped: a callback is "
                        "still blocked")
            return
        try:
            if self._terminal and not terminal:
                return  # a straggling sample must not follow the final
            if terminal:
                self._terminal = True
            self._last = emit_if_changed(self._cb, snap, self._last)
        finally:
            self._emit_lock.release()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self._emit(self._handle.snapshot())
            except Exception:  # noqa: BLE001 - sampler must not die
                pass

    def finish(self, status: str) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._handle.status = status
        try:
            self._emit(self._handle.snapshot(), terminal=True)
        except Exception:  # noqa: BLE001
            pass
