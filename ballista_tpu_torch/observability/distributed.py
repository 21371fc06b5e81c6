"""Distributed query profiler: merged per-job artifacts + flight
recorder plumbing.

Three pieces, all built on the flight-recorder ring in ``tracing.py``:

- **Executor side** — :func:`capture_task_profile` mines the ring for
  the spans a just-completed task emitted (matched STRUCTURALLY by the
  task's flow attribute, so concurrent tasks in one process never
  cross-attribute), tags them with the executor's identity, bounds them
  (record count + serialized bytes), and packages them with the ingest
  phase / compile-governor deltas and a memory snapshot. The executor
  ships the package back inside ``CompletedTask.profile`` (proto
  ``TaskProfile``; records travel as one JSON blob because span attrs
  are free-form).

- **Scheduler side** — :class:`JobProfileCollector` keeps a bounded
  per-job collection of those task payloads, and :func:`merged_session`
  joins them with the scheduler's own ring window (``plan_job`` /
  ``task_dispatch`` spans, matched by the ``job`` flow attr) into ONE
  profiler session: per-process identity preserved, duplicates dropped
  by (pid, sid) — an in-process LocalCluster shares one ring, so the
  scheduler's window would otherwise re-contain every executor span —
  and ``export.build_artifact`` renders it with per-process tracks,
  task flow arrows, the stage/task Gantt lane, and cluster-aggregated
  named wall-time lanes.

- **Retroactive slow-query dump** — :func:`watch_slow_query` wraps a
  standalone collect with near-zero cost (two snapshot dict copies when
  ``BALLISTA_SLOW_QUERY_SECS`` is set, nothing otherwise); a query that
  crosses the threshold dumps a merged artifact AFTER the fact from the
  ring — no re-run with profiling enabled needed. Artifacts land in
  ``BALLISTA_SLOW_QUERY_DIR`` (default: ``BALLISTA_PROFILE`` dir, else
  the system temp dir).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from . import memory as obs_memory
from . import tracing
from .export import COMPILE_SECONDS, COMPILE_STATS

log = logging.getLogger("ballista.profiler")

# bounds on one task's shipped profile window: the ring itself bounds
# span RETENTION, these bound what crosses the wire per completion
TASK_PROFILE_MAX_RECORDS = 2000
TASK_PROFILE_MAX_BYTES = 1 << 19  # 512 KiB of records JSON
# per-JOB bound on collected record bytes (scheduler side): keeps the
# merged artifact — and its GetJobProfile serialization — comfortably
# under the 64 MB transport cap however many tasks the job ran
JOB_PROFILE_MAX_BYTES = 32 << 20


def task_profile_enabled() -> bool:
    """BALLISTA_TASK_PROFILE: executors ship per-task profile windows
    with CompletedTask (default on; the payload is bounded and the
    capture is a ring scan, not a trace re-run)."""
    return os.environ.get("BALLISTA_TASK_PROFILE", "").lower() not in (
        "0", "off", "false")


def _phase_delta(now: Dict[str, float], before: Dict[str, float]) -> dict:
    return {k: round(float(now.get(k, 0.0)) - float(before.get(k, 0.0)), 6)
            for k in set(now) | set(before)}


def _compile_delta(now: dict, before: dict) -> dict:
    out = {}
    for k in COMPILE_STATS:
        if k in now:
            v = now[k] - before.get(k, 0)
            out[k] = round(v, 6) if isinstance(v, float) else v
    return out


def capture_task_profile(task_key: str, t0: float, wall: float,
                         executor_id: str,
                         phases0: Optional[dict] = None,
                         compile0: Optional[dict] = None) -> dict:
    """Build the profile payload for one completed task from the flight
    recorder. Records are matched by the ``task`` flow attr (every span
    emitted under the task's flow binding — ingest producers included —
    carries it) and FORCE-tagged with this executor's identity: in an
    in-process LocalCluster all executors share one ring and the
    process-level identity stamp belongs to whichever component
    initialized first."""
    from ..compile import compile_stats
    from ..ingest import phase_totals

    matched: List[dict] = []
    for r in tracing.ring_records(since=t0, task=task_key):
        # in-process: the scheduler's dispatch span carries the same
        # task attr but belongs to the scheduler's window
        if str(r.get("name", "")).startswith("scheduler."):
            continue
        r = dict(r)
        r["role"] = "executor"
        r["exec"] = executor_id[:8]
        matched.append(r)
    # the task's own root span lands in the ring LAST (spans are
    # emitted at __exit__), so a chronological keep-earliest truncation
    # would drop exactly the record the merged artifact anchors on (the
    # Gantt slice, the flow-arrow endpoint, the task-worker thread
    # name). Reserve it off the budget before the chronological fill.
    root_idx = next((i for i in range(len(matched) - 1, -1, -1)
                     if matched[i].get("name") == "executor.task"), None)
    root_enc = (json.dumps(matched[root_idx], default=str)
                if root_idx is not None else None)
    max_bytes = TASK_PROFILE_MAX_BYTES - (len(root_enc) if root_enc else 0)
    max_records = TASK_PROFILE_MAX_RECORDS - (1 if root_enc else 0)
    records: List[dict] = []
    encoded: List[str] = []
    truncated = 0
    nbytes = 0
    kept_other = 0
    full = False
    for i, r in enumerate(matched):
        if i == root_idx:
            records.append(r)
            encoded.append(root_enc)
            continue
        if full:  # prefix semantics: past the first overflow, only count
            truncated += 1
            continue
        enc = json.dumps(r, default=str)
        if kept_other >= max_records or nbytes + len(enc) > max_bytes:
            full = True
            truncated += 1
            continue
        nbytes += len(enc)
        kept_other += 1
        records.append(r)
        encoded.append(enc)
    out = {
        # the wire encoding is a byproduct of the size bound above:
        # serde ships it as-is instead of re-serializing the record list
        "records_json": "[" + ",".join(encoded) + "]",
        "t0": t0,
        "wall_seconds": round(wall, 6),
        "pid": os.getpid(),
        "role": "executor",
        "executor_id": executor_id[:8],
        "records": records,
        # process-wide deltas: with concurrent tasks these can
        # cross-attribute — the merged artifact's lanes therefore come
        # from the span records, these ride along as context
        "phases": _phase_delta(phase_totals(), phases0 or {}),
        "compile": _compile_delta(compile_stats(), compile0 or {}),
        "memory": obs_memory.memory_snapshot(),
    }
    # per-task latency-ledger deltas ride the same free-form phases
    # dict as "ledger.<phase>" keys (no proto change): span-derived
    # fetch/write/cache slices + the compile delta, with the remainder
    # as device_execute. The scheduler sums them across tasks at
    # job-terminal time (ledger.assemble_job_ledger).
    try:
        from . import ledger as _ledger

        out["phases"].update(_ledger.task_ledger_phases(
            matched, wall,
            compile_seconds=float(
                out["compile"].get(COMPILE_SECONDS, 0.0))))
    except Exception:  # noqa: BLE001 - observability only
        log.exception("task ledger extraction failed")
    if truncated:
        out["records_truncated"] = truncated
    return out


# ---------------------------------------------------------------------------
# Scheduler-side merge
# ---------------------------------------------------------------------------


def merged_session(job_id: str, scheduler_records: List[dict],
                   task_profiles: List[dict], wall_seconds: float,
                   label: Optional[str] = None) -> dict:
    """Join the scheduler's ring window with every executor task payload
    into one profiler session (export.build_artifact renders it)."""
    def _dedup_key(r: dict):
        # spans dedup structurally by (pid, sid); instant events carry
        # no sid, so they key on (pid, tid, ts, name) instead
        if r.get("sid") is not None:
            return (r.get("pid"), "sid", r.get("sid"))
        return (r.get("pid"), r.get("tid"), r.get("ts"), r.get("name"))

    seen = {_dedup_key(r)
            for p in task_profiles for r in p.get("records") or []}
    records: List[dict] = []
    for r in scheduler_records:
        # in-process cluster: the scheduler's ring ALSO holds the
        # executor-window records — drop the duplicates structurally
        if _dedup_key(r) in seen:
            continue
        r = dict(r)
        r.setdefault("role", "scheduler")
        records.append(r)
    executors = []
    memory: Dict[str, dict] = {}
    compile_total: dict = {}
    for p in task_profiles:
        records.extend(p.get("records") or [])
        ex = p.get("executor_id", "?")
        if ex not in executors:
            executors.append(ex)
        memory[ex] = p.get("memory") or {}
        for k, v in (p.get("compile") or {}).items():
            compile_total[k] = compile_total.get(k, 0) + v
    t0 = min((float(r.get("ts", 0.0)) for r in records), default=0.0)
    return {
        "schema": "ballista-profile-v1",
        "label": label or f"job-{job_id}",
        "t0": t0,
        "wall_seconds": round(float(wall_seconds), 6),
        # no process-wide phase deltas: compute_lanes falls back to the
        # ingest.* span sums across all processes
        "phases": {},
        "compile": compile_total,
        "memory": {"scheduler": obs_memory.memory_snapshot(),
                   "executors": memory},
        "operators": None,
        "records": records,
        "distributed": {
            "job_id": job_id,
            "num_task_profiles": len(task_profiles),
            "executors": executors,
        },
    }


class JobProfileCollector:
    """Bounded per-job collection of executor task-profile payloads plus
    the artifacts built from them. The scheduler keeps ONE instance;
    everything here is advisory observability state — bounded rings,
    never the source of truth for scheduling."""

    def __init__(self, max_jobs: int = 16, max_tasks_per_job: int = 512):
        self._lock = threading.Lock()
        self._max_jobs = max_jobs
        self._max_tasks = max_tasks_per_job
        # job_id -> {"tasks": [profile...], "summary": dict|None,
        #            "artifact": dict|None, "path": str|None}
        self._jobs: Dict[str, dict] = {}
        self._order: List[str] = []

    def _slot(self, job_id: str) -> dict:
        # caller holds the lock
        slot = self._jobs.get(job_id)
        if slot is None:
            slot = {"tasks": [], "bytes": 0, "summary": None,
                    "artifact": None, "partial": None, "path": None}
            self._jobs[job_id] = slot
            self._order.append(job_id)
            while len(self._order) > self._max_jobs:
                self._jobs.pop(self._order.pop(0), None)
        return slot

    def add_task_profile(self, job_id: str, profile: dict,
                         nbytes: Optional[int] = None) -> None:
        """``nbytes``: the wire size of the payload's record blob (the
        caller usually has it from the proto). Counted toward a per-job
        byte cap so a long job's many task windows can't grow the
        merged artifact past what the transport can return."""
        if nbytes is None:
            nbytes = sum(len(str(r)) for r in profile.get("records") or [])
        with self._lock:
            slot = self._slot(job_id)
            if len(slot["tasks"]) < self._max_tasks and \
                    slot["bytes"] + nbytes <= JOB_PROFILE_MAX_BYTES:
                slot["tasks"].append(profile)
                slot["bytes"] += nbytes

    def finalize(self, job_id: str, summary: dict) -> None:
        """Record the job's terminal summary (wall seconds, state, plan
        digest) so on-demand artifact builds after completion have the
        window metadata."""
        with self._lock:
            self._slot(job_id)["summary"] = dict(summary)

    def set_artifact(self, job_id: str, artifact: dict,
                     path: Optional[str]) -> None:
        with self._lock:
            slot = self._slot(job_id)
            slot["artifact"] = artifact
            slot["path"] = path

    def artifact_path(self, job_id: str) -> Optional[str]:
        with self._lock:
            slot = self._jobs.get(job_id)
            return slot["path"] if slot else None

    def task_payloads(self, job_id: str) -> List[dict]:
        """The job's collected per-task profile payloads (shared list
        snapshot; callers must not mutate the payload dicts)."""
        with self._lock:
            slot = self._jobs.get(job_id)
            return list(slot["tasks"]) if slot else []

    def build(self, job_id: str,
              wall_seconds: Optional[float] = None,
              sched_records: Optional[List[dict]] = None) -> Optional[dict]:
        """The job's merged artifact: the cached one when a prior build
        exists, else built now from the collected task payloads + the
        scheduler's ring window (``sched_records`` when the caller
        already snapshotted it — the deferred terminal build does, so
        later queries can't evict this job's spans first). None for
        unknown jobs. A build for a job that is NOT yet terminal (no
        finalized summary — e.g. a /debug/profile hit mid-job) is
        returned but never cached, so it cannot poison the artifact the
        terminal transition builds."""
        from . import export

        with self._lock:
            slot = self._jobs.get(job_id)
            if slot is None:
                return None
            if slot["artifact"] is not None:
                return slot["artifact"]
            terminal = slot["summary"] is not None
            if not terminal:
                # mid-job builds get polled (df.profile() waits for the
                # terminal one at 100-250ms intervals): serve a briefly
                # cached partial instead of re-merging every poll
                pa = slot.get("partial")
                if pa is not None and time.time() - pa[0] < 0.5:
                    return pa[1]
            tasks = list(slot["tasks"])
            summary = slot["summary"] or {}
        if wall_seconds is None:
            wall_seconds = float(summary.get("wall_seconds", 0.0))
        if sched_records is None:
            sched_records = tracing.ring_records(job=job_id)
        if not tasks and not sched_records:
            return None
        session = merged_session(job_id, sched_records, tasks,
                                 wall_seconds)
        if not terminal:
            session["distributed"]["partial"] = True
        if summary.get("plan_digest"):
            session["distributed"]["plan_digest"] = summary["plan_digest"]
        art = export.build_artifact(session)
        with self._lock:
            # cache (races build the same value; last write wins)
            if terminal:
                self._slot(job_id)["artifact"] = art
            else:
                self._slot(job_id)["partial"] = (time.time(), art)
        return art


# ---------------------------------------------------------------------------
# Retroactive slow-query dump (standalone path)
# ---------------------------------------------------------------------------


def slow_query_dir() -> str:
    """Where retroactive slow-query artifacts land:
    ``BALLISTA_SLOW_QUERY_DIR`` > ``BALLISTA_PROFILE`` dir > tempdir."""
    import tempfile

    v = os.environ.get("BALLISTA_SLOW_QUERY_DIR")
    if v:
        return v
    from .profiler import profile_dir

    d = profile_dir()
    return d if d is not None else tempfile.gettempdir()


def slow_query_max_artifacts() -> int:
    """``BALLISTA_SLOW_QUERY_MAX_ARTIFACTS`` (default 32): cap on
    retained slow-query dumps in ``slow_query_dir()`` — under sustained
    overload every slow query writes one, so an uncapped directory
    grows without bound. 0 disables pruning."""
    try:
        return max(int(os.environ.get(
            "BALLISTA_SLOW_QUERY_MAX_ARTIFACTS", "32")), 0)
    except ValueError:
        return 32


def prune_slow_query_artifacts(out_dir: Optional[str] = None) -> int:
    """Delete the OLDEST ``ballista-profile-*.json`` dumps past the
    max-artifacts cap (oldest by mtime — the newest dumps are the ones
    an operator is about to look at). Only artifact-named files are
    touched: the slow-query dir may be a shared profile dir. Returns
    the number of files removed; never raises."""
    cap = slow_query_max_artifacts()
    if cap <= 0:
        return 0
    d = out_dir or slow_query_dir()
    try:
        names = [n for n in os.listdir(d)
                 if n.startswith("ballista-profile-")
                 and n.endswith(".json")]
    except OSError:
        return 0
    if len(names) <= cap:
        return 0
    entries = []
    for n in names:
        path = os.path.join(d, n)
        try:
            entries.append((os.path.getmtime(path), path))
        except OSError:  # raced a concurrent prune/delete
            continue
    entries.sort()
    removed = 0
    for _, path in entries[:max(len(entries) - cap, 0)]:
        try:
            os.remove(path)
            removed += 1
        except OSError:
            continue
    if removed:
        log.info("pruned %d slow-query artifact(s) past the %d-file cap "
                 "in %s", removed, cap, d)
    return removed


def dump_ring_artifact(label: str, t0: float, wall: float,
                       phases0: Optional[dict] = None,
                       compile0: Optional[dict] = None,
                       out_dir: Optional[str] = None) -> Optional[str]:
    """Write a profile artifact for the window [t0, now] straight from
    the flight recorder — the retroactive path, used when a query turns
    out slow AFTER it ran unprofiled. Returns the artifact path, or
    None when the ring is off/empty."""
    from ..compile import compile_stats
    from ..ingest import phase_totals
    from . import export

    records = tracing.ring_records(since=t0)
    if not records:
        return None
    session = {
        "schema": "ballista-profile-v1",
        "label": label,
        "t0": t0,
        "wall_seconds": round(wall, 6),
        "phases": _phase_delta(phase_totals(), phases0 or {}),
        "compile": _compile_delta(compile_stats(), compile0 or {}),
        "memory": obs_memory.memory_snapshot(),
        "operators": None,
        "records": records,
        "flight_recorder": True,
    }
    dest = out_dir or slow_query_dir()
    path = export.write_artifact(session, out_dir=dest)
    prune_slow_query_artifacts(dest)
    return path


@contextmanager
def watch_slow_query(label_fn: Callable[[], str],
                     artifact_out: Optional[list] = None):
    """Wrap a standalone collect: when ``BALLISTA_SLOW_QUERY_SECS`` is
    set and the wrapped block takes at least that long, dump a
    retroactive artifact from the flight recorder. Costs nothing when
    the threshold is unset; never raises into the query.
    ``artifact_out`` (a list) receives the written artifact path so the
    caller can link it from the query-history record."""
    from .health import slow_query_secs

    thr = slow_query_secs()
    if thr is None or not tracing.flight_recorder_enabled():
        yield
        return
    from ..compile import compile_stats
    from ..ingest import phase_totals

    phases0 = phase_totals()
    compile0 = compile_stats()
    t0 = time.time()
    try:
        yield
    finally:
        wall = time.time() - t0
        if wall >= thr:
            try:
                label = f"slow-{label_fn()}"
            except Exception:  # noqa: BLE001 - label is cosmetic
                label = "slow-query"
            try:
                path = dump_ring_artifact(label, t0, wall,
                                          phases0=phases0,
                                          compile0=compile0)
                if path and artifact_out is not None:
                    artifact_out.append(path)
                if path:
                    log.warning(
                        "slow query (%.3fs >= %.3fs): retroactive "
                        "profile artifact written: %s", wall, thr, path)
            except Exception:  # noqa: BLE001 - never fail the query
                log.exception("retroactive slow-query dump failed")
