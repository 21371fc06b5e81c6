"""Cluster state: KV backend abstraction + scheduler state machine.

Re-implements the reference's scheduler state layer (reference:
rust/scheduler/src/state/mod.rs — ``ConfigBackendClient`` KV trait at
:46-59, key scheme /ballista/{ns}/... at :387-434, task assignment at
:182-260, job-status synthesis at :267-358) with two backends:

- ``MemoryBackend``: in-process dict (the reference's sled standalone);
- ``SqliteBackend``: durable file-backed store (survives scheduler restart,
  the role etcd/sled-on-disk plays for the reference).

Improvement over the reference (its own TODO at state/mod.rs:263 "We should
get rid of this to be able to scale"): task assignment keeps an explicit
ready-queue of schedulable tasks instead of rescanning every task row under
a global lock — stage-dependency checks run only when a stage completes.
"""

from __future__ import annotations

import logging
import os
import pickle
import sqlite3
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..errors import ClusterError
from ..testing.faults import fault_point
from .types import (
    ExecutorMeta,
    JobStatus,
    PartitionId,
    PartitionLocation,
    StagePlan,
    TaskStatus,
)

log = logging.getLogger("ballista.state")

EXECUTOR_LEASE_SECS = 60  # reference: LEASE_TIME, state/mod.rs:42


# ---------------------------------------------------------------------------
# KV backends
# ---------------------------------------------------------------------------


class KvBackend:
    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_from_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        raise NotImplementedError

    def put(self, key: str, value: bytes, lease_secs: Optional[int] = None):
        raise NotImplementedError

    def delete(self, key: str):
        raise NotImplementedError

    def lock(self):
        raise NotImplementedError


class MemoryBackend(KvBackend):
    def __init__(self):
        self._data: Dict[str, Tuple[bytes, Optional[float]]] = {}
        self._lock = threading.RLock()

    def _expired(self, expiry: Optional[float]) -> bool:
        return expiry is not None and time.time() > expiry

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            v = self._data.get(key)
            if v is None or self._expired(v[1]):
                return None
            return v[0]

    def get_from_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        with self._lock:
            return [
                (k, v)
                for k, (v, exp) in sorted(self._data.items())
                if k.startswith(prefix) and not self._expired(exp)
            ]

    def put(self, key: str, value: bytes, lease_secs: Optional[int] = None):
        with self._lock:
            expiry = time.time() + lease_secs if lease_secs else None
            self._data[key] = (value, expiry)

    def delete(self, key: str):
        with self._lock:
            self._data.pop(key, None)

    def lock(self):
        return self._lock


class SqliteBackend(KvBackend):
    """Durable KV over sqlite (WAL). One connection per thread."""

    def __init__(self, path: str):
        self._path = path
        self._tls = threading.local()
        self._lock = threading.RLock()
        with self._conn() as c:
            c.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                "key TEXT PRIMARY KEY, value BLOB, expiry REAL)"
            )

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._path, timeout=30)
            # crash atomicity: WAL keeps readers unblocked; FULL makes
            # each commit durable before the statement returns, so a
            # SIGKILLed writer leaves whole committed rows or nothing —
            # never a torn record (the restart-recovery contract)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=FULL")
            conn.execute("PRAGMA busy_timeout=30000")
            self._tls.conn = conn
        return conn

    def get(self, key: str) -> Optional[bytes]:
        row = self._conn().execute(
            "SELECT value, expiry FROM kv WHERE key=?", (key,)
        ).fetchone()
        if row is None:
            return None
        if row[1] is not None and time.time() > row[1]:
            return None
        return row[0]

    def get_from_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        rows = self._conn().execute(
            "SELECT key, value, expiry FROM kv WHERE key >= ? AND key < ? "
            "ORDER BY key",
            (prefix, prefix + "\xff"),
        ).fetchall()
        now = time.time()
        return [(k, v) for k, v, e in rows if e is None or now <= e]

    def put(self, key: str, value: bytes, lease_secs: Optional[int] = None):
        expiry = time.time() + lease_secs if lease_secs else None
        with self._conn() as c:
            c.execute(
                "INSERT OR REPLACE INTO kv (key, value, expiry) VALUES (?,?,?)",
                (key, value, expiry),
            )

    def delete(self, key: str):
        with self._conn() as c:
            c.execute("DELETE FROM kv WHERE key=?", (key,))

    def lock(self):
        return self._lock


# ---------------------------------------------------------------------------
# Scheduler state
# ---------------------------------------------------------------------------


def _pad_stage_row(row: tuple) -> tuple:
    """Pad stage rows persisted by older schedulers to the current
    7-field shape (plan_bytes, nparts, deps, shuffle_spec, mesh,
    version, reader_layouts) — positional defaults, so a 5-field row
    gets version 0 (not a mis-slotted mesh count)."""
    defaults = (None, 0, 0, None)  # spec, mesh, version, layouts
    return tuple(row) + defaults[len(row) - 3:]


class SchedulerState:
    """Namespaced cluster state + scheduling queues.

    Key scheme (reference: state/mod.rs:387-434):
      /ballista/{ns}/executors/{id}
      /ballista/{ns}/jobs/{job_id}
      /ballista/{ns}/stages/{job_id}/{stage_id}
      /ballista/{ns}/tasks/{job_id}/{stage_id}/{partition}
    """

    def __init__(self, backend: KvBackend, namespace: str = "default"):
        self.kv = backend
        self.ns = namespace
        self._lock = threading.RLock()
        # ready-queue of (job_id, stage_id, partition) runnable now
        self._ready: List[PartitionId] = []
        # stage dependency bookkeeping: (job, stage) -> [dep stage ids]
        self._stage_deps: Dict[Tuple[str, int], List[int]] = {}
        self._stage_parts: Dict[Tuple[str, int], int] = {}
        # (job, stage) -> devices a task needs (0 = any)
        self._stage_mesh: Dict[Tuple[str, int], int] = {}
        # (job, stage) -> current stage-plan version (adaptive re-plans
        # bump it; reports from older versions are dropped)
        self._stage_versions: Dict[Tuple[str, int], int] = {}
        # adaptive re-plan hook, installed by the scheduler service:
        # callable(state, job_id, completed_stage_id, ready_sids,
        # blocked_sids) invoked (under the state lock) when a stage
        # completes, BEFORE its newly-unblocked dependents are enqueued
        self.replan_hook = None
        # tasks already handed out as speculative duplicates (at most one
        # duplicate per task), tasks with one absorbed failure while a
        # twin copy was still in flight, and the last speculation scan
        # time — all guarded by self._lock
        self._speculated: set = set()
        self._spec_failed_once: set = set()
        self._last_spec_scan = 0.0
        # health plane: ring of recent query summaries (+ slow-query
        # log over BALLISTA_SLOW_QUERY_SECS) and job outcome counters,
        # fed by save_job_status transitions
        from ..observability.health import QueryLog

        self.query_log = QueryLog()
        # live progress plane: /debug/queries + system.queries carry
        # IN-FLIGHT rows (status "running", live wall seconds) next to
        # the terminal ring entries
        self.query_log.live_fn = self.live_query_records
        # last-heartbeat wall times (scheduler-side clock): feeds the
        # heartbeat_age_seconds / stale columns of system.executors
        self._heartbeats: Dict[str, float] = {}
        self.jobs_submitted = 0
        self.jobs_completed = 0
        self.jobs_failed = 0
        self.jobs_cancelled = 0
        self._job_started: Dict[str, float] = {}
        # lifecycle control plane: recently-cancelled job ids (piggy-
        # backed on PollWorkResult until they age out), server-side
        # deadlines (absolute wall times; in-memory — a restarted
        # scheduler re-queues work but drops pending deadlines), and
        # the deadline-scan throttle stamp — all guarded by self._lock
        self._cancelled_jobs: Dict[str, float] = {}
        self._job_deadlines: Dict[str, float] = {}
        self._last_deadline_scan = 0.0
        # distributed profiler: per-job logical-plan digests (so a slow
        # query is identifiable after the fact without re-planning) and
        # the terminal-transition hook the scheduler service installs —
        # profile_hook(job_id, summary, status) may build the merged
        # artifact and enrich the summary before it enters the query log
        self._job_digests: Dict[str, str] = {}
        self.profile_hook = None
        # admission plane: queue_info_fn(job_id) -> {"queue_position",
        # "reason", "queued_seconds"} | None, installed by the scheduler
        # service so queued system.queries rows show their position
        self.queue_info_fn = None
        self._rehydrate()

    def _rehydrate(self):
        """Rebuild in-memory scheduling state from a durable backend after a
        scheduler restart: stage deps/partition counts from the persisted
        stage rows, and the ready-queue from tasks that were pending when
        the previous scheduler died (running tasks are re-queued too — the
        old executor's completion report would be lost)."""
        # chaos surface: a backend read fault here is a restart against
        # a flaky store — the scheduler serves with whatever loaded
        fault_point("state.load", ns=self.ns)
        stage_rows = self.kv.get_from_prefix(self._k("stages"))
        if not stage_rows:
            return
        prefix = self._k("stages") + "/"
        with self._lock:
            jobs = set()
            for k, v in stage_rows:
                job_id, sid = k[len(prefix):].split("/")
                sid = int(sid)
                row = _pad_stage_row(pickle.loads(v))
                _, nparts, deps = row[:3]
                self._stage_deps[(job_id, sid)] = list(deps)
                self._stage_parts[(job_id, sid)] = nparts
                self._stage_mesh[(job_id, sid)] = row[4] or 0
                self._stage_versions[(job_id, sid)] = row[5] or 0
                jobs.add(job_id)
            for job_id in jobs:
                js = self.get_job_status(job_id)
                if js is not None and js.state in ("completed", "failed",
                                                   "cancelled"):
                    continue
                for sid in self.stage_ids(job_id):
                    deps = self._stage_deps.get((job_id, sid), [])
                    if not all(self._stage_complete(job_id, d) for d in deps):
                        continue
                    for t in self.get_task_statuses(job_id, sid):
                        if t.state in (None, "running"):
                            self._ready.append(t.partition)

    # -- keys ---------------------------------------------------------------

    def _k(self, *parts) -> str:
        return "/ballista/" + self.ns + "/" + "/".join(str(p) for p in parts)

    # -- executors ----------------------------------------------------------

    def save_executor_metadata(self, meta: ExecutorMeta):
        with self._lock:
            self._heartbeats[meta.id] = time.time()
        self.kv.put(self._k("executors", meta.id), pickle.dumps(meta),
                    lease_secs=EXECUTOR_LEASE_SECS)
        # durable (unleased) address record: shuffle locations must stay
        # resolvable after a lease hiccup — liveness and addressing are
        # separate concerns (the reference never lease-gates addresses,
        # state/mod.rs:85-90)
        self.kv.put(self._k("executors_meta", meta.id), pickle.dumps(meta))

    def get_executors_metadata(self) -> List[ExecutorMeta]:
        # trailing '/' so the unleased executors_meta/ records don't match
        return [
            pickle.loads(v)
            for _, v in self.kv.get_from_prefix(self._k("executors") + "/")
        ]

    def live_executor_ids(self) -> set:
        """Executors with an unexpired lease."""
        return {e.id for e in self.get_executors_metadata()}

    def all_executor_metadata(self) -> List[ExecutorMeta]:
        """Every executor ever registered, lease state ignored (the
        durable address records): system.executors builds from this so
        stale/dead executors stay VISIBLE from SQL instead of silently
        vanishing with their lease."""
        return [
            pickle.loads(v)
            for _, v in self.kv.get_from_prefix(
                self._k("executors_meta") + "/")
        ]

    def executor_heartbeats(self) -> Dict[str, float]:
        """executor id -> last PollWork wall time (this scheduler
        lifetime; a restarted scheduler starts empty, so pre-restart
        executors read as never-heartbeated until they poll again)."""
        with self._lock:
            return dict(self._heartbeats)

    def executor_address(self, executor_id: str) -> Optional[ExecutorMeta]:
        """Last-known address, regardless of lease state."""
        v = self.kv.get(self._k("executors_meta", executor_id))
        return pickle.loads(v) if v is not None else None

    # -- jobs ---------------------------------------------------------------

    def save_job_status(self, job_id: str, status: JobStatus):
        self.kv.put(self._k("jobs", job_id), pickle.dumps(status))
        # health plane bookkeeping: time the queued -> terminal window
        # and push a summary into the query ring buffer exactly once
        # per job (terminal states may be re-saved idempotently)
        if status.state == "queued":
            self.jobs_submitted += 1
            self._job_started.setdefault(job_id, time.time())
        elif status.state in ("completed", "failed", "cancelled"):
            with self._lock:
                self._job_deadlines.pop(job_id, None)
                # per-job speculation state is dead with the job: these
                # sets (and the recovery counter below) otherwise grow
                # for the scheduler's lifetime (leak test pins this)
                if self._speculated:
                    self._speculated = {
                        p for p in self._speculated
                        if p.job_id != job_id}
                if self._spec_failed_once:
                    self._spec_failed_once = {
                        p for p in self._spec_failed_once
                        if p.job_id != job_id}
            self.kv.delete(self._k("recoveries", job_id))
            t0 = self._job_started.pop(job_id, None)
            if t0 is not None:
                if status.state == "completed":
                    self.jobs_completed += 1
                elif status.state == "cancelled":
                    self.jobs_cancelled += 1
                else:
                    self.jobs_failed += 1
                # ONE record shape for every surface (/debug/queries,
                # the durable history log, system.queries): built by
                # the shared systables layer so they cannot drift
                from ..observability import systables

                out_rows = None
                sm = getattr(status, "stage_metrics", None)
                if sm:
                    try:
                        from ..observability.metrics import QueryMetrics

                        out_rows = QueryMetrics(sm).total_output_rows()
                    except Exception:  # noqa: BLE001 - advisory
                        out_rows = None
                summary = systables.build_query_record(
                    job_id, status.state, time.time() - t0,
                    # pop: the digest's job is done (the summary
                    # carries it on), and the dict must not grow one
                    # entry per job for the scheduler's lifetime
                    plan_digest=self._job_digests.pop(job_id, None),
                    output_rows=out_rows,
                    num_stages=len(self.stage_ids(job_id)),
                    started_at=t0,
                    error=status.error,
                    cancel_reason=getattr(status, "cancel_reason", None),
                    origin="cluster",
                )
                if self.profile_hook is not None:
                    # runs ONCE per job (t0 was just popped); may build
                    # the merged profile artifact and attach its path to
                    # the summary. Best-effort: observability must never
                    # take the job's terminal transition down.
                    try:
                        self.profile_hook(job_id, summary, status)
                    except Exception:  # noqa: BLE001
                        log.exception("profile hook failed for job %s",
                                      job_id)
                systables.record_query(summary,
                                       query_log=self.query_log)

    def get_job_status(self, job_id: str) -> Optional[JobStatus]:
        v = self.kv.get(self._k("jobs", job_id))
        return pickle.loads(v) if v is not None else None

    def job_started_at(self, job_id: str) -> Optional[float]:
        """Submission wall time while the job is non-terminal (the
        terminal transition pops it)."""
        return self._job_started.get(job_id)

    def live_query_records(self) -> List[dict]:
        """In-flight query rows for /debug/queries + system.queries:
        one per non-terminal job, status "queued"/"running" with LIVE
        wall seconds. Overwritten by the terminal ring record the
        moment the job finishes (the terminal transition pops
        _job_started first)."""
        from ..observability import systables

        out = []
        now = time.time()
        for job_id, t0 in list(self._job_started.items()):
            try:
                js = self.get_job_status(job_id)
            except Exception:  # noqa: BLE001 - diagnosis plane
                continue
            state = js.state if js is not None else "queued"
            if state not in ("queued", "running"):
                continue
            rec = systables.build_query_record(
                job_id, state, now - t0,
                plan_digest=self._job_digests.get(job_id),
                num_stages=len(self.stage_ids(job_id)) or None,
                started_at=t0, origin="cluster",
            )
            if state == "queued" and self.queue_info_fn is not None:
                try:
                    info = self.queue_info_fn(job_id)
                except Exception:  # noqa: BLE001 - advisory
                    info = None
                if info:
                    rec["queue_position"] = info["queue_position"]
            out.append(rec)
        return out

    def save_job_digest(self, job_id: str, digest: str):
        """Stable digest of the job's logical plan (in-memory, advisory:
        feeds slow-query summaries and profile artifact labels)."""
        self._job_digests[job_id] = digest

    def get_job_digest(self, job_id: str) -> Optional[str]:
        return self._job_digests.get(job_id)

    def save_job_settings(self, job_id: str, settings: Dict[str, str]):
        """Client ``settings`` of the submitted query, kept for the
        lifetime of the job: adaptive re-planning reads its knobs from
        here so the SUBMITTING client's configuration governs."""
        self.kv.put(self._k("jobconf", job_id), pickle.dumps(dict(settings)))

    def get_job_settings(self, job_id: str) -> Dict[str, str]:
        v = self.kv.get(self._k("jobconf", job_id))
        return pickle.loads(v) if v is not None else {}

    # -- job lifecycle: cancellation + deadlines -----------------------------
    # The reference cannot stop work at all (no CancelJob; a client
    # timeout only stops WAITING). Cancellation here is cooperative:
    # the job moves to a terminal Cancelled state, its queued tasks are
    # dropped, and executors learn via the PollWorkResult piggyback to
    # abort running tasks at batch boundaries.

    # how long a cancelled job id keeps riding PollWorkResult: every
    # executor polls multiple times within this window, so each sees
    # the cancel at least once even across a scheduler hiccup
    CANCEL_BROADCAST_SECS = 60.0

    def cancel_job(self, job_id: str, reason: str = "client") -> bool:
        """Move the job to terminal ``cancelled`` (idempotent: False
        when unknown or already terminal), drop its queued tasks, and
        start broadcasting the id to polling executors."""
        with self._lock:
            status = self.get_job_status(job_id)
            if status is None or status.state in ("completed", "failed",
                                                  "cancelled"):
                return False
            self._cancelled_jobs[job_id] = time.time()
            # queued tasks stop here; running ones abort executor-side
            self._ready = [p for p in self._ready if p.job_id != job_id]
            self.save_job_status(job_id, JobStatus(
                "cancelled", error=f"cancelled ({reason})",
                cancel_reason=reason,
            ))
        log.warning("cancelled job %s (%s)", job_id, reason)
        from ..observability.tracing import trace_event

        trace_event("lifecycle.cancel", job=job_id, reason=reason)
        return True

    def is_job_cancelled(self, job_id: str) -> bool:
        with self._lock:
            if job_id in self._cancelled_jobs:
                return True
        # a restarted scheduler loses the in-memory set but not the KV
        status = self.get_job_status(job_id)
        return status is not None and status.state == "cancelled"

    def cancelled_job_ids(self) -> List[str]:
        """Recently-cancelled job ids for the PollWorkResult piggyback
        (pruned past CANCEL_BROADCAST_SECS so the list stays bounded)."""
        now = time.time()
        with self._lock:
            stale = [j for j, t in self._cancelled_jobs.items()
                     if now - t > self.CANCEL_BROADCAST_SECS]
            for j in stale:
                del self._cancelled_jobs[j]
            return sorted(self._cancelled_jobs)

    def save_job_deadline(self, job_id: str, deadline_ts: float):
        """Absolute wall time after which reap_expired_jobs cancels the
        job (server-side: holds even when the client is gone)."""
        with self._lock:
            self._job_deadlines[job_id] = float(deadline_ts)

    def get_job_deadline(self, job_id: str) -> Optional[float]:
        with self._lock:
            return self._job_deadlines.get(job_id)

    def reap_expired_jobs(self, min_interval_secs: float = 1.0
                          ) -> List[str]:
        """Cancel jobs past their server-side deadline, and — when
        ``BALLISTA_SLOW_QUERY_KILL_SECS`` is set — jobs running longer
        than the kill threshold (upgrading the slow-query LOG to a
        kill). Runs from the PollWork reap pass, throttled. Returns the
        job ids it cancelled."""
        now = time.time()
        with self._lock:
            if now - self._last_deadline_scan < min_interval_secs:
                return []
            self._last_deadline_scan = now
            expired = [j for j, dl in self._job_deadlines.items()
                       if now > dl]
        touched = [j for j in expired if self.cancel_job(j, "deadline")]
        from ..observability.health import slow_query_kill_secs

        kill = slow_query_kill_secs()
        if kill is not None:
            overdue = [j for j, t0 in list(self._job_started.items())
                       if now - t0 >= kill]
            touched.extend(
                j for j in overdue
                if self.cancel_job(j, "slow-query-kill"))
        return touched

    # -- stages -------------------------------------------------------------

    def save_stage_plan(self, job_id: str, stage_id: int, plan_bytes: bytes,
                        num_partitions: int, dep_stage_ids: List[int],
                        shuffle_spec: "tuple | None" = None,
                        mesh_devices: int = 0, version: int = 0,
                        reader_layouts: "dict | None" = None):
        # shuffle_spec: (serialized hash expr bytes list | None, n_outputs)
        # mesh_devices: devices a task of this stage needs (mesh-fused
        # stages only; 0 = any executor can run it)
        # version / reader_layouts: adaptive re-planning state (StagePlan)
        self.kv.put(
            self._k("stages", job_id, stage_id),
            pickle.dumps(
                (plan_bytes, num_partitions, dep_stage_ids, shuffle_spec,
                 mesh_devices, version, reader_layouts)
            ),
        )
        with self._lock:
            self._stage_deps[(job_id, stage_id)] = list(dep_stage_ids)
            self._stage_parts[(job_id, stage_id)] = num_partitions
            self._stage_mesh[(job_id, stage_id)] = mesh_devices
            self._stage_versions[(job_id, stage_id)] = version

    def get_stage_plan(self, job_id: str, stage_id: int) -> StagePlan:
        v = self.kv.get(self._k("stages", job_id, stage_id))
        if v is None:
            raise ClusterError(f"no stage plan {job_id}/{stage_id}")
        return StagePlan(*_pad_stage_row(pickle.loads(v)))

    def update_stage_plan(self, job_id: str, stage_id: int,
                          plan_bytes: "bytes | None" = None,
                          num_partitions: "int | None" = None,
                          shuffle_spec: "tuple | None | str" = "keep",
                          reader_layouts: "dict | None" = None) -> int:
        """Adaptive re-plan of a NOT-YET-RUN stage: rewrite the stored
        row, bump its version, and rebuild its (pending) task rows for
        the new partition count. Returns the new version. Caller must
        have verified no task of the stage has started; the version
        bump protects against the narrow dispatch race that remains
        (see accept_report_version)."""
        with self._lock:
            row = self.get_stage_plan(job_id, stage_id)
            version = row.version + 1
            new_spec = row.shuffle_spec if shuffle_spec == "keep" \
                else shuffle_spec
            self.save_stage_plan(
                job_id, stage_id,
                plan_bytes if plan_bytes is not None else row.plan_bytes,
                num_partitions if num_partitions is not None
                else row.num_partitions,
                row.deps, new_spec, row.mesh_devices, version,
                reader_layouts if reader_layouts is not None
                else row.reader_layouts,
            )
            # task rows: drop every old row (the count may shrink) and
            # recreate the new set pending
            for t in self.get_task_statuses(job_id, stage_id):
                self.kv.delete(
                    self._k("tasks", job_id, stage_id,
                            t.partition.partition_id)
                )
            n = num_partitions if num_partitions is not None \
                else row.num_partitions
            for p in range(n):
                self.save_task_status(
                    TaskStatus(PartitionId(job_id, stage_id, p))
                )
            # purge stale ready-queue entries (old partition ids), then
            # re-seed if the stage is already unblocked
            self._ready = [
                p for p in self._ready
                if not (p.job_id == job_id and p.stage_id == stage_id)
            ]
            deps = self._stage_deps.get((job_id, stage_id), [])
            if all(self._stage_complete(job_id, d) for d in deps):
                self._enqueue_stage(job_id, stage_id)
            return version

    def stage_version(self, job_id: str, stage_id: int) -> int:
        with self._lock:
            return self._stage_versions.get((job_id, stage_id), 0)

    def accept_report_version(self, st: TaskStatus) -> bool:
        """False when the report comes from a superseded stage version
        (the executor ran a task cut before an adaptive re-plan): the
        caller must drop it. A current-version twin may be stranded in
        "running" by the dispatch race — reset + re-queue it so the
        stage cannot hang."""
        pid = st.partition
        key = (pid.job_id, pid.stage_id)
        with self._lock:
            cur = self._stage_versions.get(key, 0)
            if (st.stage_version or 0) == cur:
                return True
            n = self._stage_parts.get(key, 0)
            if pid.partition_id < n and not self.is_completed(pid):
                prior = next(
                    (t for t in self.get_task_statuses(pid.job_id,
                                                       pid.stage_id)
                     if t.partition.partition_id == pid.partition_id),
                    None,
                )
                # reset only a row STRANDED at a superseded version (the
                # dispatch race); a running row already at the current
                # version is a healthy re-dispatched copy — resetting it
                # would spawn a redundant third execution
                if prior is not None and prior.state == "running" and \
                        (getattr(prior, "stage_version", 0) or 0) != cur:
                    self._reset_task(pid)
                    deps = self._stage_deps.get(key, [])
                    if all(self._stage_complete(pid.job_id, d)
                           for d in deps):
                        self._enqueue_stage(pid.job_id, pid.stage_id)
            log.info("dropping stale v%d report for %s (stage now v%d)",
                     st.stage_version or 0, pid.key(), cur)
            return False

    def stage_started(self, job_id: str, stage_id: int) -> bool:
        """True when any task of the stage has been dispatched (or
        finished): adaptive re-planning must leave such stages alone."""
        return any(t.state is not None
                   for t in self.get_task_statuses(job_id, stage_id))

    def shuffle_partition_histogram(self, job_id: str, stage_id: int):
        """Observed shuffle output of a COMPLETED hash/round-robin
        shuffle stage: ``(bytes_per_output, per_producer)`` where
        ``per_producer[q][p]`` is the bytes producer task p wrote for
        output partition q. None when the stage is not a shuffle, is
        incomplete, or its tasks predate the histogram field."""
        row = self.get_stage_plan(job_id, stage_id)
        if row.shuffle_spec is None:
            return None
        n_out = row.shuffle_spec[1]
        done = [t for t in self.get_task_statuses(job_id, stage_id)
                if t.state == "completed"]
        if len(done) < row.num_partitions:
            return None
        per = [[0] * row.num_partitions for _ in range(n_out)]
        for t in done:
            h = (t.stats or {}).get("shuffle_partition_bytes")
            if not h or len(h) != n_out:
                return None
            p = t.partition.partition_id
            for q in range(n_out):
                per[q][p] = int(h[q])
        return [sum(per[q]) for q in range(n_out)], per

    def stage_output_bytes(self, job_id: str, stage_id: int
                           ) -> Optional[int]:
        """Total bytes a completed stage materialized (all tasks), or
        None while incomplete — the join-demotion size signal."""
        row = self.get_stage_plan(job_id, stage_id)
        done = [t for t in self.get_task_statuses(job_id, stage_id)
                if t.state == "completed"]
        if len(done) < row.num_partitions:
            return None
        return sum(int((t.stats or {}).get("num_bytes", 0)) for t in done)

    def stage_consumers(self, job_id: str, stage_id: int) -> List[int]:
        """Stage ids that list ``stage_id`` as a dependency."""
        with self._lock:
            return [sid for (j, sid), deps in self._stage_deps.items()
                    if j == job_id and stage_id in deps]

    def stage_ids(self, job_id: str) -> List[int]:
        prefix = self._k("stages", job_id) + "/"
        return sorted(
            int(k[len(prefix):]) for k, _ in self.kv.get_from_prefix(prefix)
        )

    # -- tasks --------------------------------------------------------------

    def save_task_status(self, st: TaskStatus):
        fault_point("state.save", task=st.partition.key())
        self.kv.put(
            self._k("tasks", st.partition.job_id, st.partition.stage_id,
                    st.partition.partition_id),
            pickle.dumps(st),
        )

    def get_task_statuses(self, job_id: str,
                          stage_id: Optional[int] = None) -> List[TaskStatus]:
        # trailing '/' so stage 1 doesn't prefix-match stages 10..19
        prefix = (
            self._k("tasks", job_id, stage_id) + "/"
            if stage_id is not None
            else self._k("tasks", job_id) + "/"
        )
        return [pickle.loads(v) for _, v in self.kv.get_from_prefix(prefix)]

    # -- scheduling ---------------------------------------------------------

    def enqueue_job(self, job_id: str):
        """Called once stage plans + empty task rows are persisted: seed the
        ready-queue with every stage that has no pending dependencies."""
        with self._lock:
            for sid in self.stage_ids(job_id):
                deps = self._stage_deps.get((job_id, sid), [])
                if not deps:
                    self._enqueue_stage(job_id, sid)

    def _enqueue_stage(self, job_id: str, stage_id: int):
        """Enqueue the stage's PENDING tasks (state None) that are not
        already queued — idempotent, so recovery can re-trigger it after
        resetting lost tasks without double-running live ones. A
        cancelled job enqueues nothing (recovery/completion paths may
        still fire for late reports)."""
        if job_id in self._cancelled_jobs:
            return
        n = self._stage_parts[(job_id, stage_id)]
        started = {
            t.partition.partition_id
            for t in self.get_task_statuses(job_id, stage_id)
            if t.state is not None
        }
        queued = {
            p.partition_id for p in self._ready
            if p.job_id == job_id and p.stage_id == stage_id
        }
        for p in range(n):
            if p not in started and p not in queued:
                self._ready.append(PartitionId(job_id, stage_id, p))

    def ready_queue_depth(self) -> int:
        with self._lock:
            return len(self._ready)

    def next_task(self, num_devices: int = 0) -> Optional[PartitionId]:
        """Pop the first ready task the calling executor can run: a
        mesh-fused stage's tasks only go to executors reporting at least
        that many devices (0 = caller capacity unknown, accept any)."""
        with self._lock:
            # purge tasks of cancelled jobs first: a stage completion
            # racing the cancel may have re-enqueued some
            if self._cancelled_jobs:
                self._ready = [p for p in self._ready
                               if p.job_id not in self._cancelled_jobs]
            for i, pid in enumerate(self._ready):
                need = self._stage_mesh.get((pid.job_id, pid.stage_id), 0)
                if need and num_devices and num_devices < need:
                    continue
                return self._ready.pop(i)
        return None

    def is_completed(self, pid: PartitionId) -> bool:
        v = self.kv.get(self._k("tasks", pid.job_id, pid.stage_id,
                                pid.partition_id))
        return v is not None and pickle.loads(v).state == "completed"

    def task_completed(self, st: TaskStatus):
        """Record completion; if a whole stage just completed, unlock its
        dependents (event-driven, replacing the reference's full scan).
        First result wins: when speculation duplicated the task, the
        second completion report is dropped so consumers keep fetching
        from the location already recorded."""
        job_id = st.partition.job_id
        stage_id = st.partition.stage_id
        with self._lock:
            prior = next(
                (t for t in self.get_task_statuses(job_id, stage_id)
                 if t.partition.partition_id == st.partition.partition_id),
                None,
            )
            if prior is not None and prior.state == "completed":
                return  # a duplicate (speculative) completion lost the race
            self.save_task_status(st)
            stage_tasks = self.get_task_statuses(job_id, stage_id)
            n = self._stage_parts.get((job_id, stage_id))
            done = [t for t in stage_tasks if t.state == "completed"]
            if n is None or len(done) < n:
                return
            # stage complete: enqueue dependents whose deps are all complete
            # (_enqueue_stage only picks up still-pending tasks, so this is
            # safe to re-trigger after recovery resets)
            ready, blocked = [], []
            for (j, sid), deps in list(self._stage_deps.items()):
                if j != job_id or stage_id not in deps:
                    continue
                if all(self._stage_complete(j, d) for d in deps):
                    ready.append(sid)
                else:
                    blocked.append(sid)
            if self.replan_hook is not None and (ready or blocked):
                # adaptive re-planning window: dependents' plans may be
                # rewritten from the completed stage's observed metrics
                # BEFORE any of their tasks is enqueued. Best-effort: a
                # re-plan failure must never take the job down with it —
                # the static plan is always a correct fallback.
                try:
                    self.replan_hook(self, job_id, stage_id, ready, blocked)
                except Exception:  # noqa: BLE001 - keep static plan
                    log.exception(
                        "adaptive re-plan failed for job %s after stage "
                        "%d; continuing with the static plan",
                        job_id, stage_id,
                    )
            for sid in ready:
                self._enqueue_stage(job_id, sid)

    def _stage_complete(self, job_id: str, stage_id: int) -> bool:
        n = self._stage_parts.get((job_id, stage_id), 0)
        done = [
            t for t in self.get_task_statuses(job_id, stage_id)
            if t.state == "completed"
        ]
        return len(done) >= n

    def stage_locations(self, job_id: str, stages=None
                        ) -> Dict[int, List[PartitionLocation]]:
        """Completed-task locations per stage (for shuffle resolution).
        `stages` restricts the scan so an unroutable, already-consumed
        stage elsewhere in the job can't fail an unrelated resolution."""
        out: Dict[int, List[PartitionLocation]] = {}
        executors = {e.id: e for e in self.get_executors_metadata()}
        for t in self.get_task_statuses(job_id):
            if t.state != "completed":
                continue
            if stages is not None and t.partition.stage_id not in stages:
                continue
            e = executors.get(t.executor_id)
            if e is None and t.executor_id:
                # lease expired: fall back to the durable address record —
                # the data may still be served; if not, the consumer fails
                # with a tagged ShuffleFetchError and recovery re-queues
                # the producer
                e = self.executor_address(t.executor_id)
            if e is None:
                # no route to the data at all: fail resolution with the
                # tagged error NOW so the caller triggers producer
                # recovery, instead of emitting host="",port=0 for a
                # consumer to trip over
                from ..errors import ShuffleFetchError

                raise ShuffleFetchError(
                    t.partition.stage_id, [t.partition.partition_id],
                    t.executor_id or "",
                    "completed task has no routable executor address",
                )
            host, port = e.host, e.port
            out.setdefault(t.partition.stage_id, []).append(
                PartitionLocation(
                    job_id=t.partition.job_id,
                    stage_id=t.partition.stage_id,
                    partition_id=t.partition.partition_id,
                    executor_id=t.executor_id or "",
                    host=host,
                    port=port,
                    path=t.path or "",
                    stats=t.stats,
                )
            )
        return out

    # -- failure recovery ----------------------------------------------------
    # The reference detects failures but never recovers (any failed task
    # fails the job, state/mod.rs:342-346; lost shuffle data hangs or
    # errors). We re-queue lost producer partitions on tagged fetch
    # failures and re-queue running tasks of dead executors, with a
    # per-job retry cap.

    DEFAULT_MAX_RECOVERIES = 3

    @property
    def MAX_RECOVERIES_PER_JOB(self) -> int:
        """``BALLISTA_MAX_TASK_RECOVERIES`` (default 3): recovery
        EVENTS allowed per job across all recovery paths (transient
        retry, fetch recovery, lease reap) before the job fails with
        the underlying error. Read per use so the chaos sweep and
        operators can tune the budget without restarting."""
        try:
            return max(int(os.environ.get(
                "BALLISTA_MAX_TASK_RECOVERIES", "")
                or self.DEFAULT_MAX_RECOVERIES), 0)
        except ValueError:
            return self.DEFAULT_MAX_RECOVERIES

    def _recovery_count(self, job_id: str) -> int:
        v = self.kv.get(self._k("recoveries", job_id))
        return int(v) if v else 0

    def _bump_recovery(self, job_id: str) -> int:
        n = self._recovery_count(job_id) + 1
        self.kv.put(self._k("recoveries", job_id), str(n).encode())
        return n

    def _reset_task(self, pid: PartitionId):
        self.save_task_status(TaskStatus(pid))

    def recover_fetch_failure(self, st: TaskStatus) -> bool:
        """Attempt recovery from a consumer task that failed with a tagged
        ShuffleFetchError: reset the lost producer partitions and the
        consumer task to pending and re-queue the producers. Returns True
        if recovery was initiated (caller must NOT record the failure)."""
        from ..errors import ShuffleFetchError

        parsed = ShuffleFetchError.parse(st.error or "")
        if parsed is None:
            return False
        job_id = st.partition.job_id
        dep_stage, lost_parts, _executor = parsed
        with self._lock:
            known = self._stage_parts.get((job_id, dep_stage))
            if known is None:
                return False
            # concurrent consumers failing on the SAME lost producer join
            # the in-flight recovery instead of burning retry budget
            statuses = {
                t.partition.partition_id: t.state
                for t in self.get_task_statuses(job_id, dep_stage)
            }
            fresh = [
                p for p in lost_parts
                if 0 <= p < known and statuses.get(p) == "completed"
            ]
            if fresh and self._bump_recovery(job_id) > \
                    self.MAX_RECOVERIES_PER_JOB:
                return False
            for p in fresh:
                self._reset_task(PartitionId(job_id, dep_stage, p))
            self._reset_task(st.partition)
            # queued tasks of stages depending on the now-incomplete
            # producer would fail location resolution — pull them out;
            # stage re-completion re-enqueues them
            consumers = {
                sid for (j, sid), deps in self._stage_deps.items()
                if j == job_id and dep_stage in deps
            }
            self._ready = [
                p for p in self._ready
                if not (p.job_id == job_id and p.stage_id in consumers)
            ]
            self._enqueue_stage(job_id, dep_stage)
        return True

    # error-class prefixes considered transient (executor tags failures
    # with the exception class name); deterministic failures — plan bugs,
    # capacity limits — fail fast like the reference
    TRANSIENT_ERRORS = ("IoError:", "OSError:", "ConnectionError:",
                        "ConnectionResetError:", "ConnectionRefusedError:",
                        "TimeoutError:", "BrokenPipeError:",
                        # injected faults deliberately look transient so
                        # the chaos sweep exercises the retry budget
                        "FaultInjected:",
                        # a DRAINING executor cancels its in-flight
                        # tasks; the job is still live — re-queue them
                        # (job-cancel reports never reach here: PollWork
                        # drops reports for cancelled jobs)
                        "QueryCancelled:")

    def recover_transient_failure(self, st: TaskStatus) -> bool:
        """Re-queue a task that failed with an IO-shaped (transient)
        error, within the job's recovery budget. The reference fails the
        whole job on ANY task failure (state/mod.rs:342-346)."""
        err = st.error or ""
        if not err.startswith(self.TRANSIENT_ERRORS):
            return False
        with self._lock:
            if (st.partition.job_id, st.partition.stage_id) not in \
                    self._stage_parts:
                return False
            if self._bump_recovery(st.partition.job_id) > \
                    self.MAX_RECOVERIES_PER_JOB:
                return False
            self._reset_task(st.partition)
            self._enqueue_stage(st.partition.job_id, st.partition.stage_id)
        return True

    SPECULATION_SCAN_INTERVAL_SECS = 5.0

    def speculative_task(self, num_devices: int = 0,
                         age_secs: float = 60.0,
                         executor_id: str = "",
                         min_interval_secs: Optional[float] = None,
                         lag_fn=None) -> Optional[PartitionId]:
        """Straggler mitigation the reference lacks entirely: when an
        executor is idle and nothing is ready, hand out a DUPLICATE of a
        long-running task (first completion wins — task_completed drops
        later reports, so the recorded completion's location is
        self-consistent). Each task is duplicated at most once, never on
        the executor already running it (a duplicate on the same executor
        would race the original on the same work_dir path), and fruitless
        full-task scans are throttled like reap_lost_tasks (a successful
        scan doesn't delay the next one — only the idle-poll storm with
        nothing to speculate is capped).

        ``lag_fn(task_status) -> bool | None`` is the RATE-based
        trigger (the scheduler wires the progress tracker's
        ``is_lagging`` here): True = the task's observed rate trails
        its stage median by ``BALLISTA_SPECULATION_LAG_FACTOR`` —
        duplicate it regardless of age; False = the task is measurably
        healthy — do NOT duplicate it even past the age threshold;
        None = no samples — fall back to the wall-clock age trigger."""
        if min_interval_secs is None:
            min_interval_secs = self.SPECULATION_SCAN_INTERVAL_SECS
        now = time.time()
        with self._lock:
            if now - self._last_spec_scan < min_interval_secs:
                return None
            # stamp BEFORE scanning (atomic check-and-set like
            # reap_lost_tasks) so concurrent idle polls can't all start
            # full scans; cleared again if this scan finds a candidate
            self._last_spec_scan = now
        for k, v in self.kv.get_from_prefix(self._k("jobs")):
            if pickle.loads(v).state not in ("queued", "running"):
                continue
            job_id = k.rsplit("/", 1)[1]
            with self._lock:
                for t in self.get_task_statuses(job_id):
                    key = t.partition
                    if (t.state == "running" and t.started_at
                            and key not in self._speculated
                            and t.executor_id != executor_id):
                        lagging = None
                        if lag_fn is not None:
                            try:
                                lagging = lag_fn(t)
                            except Exception:  # noqa: BLE001 - advisory
                                lagging = None
                        if lagging is None:
                            # no rate samples: the old age trigger
                            if now - t.started_at <= age_secs:
                                continue
                        elif not lagging:
                            continue
                        need = self._stage_mesh.get(
                            (job_id, t.partition.stage_id), 0)
                        if need and num_devices and num_devices < need:
                            continue
                        self._speculated.add(key)
                        # a successful scan doesn't delay the next one
                        self._last_spec_scan = 0.0
                        return t.partition
        return None

    def absorb_speculative_failure(self, pid: PartitionId) -> bool:
        """A task with an in-flight speculative duplicate reported a
        failure while its twin may still be running: absorb the FIRST
        such failure (return True — the caller must not record it or
        trigger recovery); the second failure means both copies died and
        flows through the normal failure path."""
        with self._lock:
            if pid not in self._speculated or self.is_completed(pid):
                return False
            if pid in self._spec_failed_once:
                return False
            self._spec_failed_once.add(pid)
            return True

    def reap_lost_tasks(self, min_interval_secs: float = 5.0) -> List[str]:
        """Re-queue running tasks whose executor's lease has expired (the
        executor died mid-task; its completion report will never arrive).
        One executor-death event costs ONE unit of the job's recovery
        budget regardless of how many of its tasks were in flight.
        Throttled; returns the job ids it touched so the caller can
        re-synthesize their status (budget exhaustion marks tasks failed,
        and nothing else would ever surface that to the client)."""
        now = time.time()
        with self._lock:
            if now - getattr(self, "_last_reap", 0.0) < min_interval_secs:
                return []
            self._last_reap = now
        live = self.live_executor_ids()
        touched: List[str] = []
        for k, v in self.kv.get_from_prefix(self._k("jobs")):
            status = pickle.loads(v)
            if status.state not in ("queued", "running"):
                continue
            job_id = k.rsplit("/", 1)[1]
            with self._lock:
                lost = [
                    t for t in self.get_task_statuses(job_id)
                    if t.state == "running" and t.executor_id
                    and t.executor_id not in live
                ]
                if not lost:
                    continue
                touched.append(job_id)
                if self._bump_recovery(job_id) > self.MAX_RECOVERIES_PER_JOB:
                    for t in lost:
                        self.save_task_status(TaskStatus(
                            t.partition, "failed",
                            error=f"executor {t.executor_id} lost and "
                                  "retry budget exhausted",
                        ))
                    continue
                for t in lost:
                    self._reset_task(t.partition)
                for sid in {t.partition.stage_id for t in lost}:
                    self._enqueue_stage(job_id, sid)
        return touched

    # -- job status synthesis (reference: state/mod.rs:267-358) --------------

    def synchronize_job_status(self, job_id: str):
        status = self.get_job_status(job_id)
        if status is None or status.state in ("completed", "failed",
                                              "cancelled"):
            return
        if self.is_job_cancelled(job_id):
            return  # cancel marked but terminal save still in flight
        tasks = self.get_task_statuses(job_id)
        if not tasks:
            return
        if any(t.state == "failed" for t in tasks):
            err = next(t.error for t in tasks if t.state == "failed")
            self.save_job_status(job_id, JobStatus("failed", error=err))
            return
        final_sid = max(self.stage_ids(job_id))
        final_tasks = [t for t in tasks if t.partition.stage_id == final_sid]
        n = self._stage_parts.get((job_id, final_sid), len(final_tasks))
        done = [t for t in final_tasks if t.state == "completed"]
        if final_tasks and len(done) >= n:
            from ..errors import ShuffleFetchError

            try:
                locs = self.stage_locations(
                    job_id, stages={final_sid}
                ).get(final_sid, [])
            except ShuffleFetchError as e:
                # a completed result partition lost its executor before the
                # client fetched it — re-queue the producer (within budget)
                # rather than publishing an unroutable location
                if not self.recover_fetch_failure(
                    TaskStatus(
                        PartitionId(job_id, final_sid, e.partition_ids[0]),
                        "failed", error=str(e),
                    )
                ):
                    self.save_job_status(
                        job_id, JobStatus("failed", error=str(e))
                    )
                return
            self.save_job_status(
                job_id,
                JobStatus("completed", partition_locations=locs,
                          stage_metrics=self._aggregate_stage_metrics(tasks)),
            )
        elif any(t.state is not None for t in tasks):
            self.save_job_status(job_id, JobStatus("running"))

    def _aggregate_stage_metrics(self, tasks) -> Dict[int, dict]:
        """Merge completed tasks' per-operator metrics per stage (tasks of
        one stage share a plan shape, so operator rows align
        positionally). Returned with the completed JobStatus so the
        client's ``ctx.last_query_metrics()`` gets a per-stage breakdown
        without extra RPCs."""
        from ..observability.metrics import merge_operator_metrics

        by_stage: Dict[int, List] = {}
        for t in tasks:
            tm = getattr(t, "metrics", None)
            if t.state == "completed" and tm:
                by_stage.setdefault(t.partition.stage_id, []).append(tm)
        out: Dict[int, dict] = {}
        for sid, tms in by_stage.items():
            out[sid] = {
                "num_tasks": len(tms),
                "elapsed_total": sum(tm.get("elapsed_total", 0.0)
                                     for tm in tms),
                "operators": merge_operator_metrics(
                    tm.get("operators") or [] for tm in tms),
            }
        return out
