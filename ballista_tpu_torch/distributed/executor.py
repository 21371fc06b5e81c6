"""Executor: pull-based worker running stage tasks on the local device(s).

The port of the JAX package's ``distributed/executor.py``. An executor
runs its tasks on one torch device (``ExecutorConfig.device``, "cuda" by
default; "cpu" only when asked): every task plan is deserialized onto
it. The streaming writes a task ends with (``write_partition``,
``write_shuffled``) are module functions, shared with the test harness
``testing/stages.py``. An executor reporting ``num_devices`` n >= 2 runs
mesh-fused tasks (``physical/mesh_agg.py``) over n slots on its device;
one fronting a multi-process mesh group (``mesh_group``) broadcasts them
to the group's other processes first.

Re-implements the reference executor (reference: rust/executor/src/
execution_loop.rs:31-160 poll loop, flight_service.rs:89-192 partition
execution + IPC materialization, main.rs --local embedded-scheduler mode).
Improvements over the reference by design:

- tasks execute in-process (the reference self-RPCs its own Flight port,
  execution_loop.rs:90-101, and calls that "convoluted" itself);
- the data plane is a socket server (Python or the C++ native
  shuffle_server) serving the same work_dir layout.
"""

from __future__ import annotations

import logging
import os
import random
import shutil
import tempfile
import threading
import time
import uuid
from collections import deque
from concurrent import futures
from typing import Dict, Optional

from ..errors import QueryCancelled
from ..lifecycle import CancelToken, bind_token, check_cancel
from ..observability import trace_span
from ..observability.metrics import collect_plan_metrics, metrics_enabled
from ..proto import ballista_pb2 as pb
from .. import serde
from ..testing.faults import fault_point
from .dataplane import partition_path, start_data_plane
from .scheduler import SchedulerClient
from .types import PartitionId

log = logging.getLogger("ballista.executor")

POLL_INTERVAL_SECS = 0.25  # reference: 250ms, execution_loop.rs:41
# total task-profile bytes one PollWork may carry (well under the
# transport's raised 64 MB cap; see scheduler._GRPC_MSG_OPTS)
_POLL_PROFILE_BUDGET_BYTES = 8 << 20


def _poll_backoff_max_secs() -> float:
    """Poll-loop backoff ceiling while the scheduler is unreachable."""
    try:
        return max(float(os.environ.get(
            "BALLISTA_POLL_BACKOFF_MAX_SECS", "8") or 8), POLL_INTERVAL_SECS)
    except ValueError:
        return 8.0


def drain_timeout_secs() -> float:
    """``BALLISTA_DRAIN_TIMEOUT_SECS``: how long a graceful drain lets
    in-flight tasks finish before cancelling them."""
    try:
        return max(float(os.environ.get(
            "BALLISTA_DRAIN_TIMEOUT_SECS", "20") or 20), 0.0)
    except ValueError:
        return 20.0


def _needs_mesh(plan) -> bool:
    """True when the plan contains a mesh-fused operator (its program
    must run on every process of a mesh group)."""
    from ..physical.mesh_agg import MeshAggExec, MeshJoinExec

    if isinstance(plan, (MeshAggExec, MeshJoinExec)):
        return True
    return any(_needs_mesh(c) for c in plan.children())


class ExecutorConfig:
    """(reference: executor_config_spec.toml:1-61)"""

    def __init__(self, host: str = "localhost", port: int = 0,
                 work_dir: Optional[str] = None, concurrent_tasks: int = 2,
                 scheduler_host: str = "localhost",
                 scheduler_port: int = 50050,
                 bind_host: Optional[str] = None,
                 num_devices: int = 1,
                 native_dataplane: Optional[bool] = None,
                 metrics_port: Optional[int] = None,
                 device="cuda"):
        from ..client import _resolve_device

        # the torch device every task of this executor runs on; "cuda"
        # raises here when there is no card (no quiet CPU fallback)
        self.device = _resolve_device(device)
        # host = the address peers should dial (advertised in PollWork);
        # bind_host = the local interface the data plane listens on.
        # Distinct so NAT/port-forward setups can bind 0.0.0.0 while
        # advertising an external address.
        self.host = host
        self.bind_host = bind_host if bind_host is not None else host
        # None = resolve from BALLISTA_NATIVE_DATAPLANE (default: native)
        self.native_dataplane = native_dataplane
        self.port = port
        # mesh slots this executor owns on ``device`` (reported in
        # PollWork metadata; mesh fusion is driven by these fleet reports
        # — a client mesh.devices setting is only validated against them)
        self.num_devices = num_devices
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="ballista-")
        self.concurrent_tasks = concurrent_tasks
        self.scheduler_host = scheduler_host
        self.scheduler_port = scheduler_port
        # health plane port: None = resolve BALLISTA_METRICS_PORT
        # (default off for in-process executors; the binary defaults it
        # to 0 = ephemeral ON); < 0 disables
        self.metrics_port = metrics_port


class Executor:
    def __init__(self, config: ExecutorConfig, mesh_group=None):
        self.config = config
        # mesh_group: a mesh_group.GroupLeader when this executor fronts
        # a multi-process mesh; fused tasks are broadcast so every member
        # enters the same program
        self.mesh_group = mesh_group
        self.id = str(uuid.uuid4())
        # distributed profiler: stamp this process's identity onto every
        # trace/flight-recorder record (first writer wins — harmless for
        # in-process LocalClusters, where per-task window extraction
        # re-tags records with the owning executor's id instead)
        from ..observability.tracing import set_process_identity

        set_process_identity("executor", self.id)
        self._data_plane = start_data_plane(
            config.bind_host, config.port, config.work_dir,
            native=config.native_dataplane,
        )
        self.port = self._data_plane.port
        self._client = SchedulerClient(config.scheduler_host,
                                       config.scheduler_port)
        self._pool = futures.ThreadPoolExecutor(
            max_workers=config.concurrent_tasks
        )
        self._slots = threading.Semaphore(config.concurrent_tasks)
        self._status_lock = threading.Lock()
        self._pending_status = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # lifecycle control plane: one cancel token per active task
        # (registered BEFORE the pool accepts the work so drain sees
        # queued-but-unstarted tasks too), the draining flag PollWork
        # advertises as can_accept_task=False, and a bounded memory of
        # job ids whose partial outputs were already cleaned
        self._token_lock = threading.Lock()
        self._task_tokens: Dict[str, CancelToken] = {}  # task key -> token
        self._draining = False
        self._cleaned_jobs: deque = deque(maxlen=256)
        # live progress plane: the executing plan of every in-flight
        # task, sampled on the progress cadence and piggybacked on
        # PollWork as TaskProgress records (best-effort; see
        # observability/progress.py)
        self._progress_lock = threading.Lock()
        self._running_plans: Dict[str, dict] = {}  # task key -> entry
        self._last_progress_sample = 0.0
        # health plane: task counters (benign-race ints under the GIL,
        # same policy as observability.metrics), a ring of recent task
        # summaries, and — when enabled — /healthz + /metrics +
        # /debug/queries on a local stdlib HTTP server
        self._inflight = 0
        self.tasks_completed = 0
        self.tasks_failed = 0
        self.tasks_cancelled = 0
        from ..observability.health import (QueryLog,
                                            maybe_start_health_server,
                                            metrics_port_from_env)

        self._query_log = QueryLog()
        mport = config.metrics_port
        if mport is None:
            mport = metrics_port_from_env(-1)
        self._health = maybe_start_health_server(
            "executor", mport, samples_fn=self._metric_samples,
            query_log=self._query_log,
        )

    @property
    def health_port(self) -> Optional[int]:
        return self._health.port if self._health is not None else None

    def resource_gauges(self) -> dict:
        """Current resource gauges: shipped with every heartbeat and
        exported on the local /metrics."""
        from ..ingest import pool_queue_depth
        from ..observability import memory as obs_memory
        from . import spill as _spill

        gov = _spill.governor().stats()
        return {
            "rss_bytes": obs_memory.rss_bytes(),
            "device_bytes": obs_memory.device_bytes(
                device=self.config.device),
            # clamped: the counter is a benign-race int (same policy as
            # the task counters), but a lost update must never drive a
            # negative into the uint32 proto field — that would make
            # every subsequent heartbeat raise and starve the executor
            "inflight_tasks": max(0, self._inflight),
            "ingest_pool_depth": pool_queue_depth(),
            "peak_host_bytes": obs_memory.peak_host_bytes(),
            # shuffle memory governor: in-flight buffer bytes + bytes
            # spilled to disk, so the scheduler sees memory pressure
            # per executor
            "shuffle_inflight_bytes": gov["inflight_bytes"],
            "spill_bytes_total": gov["spilled_bytes_total"],
        }

    def _metric_samples(self):
        # only the executor-specific gauges: rss/device/peak are
        # appended by the health server's base process samples — going
        # through resource_gauges() here would sample them twice per
        # scrape
        from ..ingest import pool_queue_depth

        return [
            ("ballista_inflight_tasks", {}, max(0, self._inflight)),
            ("ballista_ingest_pool_depth", {}, pool_queue_depth()),
            ("ballista_tasks_completed_total", {}, self.tasks_completed),
            ("ballista_tasks_failed_total", {}, self.tasks_failed),
            ("ballista_tasks_cancelled_total", {}, self.tasks_cancelled),
        ]

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._poll_loop, daemon=True, name=f"poll-{self.id[:8]}"
        )
        self._thread.start()

    def stop(self, drain: bool = False,
             drain_timeout: Optional[float] = None):
        """Stop the executor. ``drain=False`` (default) keeps the old
        immediate-shutdown behavior: running tasks are abandoned
        mid-flight. ``drain=True`` is the graceful path: stop accepting
        (PollWork advertises ``can_accept_task=False``), give in-flight
        tasks up to the drain bound to finish, cancel whatever is still
        running (their failure reports are transient-shaped, so the
        scheduler re-queues them elsewhere), and flush
        ``_pending_status`` in one final poll so completion reports are
        never lost."""
        if drain:
            self._drain(drain_timeout)
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if drain:
            # final flush AFTER the poll thread stopped: whatever
            # reports the last in-flight tasks appended still reach the
            # scheduler even though no more polls will run
            try:
                self._flush_status()
            except Exception:  # noqa: BLE001 - best-effort on shutdown
                log.warning("final status flush failed", exc_info=True)
        self._data_plane.close()
        self._pool.shutdown(wait=False)
        # release device-resident table-cache pins: a stopped executor
        # must not keep device memory pinned while the process lingers
        # (embedding tests / LocalCluster reuse the same process)
        try:
            from ..cache.residency import process_table_cache

            process_table_cache().invalidate()
        except Exception:  # noqa: BLE001 - best-effort on shutdown
            pass
        if self._health is not None:
            self._health.close()

    def _drain(self, drain_timeout: Optional[float]):
        bound = (drain_timeout if drain_timeout is not None
                 else drain_timeout_secs())
        self._draining = True
        deadline = time.time() + bound
        log.info("draining executor %s: %d active task(s), bound %.1fs",
                 self.id[:8], len(self._task_tokens), bound)
        while time.time() < deadline and self._task_tokens:
            time.sleep(0.05)
        leftover = self._fire_tokens(reason="drain")
        if leftover:
            log.warning("drain bound hit; cancelled %d in-flight task(s)",
                        leftover)
            # cooperative aborts land at the next batch boundary; give
            # them a short grace so their failure reports make the
            # final flush
            grace = time.time() + 5.0
            while time.time() < grace and self._task_tokens:
                time.sleep(0.05)

    def _fire_tokens(self, reason: str,
                     job_id: Optional[str] = None) -> int:
        """Fire the cancel tokens of active tasks (all, or one job's);
        returns how many were fired."""
        with self._token_lock:
            tokens = [t for t in self._task_tokens.values()
                      if job_id is None or t.job_id == job_id]
        n = 0
        for t in tokens:
            if t.cancel(reason):
                n += 1
        return n

    def _flush_status(self):
        """One synchronous PollWork carrying only pending reports (no
        task request): the drain path's last word to the scheduler."""
        with self._status_lock:
            pending = list(self._pending_status)
            self._pending_status.clear()
        if not pending:
            return
        params = pb.PollWorkParams(can_accept_task=False)
        params.metadata.id = self.id
        params.metadata.host = self.config.host
        params.metadata.port = self.port
        params.metadata.num_devices = self.config.num_devices
        for st in pending:
            # profiles are advisory payload; the final flush is about
            # never losing the REPORTS
            if st.HasField("completed") and st.completed.HasField("profile"):
                st.completed.ClearField("profile")
            params.task_status.append(st)
        self._client.PollWork(params)

    # -- poll loop (reference: execution_loop.rs:31-76) ----------------------

    def _poll_loop(self):
        failures = 0
        backoff = 0.0
        while not self._stop.is_set():
            try:
                self._poll_once()
            except Exception as e:  # noqa: BLE001 - retry like reference
                # jittered exponential backoff (reset on success): a
                # scheduler restart must not face a thundering herd of
                # fixed-interval retries, and a down scheduler must not
                # fill the log with one traceback per 250ms
                failures += 1
                backoff = min(max(backoff * 2, POLL_INTERVAL_SECS),
                              _poll_backoff_max_secs())
                wait = backoff * (1.0 + 0.25 * random.random())
                if failures == 1:
                    log.exception("poll failed; backing off")
                else:
                    log.warning(
                        "poll still failing (%d consecutive; %s: %s); "
                        "next retry in %.2fs", failures,
                        type(e).__name__, e, wait)
                self._stop.wait(wait)
                continue
            if failures:
                log.info("scheduler reachable again after %d failed "
                         "poll(s)", failures)
            failures = 0
            backoff = 0.0
            self._stop.wait(POLL_INTERVAL_SECS)

    def _poll_once(self):
        can_accept = self._slots.acquire(blocking=False)
        if can_accept:
            self._slots.release()
        if self._draining:
            # graceful drain: finish what's in flight, accept nothing new
            can_accept = False
        params = pb.PollWorkParams(can_accept_task=can_accept)
        params.metadata.id = self.id
        params.metadata.host = self.config.host
        params.metadata.port = self.port
        params.metadata.num_devices = self.config.num_devices
        # heartbeat resource gauges: the scheduler aggregates these
        # into its own /metrics (per-executor labels)
        g = self.resource_gauges()
        params.metadata.resources.rss_bytes = int(g["rss_bytes"])
        params.metadata.resources.device_bytes = int(g["device_bytes"])
        params.metadata.resources.inflight_tasks = int(g["inflight_tasks"])
        params.metadata.resources.ingest_pool_depth = \
            int(g["ingest_pool_depth"])
        params.metadata.resources.peak_host_bytes = \
            int(g["peak_host_bytes"])
        params.metadata.resources.shuffle_inflight_bytes = \
            int(g["shuffle_inflight_bytes"])
        params.metadata.resources.spill_bytes_total = \
            int(g["spill_bytes_total"])
        with self._status_lock:
            pending = list(self._pending_status)
            self._pending_status.clear()
        # profile windows are advisory observability payload: bound what
        # one poll ships so a burst of completions (each profile up to
        # 512 KiB) can never push the request past the transport's
        # message limit — a failed PollWork would LOSE the completion
        # reports it carried (pending was already cleared) and hang the
        # job. Reports always go; overflow profiles are dropped.
        budget = _POLL_PROFILE_BUDGET_BYTES
        for st in pending:
            if st.HasField("completed") and st.completed.HasField("profile"):
                sz = st.completed.profile.ByteSize()
                if sz > budget:
                    st.completed.ClearField("profile")
                else:
                    budget -= sz
            params.task_status.append(st)
        # live progress piggyback: advisory payload, never re-delivered
        # on a failed poll (unlike the reports above — the next sample
        # supersedes a lost one anyway)
        for tp in self._maybe_sample_progress():
            params.task_progress.append(tp)
        try:
            result = self._client.PollWork(params)
        except Exception:
            # report re-delivery: a failed poll (scheduler down, RPC
            # fault) must not LOSE the completion/failure reports it
            # carried — without them the scheduler only recovers the
            # tasks via lease reaping or speculation, minutes later.
            # Re-front them so the next successful poll delivers
            # (profiles already stripped above stay stripped: advisory)
            with self._status_lock:
                self._pending_status[:0] = pending
            raise
        for job_id in result.cancelled_jobs:
            self._handle_job_cancelled(job_id)
        if result.drain and not self._draining:
            # autoscaler scale-down piggyback: stop accepting work; the
            # poll loop keeps reporting until in-flight tasks finish
            # (executor_main exits on its own drain path afterwards)
            log.warning("executor %s: scheduler requested drain; no "
                        "longer accepting tasks", self.id[:8])
            self._draining = True
        if result.HasField("task"):
            self._run_task(result.task)

    def _maybe_sample_progress(self):
        """TaskProgress records for this poll, or [] (plane disabled,
        cadence not due, nothing running, or a triggered
        ``scheduler.progress_report`` fault). Samples never force a
        device sync (snapshot_rows resolves only ready scalars) and any
        failure here degrades to an unsampled poll — progress is
        advisory by contract."""
        from ..observability import progress as obs_progress

        interval = obs_progress.progress_interval_secs()
        if interval is None:
            return []
        now = time.time()
        if now - self._last_progress_sample < interval:
            return []
        self._last_progress_sample = now
        with self._progress_lock:
            entries = list(self._running_plans.values())
        if not entries:
            return []
        out = []
        try:
            # chaos surface: "drop" skips this round's piggyback,
            # "delay" stalls it, a "fail" raise is swallowed below —
            # results must be byte-identical under any of them
            if fault_point("scheduler.progress_report",
                           executor=self.id[:8]) == "drop":
                return []
            for entry in entries:
                if entry.get("input_total") is None:
                    # this task executes ONE partition of the shared
                    # stage plan: estimate its per-partition share
                    entry["input_total"] = obs_progress.plan_input_estimate(
                        entry["plan"], per_partition=True)
                s = obs_progress.sample_plan(
                    entry["plan"], input_rows_total=entry["input_total"])
                pid = entry["pid"]
                tp = pb.TaskProgress()
                tp.partition_id.job_id = pid.job_id
                tp.partition_id.stage_id = pid.stage_id
                tp.partition_id.partition_id = pid.partition_id
                tp.stage_version = entry["stage_version"]
                tp.operator = s["operator"] or ""
                tp.rows_so_far = max(int(s["rows_so_far"]), 0)
                tp.input_rows_total = max(int(s["input_rows_total"]), 0)
                tp.bytes_so_far = max(int(s["bytes_so_far"]), 0)
                tp.elapsed_seconds = now - entry["t0"]
                out.append(tp)
        except Exception:  # noqa: BLE001 - best-effort by contract
            log.debug("progress sample failed", exc_info=True)
            return []
        return out

    def _handle_job_cancelled(self, job_id: str):
        """A PollWorkResult carried this job id as cancelled: abort its
        running tasks at their next batch boundary and clean up partial
        stage outputs (completed shuffle files included — nothing will
        ever read them). Idempotent across polls: the id rides every
        poll for a broadcast window."""
        fired = self._fire_tokens(reason="cancelled", job_id=job_id)
        if fired:
            log.info("job %s cancelled; aborting %d running task(s)",
                     job_id, fired)
        # server-side stream abort: chunk streams this executor is
        # serving for the job terminate at their next chunk boundary
        from .dataplane import mark_job_cancelled

        mark_job_cancelled(job_id)
        if job_id not in self._cleaned_jobs:
            self._cleaned_jobs.append(job_id)
            self._cleanup_job_outputs(job_id)

    def _cleanup_job_outputs(self, job_id: str):
        path = os.path.join(self.config.work_dir, job_id)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
            log.info("removed cancelled job outputs: %s", path)

    # -- task execution (in-process; reference: run_received_tasks) ----------

    def _run_task(self, td: pb.TaskDefinition):
        self._slots.acquire()
        pid = PartitionId(td.task_id.job_id, td.task_id.stage_id,
                          td.task_id.partition_id)
        # per-task cancel token: registered BEFORE the pool accepts the
        # work so a cancel/drain arriving while the task is still queued
        # aborts it at entry, not after a full execution
        token = CancelToken(job_id=pid.job_id)
        with self._token_lock:
            self._task_tokens[pid.key()] = token
        try:
            plan = serde.physical_from_proto(td.plan,
                                             device=self.config.device)
            # whole-stage fusion happens AFTER deserialization, executor-
            # side: the wire format never carries fused operators, and a
            # re-planned stage's fresh task re-fuses to the same value-
            # keyed signatures (zero new compiles)
            from ..physical.fusion import maybe_fuse

            plan = maybe_fuse(plan)
            shuffle = None
            if td.shuffle_output_partitions:
                hash_exprs = [
                    serde.expr_from_proto(e) for e in td.shuffle_hash_exprs
                ]
                shuffle = (hash_exprs or None, td.shuffle_output_partitions)
        except Exception as e:  # noqa: BLE001 - bad plan/wire payload
            # deserialize/fuse failed BEFORE the pool accepted the work:
            # release the slot and the registered token (a leaked token
            # would make every future drain wait its full bound) and
            # report the failure instead of wedging the task forever
            with self._token_lock:
                self._task_tokens.pop(pid.key(), None)
            self._slots.release()
            log.exception("task %s rejected before execution", pid)
            self.tasks_failed += 1
            self._report_failed(pid, f"{type(e).__name__}: {e}",
                                td.stage_version)
            return

        def work():
            from ..observability import distributed as obs_dist
            from ..observability.tracing import flow

            t0 = time.time()
            self._inflight += 1
            # live progress: expose the executing plan to the poll
            # thread's sampler for the duration of the task
            with self._progress_lock:
                self._running_plans[pid.key()] = {
                    "pid": pid, "plan": plan, "t0": t0,
                    "stage_version": td.stage_version,
                    "input_total": None,
                }
            # per-task profile window (distributed profiler): snapshot
            # the process-wide ingest/compile accumulators up front so
            # the completion payload can ship deltas alongside the
            # flight-recorder span window
            capture = obs_dist.task_profile_enabled()
            if capture:
                from ..compile import compile_stats
                from ..ingest import phase_totals

                phases0, compile0 = phase_totals(), compile_stats()
            try:
                # fault point (chaos sweep): an injected failure here is
                # a transient task failure — the scheduler re-queues it
                # within the retry budget
                fault_point("executor.task.start", task=pid.key())
                # token checked at entry (a queued task of an already-
                # cancelled job must not run at all), then bound to the
                # thread so every batch boundary under execute sees it
                token.check()
                # flow(): every span/event emitted while this task runs
                # (ingest producers included — PrefetchHandle re-binds
                # the captured flow on its pool worker) carries the
                # job/stage/task triple for cross-process correlation
                with bind_token(token), \
                        flow(job=pid.job_id, stage=pid.stage_id,
                             task=pid.key()), \
                        trace_span("executor.task", task=pid.key(),
                                   executor=self.id[:8]):
                    if self.mesh_group is not None and _needs_mesh(plan):
                        # group task: broadcast so every member process
                        # enters the program together; serialized (the
                        # collectives must align across processes)
                        with self.mesh_group.lock:
                            seq = self.mesh_group.broadcast(
                                td.SerializeToString())
                            stats = self.execute_partition(pid, plan,
                                                           shuffle)
                            self.mesh_group.wait_acks(seq)
                    else:
                        stats = self.execute_partition(pid, plan, shuffle)
                profile = None
                if capture:
                    try:
                        profile = obs_dist.capture_task_profile(
                            pid.key(), t0, time.time() - t0, self.id,
                            phases0=phases0, compile0=compile0)
                    except Exception:  # noqa: BLE001 - observability
                        log.exception("task profile capture failed")
                self._report_completed(pid, stats, td.stage_version,
                                       profile=profile)
                self.tasks_completed += 1
                # same shape as the scheduler's query ring entries
                # (status/wall_seconds/output_rows — the systables
                # record contract), "rows"/"state" kept as legacy keys
                self._query_log.record({
                    "task": pid.key(), "state": "completed",
                    "status": "completed",
                    "wall_seconds": round(time.time() - t0, 4),
                    "rows": int(stats.get("num_rows", 0)),
                    "output_rows": int(stats.get("num_rows", 0)),
                })
            except QueryCancelled as e:
                # cooperative abort at a batch boundary: terminal for
                # this attempt but NOT a failure. The report is still
                # filed ("QueryCancelled:" is transient-shaped): for a
                # job-level cancel the scheduler drops it; for a drain
                # the job is live and the task re-queues elsewhere.
                log.info("task %s cancelled (%s)", pid, e.reason)
                self.tasks_cancelled += 1
                self._query_log.record({
                    "task": pid.key(), "state": "cancelled",
                    "status": "cancelled",
                    "wall_seconds": round(time.time() - t0, 4),
                    "cancel_reason": e.reason,
                })
                self._report_failed(pid, f"{type(e).__name__}: {e}",
                                    td.stage_version)
                # a JOB-level cancel removes the job's outputs (the
                # poll-side cleanup may have run before this task
                # released its write handle). A drain must NOT: the job
                # is live and this executor's earlier completed stage
                # files may still be fetched while the drain grace runs
                if e.reason != "drain":
                    self._cleanup_job_outputs(pid.job_id)
            except Exception as e:  # noqa: BLE001 - task failure
                log.exception("task %s failed", pid)
                self.tasks_failed += 1
                self._query_log.record({
                    "task": pid.key(), "state": "failed",
                    "status": "failed",
                    "wall_seconds": round(time.time() - t0, 4),
                    "error": f"{type(e).__name__}: {e}"[:300],
                })
                # prefix the exception class: the scheduler retries
                # transient (IO-shaped) failures but fails fast on
                # deterministic ones (bad plans, overflow limits)
                self._report_failed(pid, f"{type(e).__name__}: {e}",
                                    td.stage_version)
            finally:
                with self._token_lock:
                    self._task_tokens.pop(pid.key(), None)
                with self._progress_lock:
                    self._running_plans.pop(pid.key(), None)
                self._inflight -= 1
                self._slots.release()

        self._pool.submit(work)

    def execute_partition(self, pid: PartitionId, plan,
                          shuffle=None) -> dict:
        """Run one stage partition and STREAM its output to disk
        (reference: flight_service.rs:89-192). Batches are written as
        they are produced — bounded Arrow-IPC chunks through
        ``ipc.PartitionWriter`` — so the executor never holds a whole
        partition's output alongside its conversion buffers; the cancel
        token is checked at every batch pull AND every chunk write.
        With ``shuffle`` ((hash_exprs|None, n_out)) the output is
        hash/round-robin split into one shuffle-q file per consumer
        partition."""
        from ..ingest import cancel_plan, prime_plan

        t0 = time.time()
        # parallel ingest: start this task's leaf-scan parse+H2D on the
        # pool before pulling, so a plan with several scan leaves (e.g.
        # a merged join stage) parses them concurrently; primed handles
        # an aborted task leaves behind are cancelled, never leaked
        prime_plan(plan, partitions=[pid.partition_id])
        try:
            if shuffle is not None:
                hash_exprs, n_out = shuffle
                stats = write_shuffled(plan, pid, self.config.work_dir,
                                       hash_exprs, n_out)
            else:
                stats = write_partition(plan, pid, self.config.work_dir)
        finally:
            # handles the plan never consumed (failures) must not
            # leave producers parked on full queues
            cancel_plan(plan)
        log.info("executed %s%s in %.1fs (%d rows)", pid.key(),
                 f" (shuffle x{shuffle[1]})" if shuffle else "",
                 time.time() - t0, stats["num_rows"])
        stats["task_metrics"] = self._harvest_metrics(
            plan, time.time() - t0, stats, shuffled=shuffle is not None,
            write_secs=stats.pop("write_seconds", 0.0))
        return stats

    def _harvest_metrics(self, plan, elapsed_total: float, stats: dict,
                         shuffled: bool = False,
                         write_secs: float = 0.0) -> "dict | None":
        """Per-operator metrics off the executed plan + a synthetic
        write-side row (shuffle/partition IPC write happens outside the
        plan, so bytes_written needs its own operator row; its position
        is stable across tasks of a stage, keeping positional stage
        aggregation valid)."""
        if not metrics_enabled():
            return None
        ops = collect_plan_metrics(plan)
        write_row = {
            "operator": "ShuffleWrite" if shuffled else "PartitionWrite",
            "depth": 0,
            "metrics": {"bytes_written": int(stats.get("num_bytes", 0))},
        }
        if write_secs:
            write_row["metrics"]["elapsed_write"] = write_secs
        ops.append(write_row)
        return {"operators": ops, "elapsed_total": elapsed_total}

    def _report_completed(self, pid: PartitionId, stats: dict,
                          stage_version: int = 0, profile=None):
        ts = pb.TaskStatus()
        ts.partition_id.job_id = pid.job_id
        ts.partition_id.stage_id = pid.stage_id
        ts.partition_id.partition_id = pid.partition_id
        ts.stage_version = stage_version
        ts.completed.executor_id = self.id
        ts.completed.path = stats["path"]
        tm = stats.get("task_metrics")
        if tm:
            serde.task_metrics_to_proto(tm, ts.completed.metrics)
        if profile:
            serde.task_profile_to_proto(profile, ts.completed.profile)
        serde.stats_to_proto(stats, ts.completed.stats)
        with self._status_lock:
            self._pending_status.append(ts)

    def _report_failed(self, pid: PartitionId, error: str,
                       stage_version: int = 0):
        ts = pb.TaskStatus()
        ts.partition_id.job_id = pid.job_id
        ts.partition_id.stage_id = pid.stage_id
        ts.partition_id.partition_id = pid.partition_id
        ts.stage_version = stage_version
        ts.failed.error = error
        with self._status_lock:
            self._pending_status.append(ts)


def write_partition(plan, pid: PartitionId, work_dir: str) -> dict:
    """Stream one partition of ``plan`` whole into its partition file
    (a stage that feeds no shuffle: the final stage, or a merge-style
    input). Returns the writer's stats plus ``path`` and
    ``write_seconds``."""
    from ..io import ipc

    path = partition_path(work_dir, pid.job_id, pid.stage_id,
                          pid.partition_id)
    writer = ipc.PartitionWriter(path, schema=plan.output_schema(),
                                 compute_column_stats=True)
    try:
        with trace_span("dataplane.write", path=path):
            for batch in plan.execute(pid.partition_id):
                # cooperative cancellation at the batch boundary: a
                # fired token (job cancel, drain) stops the pull here
                check_cancel()
                writer.write_batch(batch)
            # empty partition: close() synthesizes one empty batch with
            # the plan schema
            stats = writer.close()
    except BaseException:
        writer.abort()
        raise
    return {**stats, "path": path, "write_seconds": writer.write_seconds}


def write_shuffled(plan, pid: PartitionId, work_dir: str, hash_exprs,
                   n_out: int) -> dict:
    """Streaming n_out-way shuffle write of one partition of ``plan``:
    every produced batch is hash-split (round-robin when ``hash_exprs``
    is None) and its slices appended to the per-consumer-partition
    stream writers IMMEDIATELY, so neither the stage output nor its
    Arrow conversion buffers ever accumulate — host memory peaks at one
    bounded chunk per writer. Each slice is the batch under the device
    mask ``selection & (pids == q)``, compacted to the host once per
    batch and output partition by its writer, as in the JAX package, so
    the files are byte-identical to its."""
    import torch

    from ..io import ipc
    from ..kernels.expr_eval import Evaluator
    from ..physical.operators import compute_partition_ids
    from .dataplane import shuffle_path

    schema = plan.output_schema()
    ev = Evaluator(schema)
    writers = [ipc.PartitionWriter(
        shuffle_path(work_dir, pid.job_id, pid.stage_id, pid.partition_id,
                     q), schema=schema) for q in range(n_out)]
    totals = {"num_rows": 0, "num_batches": 0, "num_bytes": 0}
    offset = 0
    try:
        with trace_span("dataplane.write", task=pid.key(), fan_out=n_out):
            for b in plan.execute(pid.partition_id):
                check_cancel()
                pids = compute_partition_ids(b, hash_exprs, n_out, offset,
                                             ev)
                for q in range(n_out):
                    writers[q].write_batch(b.with_selection(
                        torch.logical_and(b.selection, pids == q)))
                offset += b.num_rows_host()
            # per-output-partition byte histogram: the signal adaptive
            # re-planning coalesces/splits the consuming stage on.
            # Writers that saw no batches (or no rows) close with one
            # empty schema-bearing batch.
            qbytes = []
            for q in range(n_out):
                st = writers[q].close()
                qbytes.append(int(st["num_bytes"]))
                for k in totals:
                    totals[k] += st[k]
    except BaseException:
        for w in writers:
            w.abort()
        raise
    totals["shuffle_partition_bytes"] = qbytes
    # the last writer's path: its directory holds every output file
    totals["path"] = writers[-1].path
    return totals


# ---------------------------------------------------------------------------
# Local cluster helper (reference: executor --local mode, main.rs:101-138)
# ---------------------------------------------------------------------------


class LocalCluster:
    """In-process scheduler + N executors (for tests and single-host use).
    Every executor runs its tasks on ``device`` ("cuda" by default; it
    raises before anything starts when there is no card), and the
    scheduler its server-planned scalar subqueries."""

    def __init__(self, num_executors: int = 2, concurrent_tasks: int = 2,
                 scheduler_port: int = 0, num_devices: int = 1,
                 speculation_age_secs: float = 60.0,
                 metrics_port: "int | None" = None,
                 backend=None, device="cuda"):
        from ..client import _resolve_device
        from .scheduler import serve_scheduler
        from .state import MemoryBackend, SchedulerState

        device = _resolve_device(device)

        # metrics_port: None = off (in-process test clusters shouldn't
        # bind sockets unasked); 0 = ephemeral health plane on the
        # scheduler AND every executor
        # backend: a durable KvBackend (e.g. SqliteBackend) makes this
        # in-process cluster restart-recoverable — the controlplane
        # tests rebuild a LocalCluster over the same file
        self.state = SchedulerState(backend or MemoryBackend())
        self.server, self.service, self.port = serve_scheduler(
            self.state, "localhost", scheduler_port,
            speculation_age_secs=speculation_age_secs,
            metrics_port=metrics_port, device=device,
        )
        # remember the executor shape: the autoscaler's add_executor
        # hook spawns clones of the launch-time fleet
        self._exec_kwargs = dict(
            concurrent_tasks=concurrent_tasks,
            num_devices=num_devices,
            device=device,
            # executors always take an ephemeral port (several per
            # host; a fixed one could only serve the first); a
            # negative caller value means OFF here too (-1, not
            # None — None would fall back to the env default and
            # re-enable what the caller explicitly disabled)
            metrics_port=(None if metrics_port is None
                          else 0 if metrics_port >= 0 else -1),
        )
        self.executors = []
        for _ in range(num_executors):
            self.add_executor()

    def add_executor(self) -> "Executor":
        """Spawn one more in-process executor (the autoscaler's
        LocalCluster scale-up hook)."""
        cfg = ExecutorConfig(
            scheduler_host="localhost", scheduler_port=self.port,
            **self._exec_kwargs,
        )
        e = Executor(cfg)
        e.start()
        self.executors.append(e)
        return e

    def remove_executor(self, executor_id: "str | None" = None
                        ) -> "str | None":
        """Gracefully drain one executor (the autoscaler's LocalCluster
        scale-down hook): the youngest, or the one with ``executor_id``.
        Returns the drained executor's id, or None when empty."""
        if not self.executors:
            return None
        if executor_id is None:
            e = self.executors.pop()
        else:
            match = [x for x in self.executors if x.id == executor_id]
            if not match:
                return None
            e = match[0]
            self.executors.remove(e)
        e.stop(drain=True)
        return e.id

    @property
    def scheduler_health_port(self) -> "int | None":
        h = getattr(self.service, "health", None)
        return h.port if h is not None else None

    def shutdown(self):
        for e in self.executors:
            e.stop()
        # planning that is under way ends first: it would otherwise go
        # on writing into the (possibly durable) state after shutdown
        if not self.service.join_planning():
            log.warning("LocalCluster.shutdown: planning threads still "
                        "running after 30 s")
        self.service.close_health()
        self.server.stop(grace=None)
