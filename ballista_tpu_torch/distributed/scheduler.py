"""Scheduler: control-plane gRPC service + planning pipeline.

The port of the JAX package's ``distributed/scheduler.py``. The
scheduler plans, cuts and re-serializes plans, so everything it
deserializes for that lives on the CPU (``device="cpu"``). It runs one
kind of query itself, as the JAX scheduler does: the uncorrelated scalar
subqueries of a plan it received with one still in it (a server-planned
query, ``plan.server``). Those run on the scheduler's ``device``
(``"cuda"`` by default, the JAX scheduler's default device), their scans
reading the catalog's sources opened there, before the plan is cut into
stages; a plan without one never touches the device, so such a
scheduler creates no CUDA context. A fleet whose executors report a
mesh of n >= 2 slots each gets mesh-fused stages (``_fuse_mesh_stages``,
``physical/mesh_agg.py``), as the JAX scheduler plans them.

Re-implements the reference scheduler (reference: rust/scheduler/src/
lib.rs — the 5 SchedulerGrpc RPCs; execute_query background planning at
:224-407, poll_work assignment at :105-182). Differences by design:

- task assignment pops an event-driven ready-queue (see state.py) instead
  of scanning all tasks under a global lock;
- executors run tasks in-process (no self-RPC hop; the reference itself
  flags its own as convoluted, execution_loop.rs:90-91).
"""

from __future__ import annotations

import functools
import logging
import os
import random
import string
import threading
import time
from concurrent import futures
from typing import Dict, Optional

import grpc

from ..errors import ClusterError
from ..execution import (map_scalar_subqueries, plan_logical,
                         resolve_scalar_subqueries)
from ..lifecycle import CancelToken, bind_token
from ..logical import TableScan
from ..observability import trace_span
from ..proto import ballista_pb2 as pb
from ..testing.faults import fault_point
from .. import serde
from .planner import (
    DistributedPlanner,
    find_unresolved_shuffles,
    remove_unresolved_shuffles,
)
from .state import SchedulerState
from .types import ExecutorMeta, JobStatus, PartitionId, TaskStatus

log = logging.getLogger("ballista.scheduler")

# the proto package's name (proto/ballista.proto), so the port's
# scheduler and clients speak the JAX package's gRPC service
SERVICE = "ballista_tpu.SchedulerGrpc"

# where the scheduler builds what it deserializes (module doc)
_HOST = "cpu"

# Control-plane messages are small EXCEPT the distributed-profiler
# payloads: a PollWork carrying several completed tasks' profile
# windows (512 KiB each), and a GetJobProfile response serializing a
# whole merged artifact. gRPC's 4 MB default receive limit would fail
# exactly the jobs worth profiling — and a failed PollWork LOSES the
# completion reports it carried (the executor clears its pending list
# before the RPC). Applied to the server and every channel.
_GRPC_MSG_OPTS = [
    ("grpc.max_send_message_length", 64 << 20),
    ("grpc.max_receive_message_length", 64 << 20),
]


def _fuse_mesh_stages(stages, n_mesh: int):
    """In-mesh fast path: collapse a hash-shuffle stage + its
    final-aggregate consumer into ONE MeshAggExec stage that runs the
    shuffle as a row exchange between the slots of the executor's mesh
    instead of writing N^2 shuffle files through the data plane (the
    model being replaced: location-resolved file fetches, reference
    rust/scheduler/src/planner.rs:236-269 + shuffle_reader.rs:77-99),
    and a partitioned join with its two hash-shuffle producers into one
    MeshJoinExec.

    ``n_mesh`` is the CLUSTER-resolved mesh width (executor-reported
    device counts, see ``_cluster_mesh_devices``), not a client hint;
    < 2 disables fusion. Pattern matched exactly: consumer stage whose
    plan is HashAggregateExec(final) over UnresolvedShuffleExec([S])
    where S is a hash-shuffle stage. The fused nodes are built on the
    scheduler's CPU, only to be serialized."""
    from ..physical import operators as ops
    from ..physical.aggregate import HashAggregateExec
    from ..physical.join import JoinExec
    from ..physical.mesh_agg import MeshAggExec, MeshJoinExec
    from ..physical.shuffle import QueryStageExec, UnresolvedShuffleExec

    if n_mesh < 2:
        return stages
    from collections import Counter

    # by_id is kept UP TO DATE with rewritten stages, so a consumer
    # fusing later absorbs the fused producer subtree (chained joins),
    # never a stale child with dangling references to dropped stages
    by_id = {s.stage_id: s for s in stages}
    refcount = Counter(
        sid
        for s in stages
        for u in find_unresolved_shuffles(s.child)
        for sid in u.query_stage_ids
    )
    fused = []
    dropped = set()
    for stage in stages:
        # walk through single-child vertical wrappers (output projection,
        # HAVING filter) to the final aggregate
        wrappers = []
        plan = stage.child
        while isinstance(plan, (ops.ProjectionExec, ops.FilterExec)):
            wrappers.append(plan)
            plan = plan.children()[0]

        def _shuffle_producer(node):
            """The single hash-shuffle producer stage behind an
            UnresolvedShuffleExec (referenced nowhere else, so dropping
            it is safe), or None."""
            if not (isinstance(node, UnresolvedShuffleExec)
                    and len(node.query_stage_ids) == 1):
                return None
            sid = node.query_stage_ids[0]
            prod = by_id.get(sid)
            if prod is None or sid in dropped or refcount[sid] != 1 \
                    or not prod.shuffle_output_partitions \
                    or not prod.shuffle_hash_exprs:
                return None
            return prod

        new_plan = None
        if isinstance(plan, HashAggregateExec) and plan.mode == "final":
            producer = _shuffle_producer(plan.child)
            if producer is not None:
                dropped.add(producer.stage_id)
                new_plan = MeshAggExec(
                    producer.child, plan.group_exprs, plan.agg_exprs,
                    list(producer.shuffle_hash_exprs), n_mesh,
                    plan.group_capacity, device=_HOST,
                )
                log.info("fused stages %d+%d into a %d-device mesh "
                         "shuffle-agg", producer.stage_id, stage.stage_id,
                         n_mesh)
        else:
            # partitioned-join fusion: the JoinExec may sit anywhere in
            # the stage plan (e.g. under a partial aggregate) — replace
            # the subtree; everything above it runs on host over the
            # fused single-partition output
            def replace_join(node):
                if isinstance(node, JoinExec) and node.partitioned:
                    bprod = _shuffle_producer(node.build)
                    pprod = _shuffle_producer(node.probe)
                    if bprod is not None and pprod is not None:
                        dropped.update({bprod.stage_id, pprod.stage_id})
                        log.info(
                            "fused stages %d+%d+%d into a %d-device mesh "
                            "shuffle-join (how=%s)", bprod.stage_id,
                            pprod.stage_id, stage.stage_id, n_mesh,
                            node.how)
                        return MeshJoinExec(bprod.child, pprod.child,
                                            node.on, node.how, n_mesh,
                                            null_aware=node.null_aware,
                                            device=_HOST)
                kids = node.children()
                if not kids:
                    return node
                new_kids = [replace_join(c) for c in kids]
                if all(a is b for a, b in zip(kids, new_kids)):
                    return node
                return node.with_new_children(new_kids)

            replaced = replace_join(plan)
            if replaced is not plan:
                new_plan = replaced
        if new_plan is None:
            fused.append(stage)
            continue
        for w in reversed(wrappers):
            new_plan = w.with_new_children([new_plan])
        # PRESERVE the stage's own shuffle spec: a fused stage may itself
        # feed a downstream shuffle (e.g. one partitioned join in a chain
        # of them) — its single task then hash-splits its output as usual
        rebuilt = QueryStageExec(
            stage.job_id, stage.stage_id, new_plan,
            shuffle_hash_exprs=stage.shuffle_hash_exprs,
            shuffle_output_partitions=stage.shuffle_output_partitions,
        )
        by_id[stage.stage_id] = rebuilt
        fused.append(rebuilt)
    return [s for s in fused if s.stage_id not in dropped]


def _scans_on(plan, device) -> None:
    """Re-open, in place, every table scan of ``plan`` and of the scalar
    subqueries inside it on ``device``: the same source description
    (files, schema, format) through serde, so the scans read what the
    catalog names."""
    if isinstance(plan, TableScan):
        plan.source = serde.source_from_proto(
            serde.source_to_proto(plan.source), device=device)

    def nested(sq):
        if sq.plan is not None:
            _scans_on(sq.plan, device)
        return sq

    map_scalar_subqueries(plan, nested)
    for child in plan.children():
        _scans_on(child, device)


def _cluster_mesh_devices(state: SchedulerState, settings,
                          wait_secs: float = 3.0) -> int:
    """Mesh width for fusion, resolved from EXECUTOR-REPORTED device
    counts (each PollWork carries ``metadata.num_devices``) — the cluster
    truth — rather than the client's ``mesh.devices`` hint. Rules:

    - fleet uniformly reports n >= 2  -> fuse over n devices;
    - fleet reports mixed counts      -> no fusion (warned), unless the
      client claimed a width — then fail the job loudly;
    - a client claim that contradicts the uniform fleet is an ERROR: a
      lying (or stale) client must not change plan shape silently;
    - no executors registered yet: wait briefly only if the client
      claimed a mesh (cluster startup), else plan unfused.
    """
    try:
        claimed = int((settings or {}).get("mesh.devices", "0"))
    except ValueError:
        claimed = 0
    metas = state.get_executors_metadata()
    if not metas and claimed >= 2:
        deadline = time.time() + wait_secs
        while not metas and time.time() < deadline:
            time.sleep(0.1)
            metas = state.get_executors_metadata()
    if not metas:
        return 0
    reported = sorted({m.num_devices or 1 for m in metas})
    if len(reported) > 1:
        if claimed >= 2:
            raise ClusterError(
                f"mesh.devices={claimed} requested but executors report "
                f"mixed device counts {reported}; mesh fusion needs a "
                "uniform fleet"
            )
        log.warning("executors report mixed device counts %s: mesh "
                    "fusion disabled", reported)
        return 0
    n = reported[0]
    if claimed >= 2 and claimed != n:
        raise ClusterError(
            f"client requested mesh.devices={claimed} but executors "
            f"uniformly report {n} device(s); refusing to plan against "
            "the claimed mesh"
        )
    return n if n >= 2 else 0


def _mesh_requirement(plan) -> int:
    """Devices a task of this stage needs (max over mesh-fused nodes;
    0 = any executor). Drives device-aware task assignment."""
    from ..physical.mesh_agg import MeshAggExec, MeshJoinExec

    need = (plan.n_devices
            if isinstance(plan, (MeshAggExec, MeshJoinExec)) else 0)
    for c in plan.children():
        need = max(need, _mesh_requirement(c))
    return need


def _job_id() -> str:
    # 7-char alphanumeric starting with a letter (reference: lib.rs:262-270)
    first = random.choice(string.ascii_lowercase)
    rest = "".join(random.choices(string.ascii_lowercase + string.digits, k=6))
    return first + rest


class SchedulerService:
    def __init__(self, state: SchedulerState,
                 speculation_age_secs: float = 60.0,
                 metrics_port: "int | None" = None, device="cuda"):
        self.state = state
        # where server-planned scalar subqueries run (module doc); read
        # only when one arrives
        self.device = device
        # job id -> the cancel token bound while its subqueries run:
        # the job's terminal hook fires it, so a cancelled job's
        # subquery stops at its next batch boundary and commits nothing
        # to the table cache
        self._subquery_tokens: Dict[str, CancelToken] = {}
        self._subquery_lock = threading.Lock()
        # duplicate straggler tasks older than this when executors idle;
        # 0 disables
        self.speculation_age_secs = speculation_age_secs
        # adaptive query execution: re-plan not-yet-started stages from
        # observed stage metrics on every stage completion (per-job
        # knobs ride the query settings; see adaptive/replanner.py)
        from ..adaptive.replanner import replan_on_stage_complete

        state.replan_hook = replan_on_stage_complete
        # distributed profiler: the scheduler's own spans carry its
        # identity; executor task-profile payloads (riding CompletedTask
        # through PollWork) collect per job and merge — with the
        # scheduler's flight-recorder window — into ONE Chrome-trace
        # artifact per job (ambient BALLISTA_PROFILE, slow-query
        # retroactive dump, GetJobProfile RPC, /debug/profile/<job_id>)
        from ..observability.distributed import JobProfileCollector
        from ..observability.tracing import set_process_identity

        set_process_identity("scheduler")
        self.profiles = JobProfileCollector()
        # live progress plane (observability/progress.py): executor
        # TaskProgress piggybacks fold into per-stage completion
        # fractions + ETAs, served through GetJobStatus, /debug/jobs,
        # Prometheus gauges and the system.tasks/system.stages tables
        from ..observability.progress import JobProgressTracker

        self.progress = JobProgressTracker(state=state)
        # admission plane (distributed/admission.py): every
        # ExecuteQuery passes the gate; queued submissions hold their
        # planning args here until the pump admits (or sheds) them
        from .admission import AdmissionController

        self.admission = AdmissionController(
            state=state, launch_fn=self._launch_job,
            shed_fn=self._shed_queued_job)
        # durable control plane (distributed/controlplane/): accepted
        # submissions journal through the state's KvBackend at decision
        # time so a restarted scheduler rebuilds its admission queue and
        # replays planning lost mid-flight; observed stage costs persist
        # per plan digest and steer the NEXT initial plan. Both degrade
        # to in-memory (loudly) on backend errors — never refuse work.
        from .controlplane import ControlPlaneJournal, CostFeedbackStore

        self.journal = ControlPlaneJournal(state)
        self.costs = CostFeedbackStore(state)
        # elasticity: attach_autoscaler() installs the decision loop;
        # drain_requests carries scale-down targets to their executors
        # on the next PollWork (PollWorkResult.drain piggyback)
        self.autoscaler = None
        self.drain_requests: set = set()
        # merge/render/write of terminal-job artifacts runs here, OFF
        # the RPC handler threads (thread created lazily on first use:
        # unprofiled schedulers never spawn it)
        self._profile_pool = futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="profile-build")
        state.profile_hook = self._on_job_terminal
        # health plane: /healthz + /metrics + /debug/queries. The
        # scheduler's /metrics additionally aggregates the resource
        # gauges executors ship with every heartbeat.
        from ..observability.health import (maybe_start_health_server,
                                            metrics_port_from_env)

        # system.* tables (observability/systables.py): the scheduler
        # owns the cluster-wide snapshot — query ring + durable
        # history, per-job operator metrics, executor heartbeats — and
        # serves it to remote scans over GetSystemTable
        from ..observability.systables import OperatorStore, SystemSnapshot

        self.system_ops = OperatorStore()
        self.systables = SystemSnapshot(
            query_log=state.query_log, operators=self.system_ops,
            executors_fn=self._executor_rows,
            tasks_fn=self.progress.task_rows,
            stages_fn=self.progress.stage_rows,
            admission_fn=self.admission.decision_rows,
            autoscaler_fn=self._autoscaler_rows,
        )
        # system.queries / /debug/queries: queued rows carry their live
        # admission-queue position
        state.queue_info_fn = self.admission.queue_info
        # latency ledger (observability/ledger.py): scheduler-side
        # phase stamps (admission_wait/queue_wait/planning) accumulate
        # here per job until the terminal hook assembles the full
        # ledger; the admission pump stamps queue waits on admit
        self._ledger_stamps = {}
        self._ledger_lock = threading.Lock()
        self.admission.queue_wait_fn = (
            lambda job_id, wait: self._ledger_stamp(
                job_id, "queue_wait", wait))
        self.tasks_dispatched = 0
        # live planning threads (_launch_job): join_planning waits for
        # them, so a stopped scheduler writes nothing more to its state
        self._planning_threads: set = set()
        self._planning_lock = threading.Lock()
        if metrics_port is None:
            metrics_port = metrics_port_from_env(-1)
        self.health = maybe_start_health_server(
            "scheduler", metrics_port, samples_fn=self._metric_samples,
            query_log=state.query_log,
            profile_fn=self._profile_artifact,
            jobs_fn=self._debug_jobs,
        )

    def _metric_samples(self):
        st = self.state
        metas = st.get_executors_metadata()
        out = [
            ("ballista_executors_live", {}, len(metas)),
            ("ballista_jobs_submitted_total", {}, st.jobs_submitted),
            ("ballista_jobs_completed_total", {}, st.jobs_completed),
            ("ballista_jobs_failed_total", {}, st.jobs_failed),
            ("ballista_jobs_cancelled_total", {}, st.jobs_cancelled),
            ("ballista_tasks_dispatched_total", {}, self.tasks_dispatched),
            ("ballista_ready_queue_depth", {}, st.ready_queue_depth()),
            ("ballista_slow_queries_total", {}, st.query_log.slow_total),
            # admission plane: queue depth + the decision counters
            ("ballista_admission_queue_depth", {},
             self.admission.queue_depth()),
            ("ballista_admission_admitted_total", {},
             self.admission.admitted_total),
            ("ballista_admission_queued_total", {},
             self.admission.queued_total),
            ("ballista_admission_sheds_total", {},
             self.admission.sheds_total),
        ]
        if self.autoscaler is not None:
            out.extend([
                ("ballista_autoscale_target_executors", {},
                 self.autoscaler.target),
                ("ballista_autoscale_ups_total", {},
                 self.autoscaler.scale_ups_total),
                ("ballista_autoscale_downs_total", {},
                 self.autoscaler.scale_downs_total),
            ])
        # live progress gauges: per-job completion fraction + the
        # cluster-wide running-task count (gated through the registry
        # like every family; live jobs are bounded by the tracker cap)
        try:
            live = self.progress.live_snapshots()
        except Exception:  # noqa: BLE001 - diagnosis plane
            live = []
        out.append(("ballista_tasks_running", {},
                    sum(s["tasks_running"] for s in live)))
        for s in live:
            out.append(("ballista_job_progress_fraction",
                        {"job": s["job_id"]}, s["fraction"]))
        for m in metas:
            # getattr: a durable backend may still hold ExecutorMeta
            # pickles written by pre-resources code (unpickling skips
            # dataclass defaults), and one AttributeError here would
            # blank EVERY scheduler sample until the lease expires
            res = getattr(m, "resources", None) or {}
            labels = {"executor": m.id[:8]}
            out.append(("ballista_executor_rss_bytes", labels,
                        res.get("rss_bytes", 0)))
            out.append(("ballista_executor_device_bytes", labels,
                        res.get("device_bytes", 0)))
            out.append(("ballista_executor_inflight_tasks", labels,
                        res.get("inflight_tasks", 0)))
            out.append(("ballista_executor_ingest_pool_depth", labels,
                        res.get("ingest_pool_depth", 0)))
            out.append(("ballista_executor_peak_host_bytes", labels,
                        res.get("peak_host_bytes", 0)))
        return out

    def _executor_rows(self):
        """system.executors rows from the executor heartbeat metadata
        (same source as the /metrics per-executor gauges). Built from
        the DURABLE address records so a dead executor stays visible
        from SQL: ``heartbeat_age_seconds`` is the scheduler-side clock
        minus the last PollWork, and rows past
        ``BALLISTA_EXECUTOR_STALE_SECS`` (or with no heartbeat this
        scheduler lifetime) carry ``stale=true``."""
        from ..observability.progress import executor_stale_secs

        beats = self.state.executor_heartbeats()
        thr = executor_stale_secs()
        now = time.time()
        rows = []
        for m in self.state.all_executor_metadata():
            res = getattr(m, "resources", None) or {}
            hb = beats.get(m.id)
            age = (now - hb) if hb is not None else None
            rows.append({
                "executor_id": m.id,
                "host": m.host,
                "port": m.port,
                "num_devices": m.num_devices or 1,
                "rss_bytes": res.get("rss_bytes"),
                "device_bytes": res.get("device_bytes"),
                "inflight_tasks": res.get("inflight_tasks"),
                "ingest_pool_depth": res.get("ingest_pool_depth"),
                "peak_host_bytes": res.get("peak_host_bytes"),
                "shuffle_inflight_bytes": res.get("shuffle_inflight_bytes"),
                "spill_bytes_total": res.get("spill_bytes_total"),
                "heartbeat_age_seconds": round(age, 3)
                if age is not None else None,
                "stale": int(age is None or age > thr),
            })
        return rows

    def _autoscaler_rows(self):
        """system.autoscaler rows (empty until attach_autoscaler)."""
        if self.autoscaler is None:
            return []
        return self.autoscaler.decision_rows()

    def _debug_jobs(self, job_id: "str | None"):
        """``/debug/jobs`` (job_id None: every live job) and
        ``/debug/jobs/<job_id>`` (live or recently terminal). Queued
        jobs carry their admission-queue position/reason."""
        def enrich(snap):
            if snap and snap.get("status") == "queued":
                info = self.admission.queue_info(snap["job_id"])
                if info:
                    snap = {**snap, **info}
            return snap

        if job_id:
            return enrich(self.progress.snapshot(job_id))
        return [enrich(s) for s in self.progress.live_snapshots()]

    def begin_drain(self):
        """Degrade to rejecting NEW work while admitted work finishes
        (the admission ladder's terminal rung; scheduler_main flips it
        on SIGTERM before waiting out live jobs)."""
        self.admission.begin_drain()

    def close_health(self):
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.health is not None:
            self.health.close()
        self._profile_pool.shutdown(wait=False)

    # -- durable control plane ----------------------------------------------

    def recover(self):
        """One explicit restart-recovery pass over the durable backend
        (controlplane/recovery.py): re-queue journaled submissions,
        replay planning lost mid-flight, distrust unroutable shuffle
        outputs, fail orphans loudly. Call once, BEFORE executors poll.
        Returns the :class:`RecoveryReport`."""
        from .controlplane import recover as _recover

        return _recover(self)

    def attach_autoscaler(self, config, spawn_fn, drain_fn=None,
                          start=True):
        """Install the demand-driven autoscaler over this scheduler's
        own signals (ready+admission backlog, in-flight task gauges,
        live executor count, max live-job ETA). ``drain_fn`` defaults
        to flagging the least-loaded live executor for a graceful
        drain via the PollWorkResult piggyback."""
        from .controlplane import Autoscaler

        def signal_fn():
            eta = 0.0
            try:
                for s in self.progress.live_snapshots():
                    eta = max(eta, float(s.get("eta_seconds") or 0.0))
            except Exception:  # noqa: BLE001 - advisory signal
                pass
            metas = self.state.get_executors_metadata()
            inflight = 0
            for m in metas:
                res = getattr(m, "resources", None) or {}
                inflight += int(res.get("inflight_tasks") or 0)
            return {
                # admission backlog counts only ADMITTABLE queued jobs:
                # work held by its own session quota must not trigger
                # scale-up (admission.admittable_queue_depth)
                "backlog": self.state.ready_queue_depth()
                + self.admission.admittable_queue_depth(),
                "inflight": inflight,
                "executors": len(metas),
                "eta_seconds": eta,
            }

        if drain_fn is None:
            drain_fn = self._drain_one_executor
        self.autoscaler = Autoscaler(config, signal_fn, spawn_fn,
                                     drain_fn)
        if start:
            self.autoscaler.start()
        return self.autoscaler

    def _drain_one_executor(self):
        """Default scale-down hook: flag the least-loaded live executor
        not already draining; its next PollWork carries ``drain=True``
        and the executor stops accepting tasks, exiting via its own
        drain path once idle."""
        metas = self.state.get_executors_metadata()
        candidates = [m for m in metas if m.id not in self.drain_requests]
        if not candidates:
            return None

        def load(m):
            res = getattr(m, "resources", None) or {}
            return int(res.get("inflight_tasks") or 0)

        target = min(candidates, key=load)
        self.drain_requests.add(target.id)
        return target.id

    # -- distributed profiler ------------------------------------------------

    def _ledger_stamp(self, job_id: str, phase: str, secs: float) -> None:
        """Accumulate one scheduler-side latency-ledger phase for
        assembly at the job's terminal transition (best-effort)."""
        with self._ledger_lock:
            st = self._ledger_stamps.setdefault(job_id, {})
            st[phase] = st.get(phase, 0.0) + float(secs)

    def _on_job_terminal(self, job_id: str, summary: dict, status) -> None:
        """state.profile_hook: runs once per job at its terminal
        transition, BEFORE the summary enters the query log. Observes
        the per-stage duration histograms, and — under ambient
        ``BALLISTA_PROFILE`` or for a slow query — builds the merged
        artifact, writes it, and links it from the summary so
        ``/debug/queries`` points straight at the evidence. Only the
        ring snapshot happens here: the hook runs on the PollWork
        handler thread (inside ``save_job_status``), so the expensive
        merge/render/write is handed to a single background worker —
        a multi-megabyte artifact must not stall task handout."""
        from ..observability import profiler as obs_profiler
        from ..observability import systables, tracing
        from ..observability.distributed import slow_query_dir
        from ..observability.health import slow_query_secs
        from ..observability.registry import observe_histogram

        with self._subquery_lock:
            token = self._subquery_tokens.get(job_id)
        if token is not None:
            # a subquery still running for this job stops at its next
            # batch boundary (_resolve_subqueries)
            token.cancel(getattr(status, "cancel_reason", None)
                         or status.state)
        self.profiles.finalize(job_id, summary)
        # latency ledger: scheduler stamps + the summed per-task
        # ``ledger.*`` deltas that rode CompletedTask profiles — cheap
        # (no ring scan, no artifact work), so it runs inline and the
        # job's rows are queryable the moment its status is terminal
        try:
            from ..observability import ledger as obs_ledger

            with self._ledger_lock:
                stamps = self._ledger_stamps.pop(job_id, {})
            obs_ledger.record_ledger(obs_ledger.assemble_job_ledger(
                job_id, float(summary.get("wall_seconds", 0.0)),
                status.state, stamps,
                self.profiles.task_payloads(job_id)))
        except Exception:  # noqa: BLE001 - observability only
            log.exception("ledger assembly failed for job %s", job_id)
        # admission plane: release the session's concurrency slot (and
        # any queue entry — a cancelled/reaped queued job leaves the
        # queue here), then pump so a freed slot admits waiting work
        # immediately instead of on the next heartbeat
        try:
            self.admission.on_terminal(job_id)
            self.admission.pump(force=True)
        except Exception:  # noqa: BLE001 - must not take the job down
            log.exception("admission terminal hook failed for job %s",
                          job_id)
        # durable control plane: the submission record is spent — a
        # restart must not resurrect a terminal job (internally guarded)
        self.journal.drop_submission(job_id)
        # live progress: freeze the final snapshot (fraction exactly
        # 1.0 for completed jobs) and drop the job's sample store
        try:
            self.progress.finish(job_id, status.state)
        except Exception:  # noqa: BLE001 - observability only
            log.exception("progress finish failed for job %s", job_id)
        # per-session metering: fold this job into its session's
        # cumulative record (system.sessions); the session id traveled
        # with the query settings. Only the id lookup happens here —
        # SessionMeter.record rewrites its durable file, and file I/O
        # does not belong on the PollWork handler thread, so the fold
        # runs first on the background worker below (before annotate,
        # which needs the record to exist)
        session_id = ""
        try:
            from ..observability.progress import SESSION_SETTING

            session_id = self.state.get_job_settings(job_id).get(
                SESSION_SETTING, "")
        except Exception:  # noqa: BLE001 - observability only
            log.exception("session lookup failed for job %s", job_id)
        sm = getattr(status, "stage_metrics", None) or {}
        for sid, stage in sm.items():
            observe_histogram("ballista_stage_seconds",
                              {"stage": str(sid)},
                              float(stage.get("elapsed_total", 0.0)))
        if sm:
            # system.operators: the job's per-stage operator metrics
            # (already aggregated host data — a cheap materialization)
            self.system_ops.record(job_id,
                                   summary.get("plan_digest") or "",
                                   systables.stage_metrics_provider(sm))
        thr = slow_query_secs()
        slow = thr is not None and \
            float(summary.get("wall_seconds", 0.0)) >= thr
        out_dir = obs_profiler.profile_dir()
        # snapshot the scheduler's ring window NOW: by the time the
        # worker runs, later queries may have evicted this job's spans
        sched_records = tracing.ring_records(job=job_id)
        wall = float(summary.get("wall_seconds", 0.0))
        dest = out_dir if out_dir is not None else slow_query_dir()
        want_artifact = out_dir is not None or slow

        def build_and_write():
            # EVERY job gets its lane decomposition (system.query_lanes
            # + the lane histograms); the merged ARTIFACT is still only
            # rendered/written when profiled or slow. Runs here, off
            # the PollWork handler thread — the merge walks every
            # collected task window.
            try:
                self._meter_session(session_id, summary, status)
            except Exception:  # noqa: BLE001 - observability only
                log.exception("session metering failed for job %s",
                              job_id)
            # cost feedback: fold the completed job's observed stage
            # costs into its plan digest's record (the next submission
            # of this shape plans from them). Off the PollWork thread
            # like the session meter — it rewrites a durable row.
            if status.state == "completed" and sm:
                try:
                    self.costs.observe(
                        summary.get("plan_digest") or "", sm,
                        wall_seconds=wall)
                except Exception:  # noqa: BLE001 - advisory
                    log.exception("cost observe failed for job %s",
                                  job_id)
            try:
                art = path = None
                if want_artifact:
                    art = self.profiles.build(job_id, wall_seconds=wall,
                                              sched_records=sched_records)
                if art is not None:
                    lanes = dict(art.get("lanes") or {})
                else:
                    from ..observability.distributed import merged_session
                    from ..observability.export import compute_lanes

                    session = merged_session(
                        job_id, sched_records,
                        self.profiles.task_payloads(job_id), wall)
                    lanes = compute_lanes(session)["lanes"]
                for lane, secs in lanes.items():
                    observe_histogram("ballista_query_lane_seconds",
                                      {"lane": lane}, float(secs))
                # session metering, late fact: device-blocked seconds
                # only exist once the lane decomposition lands here
                if lanes.get("device_blocked"):
                    from ..observability.progress import \
                        process_session_meter

                    process_session_meter().annotate(
                        session_id,
                        device_blocked_seconds=lanes["device_blocked"])
                if art is not None:
                    from ..observability.export import write_artifact_file

                    try:
                        path = write_artifact_file(art, out_dir=dest)
                    except OSError:
                        log.exception("profile artifact write failed "
                                      "for job %s", job_id)
                        path = None
                    else:
                        self.profiles.set_artifact(job_id, art, path)
                        log.info("merged profile artifact for job %s: "
                                 "%s", job_id, path)
                        if out_dir is None:
                            # retroactive slow-query dump: keep the
                            # directory bounded (hygiene knob)
                            from ..observability.distributed import \
                                prune_slow_query_artifacts

                            prune_slow_query_artifacts(dest)
                # the ring records the summary BY COPY at the terminal
                # transition, usually before this build finishes: set
                # the source dict (covers a build outrunning record)
                # AND annotate the recorded entries + history log (the
                # common case)
                fields = {"lanes": lanes}
                summary["lanes"] = lanes
                if path is not None:
                    summary["profile_artifact"] = path
                    fields["profile_artifact"] = path
                systables.annotate_query(job_id,
                                         query_log=self.state.query_log,
                                         **fields)
            except Exception:  # noqa: BLE001 - observability only
                log.exception("profile build failed for job %s", job_id)

        self._profile_pool.submit(build_and_write)

    def _meter_session(self, session_id: str, summary: dict,
                       status) -> None:
        """Fold one terminal job into its session's cumulative record:
        wall seconds always; task seconds and shuffle bytes from the
        completed-task stage metrics. ``bytes_shuffled`` counts the
        write-side bytes every NON-FINAL stage materialized into the
        data plane (ShuffleWrite rows for hash exchanges, PartitionWrite
        rows for merge-type exchanges) — the observed wire bytes, the
        honest metering unit for a shuffle data plane."""
        from ..observability.progress import process_session_meter

        sm = getattr(status, "stage_metrics", None) or {}
        task_seconds = sum(float(st.get("elapsed_total", 0.0))
                           for st in sm.values())
        bytes_shuffled = 0
        final_sid = max(sm) if sm else None
        for sid, st in sm.items():
            if sid == final_sid:
                continue  # the result stage's write is not shuffle
            for op in st.get("operators") or []:
                if op.get("operator") in ("ShuffleWrite",
                                          "PartitionWrite"):
                    bytes_shuffled += int(
                        (op.get("metrics") or {}).get("bytes_written", 0))
        process_session_meter().record(
            session_id,
            wall_seconds=float(summary.get("wall_seconds", 0.0)),
            task_seconds=task_seconds,
            bytes_shuffled=bytes_shuffled,
            peak_host_bytes=summary.get("peak_host_bytes") or 0,
            peak_device_bytes=summary.get("peak_device_bytes") or 0,
        )

    def _profile_artifact(self, job_id: str):
        """/debug/profile/<job_id>: the job's merged artifact (built on
        demand from the collector + flight recorder)."""
        return self.profiles.build(job_id)

    # -- RPC: ExecuteQuery --------------------------------------------------

    def ExecuteQuery(self, request: pb.ExecuteQueryParams, context=None):
        job_id = _job_id()
        settings = dict(request.settings)
        # admission gate FIRST (needs only the settings): a shed must
        # not pay plan deserialization or persist any job state — the
        # submission never existed
        t_gate = time.perf_counter()
        decision = self.admission.gate(job_id, settings,
                                       request.deadline_secs)
        if decision.action == "shed":
            err = decision.error()
            return pb.ExecuteQueryResult(
                job_id=job_id, error=str(err),
                retry_after_secs=err.retry_after_secs)
        # latency ledger: gate time for accepted jobs (shed jobs never
        # reach the terminal hook, so they carry no stamps)
        self._ledger_stamp(job_id, "admission_wait",
                           time.perf_counter() - t_gate)
        deadline_ts = None
        if request.deadline_secs > 0:
            # server-side deadline: armed BEFORE planning (a stuck plan
            # counts — and an admission-QUEUED job's wait counts too)
            # and enforced by the PollWork reap pass, so the job dies
            # on time even when the submitting client is gone
            deadline_ts = time.time() + request.deadline_secs
            self.state.save_job_deadline(job_id, deadline_ts)
        try:
            if request.WhichOneof("query") == "logical_plan":
                plan = serde.plan_from_proto(request.logical_plan,
                                             device=_HOST)
                args = (job_id, plan, settings, None, None)
                plan_bytes = request.logical_plan.SerializeToString()
                sql_text, catalog_bytes = None, None
            else:
                # raw SQL: planned server-side in the background thread
                # (like plan failures, SQL errors land in
                # JobStatus('failed') rather than an opaque transport
                # error; reference accepts sql-or-plan, lib.rs:236-247)
                args = (job_id, None, settings, request.sql,
                        list(request.catalog))
                plan_bytes = None
                sql_text = request.sql
                catalog_bytes = [ct.SerializeToString()
                                 for ct in request.catalog]
            self.state.save_job_status(job_id, JobStatus("queued"))
            # live progress: track from submission so /debug/jobs
            # answers during planning too (fraction 0, no stages yet)
            self.progress.register_job(job_id)
            # durable control plane: journal the accepted submission at
            # decision time — a restarted scheduler re-queues (queued)
            # or replays planning (admitted, crashed mid-plan) from
            # exactly this record. Advisory: degrades loudly in-memory.
            self.journal.record_submission(
                job_id, decision.session_id, settings,
                sql=sql_text, catalog=catalog_bytes,
                plan_bytes=plan_bytes,
                action=decision.action, reason=decision.reason,
                priority=decision.config.priority,
                deadline_ts=deadline_ts)
        except BaseException:
            # the submission dies before it exists (bad plan proto):
            # release the gate's reservation or the session leaks a
            # concurrency slot forever (and drop its ledger stamps —
            # no terminal hook will ever pop them)
            self.admission.on_terminal(job_id)
            with self._ledger_lock:
                self._ledger_stamps.pop(job_id, None)
            raise
        if decision.action == "queue":
            # planning deferred: the pump launches (or sheds) it later;
            # status stays "queued" with a visible queue position
            self.admission.enqueue(decision, args)
            if self.state.is_job_cancelled(job_id):
                # a cancel raced the enqueue (its terminal hook ran
                # before the entry existed): drop the stale entry now —
                # the pump's pre-launch terminal re-check is the
                # backstop for the window that remains
                self.admission.on_terminal(job_id)
        else:
            try:
                self._launch_job(args)
            except BaseException as e:
                # thread spawn failed (fd/thread pressure — exactly the
                # overload regime): the job must not sit status=queued
                # forever holding its admitted slot. The terminal save
                # fires the hook, which releases the slot.
                self.state.save_job_status(job_id, JobStatus(
                    "failed", error=f"planning launch failed: {e}"))
                raise
        return pb.ExecuteQueryResult(job_id=job_id)

    def _launch_job(self, args):
        """Start the background planning thread for an ADMITTED job
        (straight from the gate, or later from the admission pump)."""
        def plan():
            try:
                self._plan_job(*args)
            finally:
                with self._planning_lock:
                    self._planning_threads.discard(t)

        t = threading.Thread(target=plan, daemon=True,
                             name=f"plan-{args[0]}")
        with self._planning_lock:
            self._planning_threads.add(t)
        try:
            t.start()
        except BaseException:
            with self._planning_lock:
                self._planning_threads.discard(t)
            raise

    def join_planning(self, timeout: float = 30.0) -> bool:
        """Wait up to ``timeout`` seconds for every planning thread to
        end; True when none is left. A planning thread writes stage and
        task rows, the ready queue and the journal's planned marker: a
        scheduler that stops without this leaves it writing into a
        durable backend that a restarted scheduler may already be
        recovering from (``LocalCluster.shutdown`` calls it)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._planning_lock:
                live = list(self._planning_threads)
            if not live:
                return True
            for t in live:
                t.join(max(deadline - time.monotonic(), 0.0))
            if time.monotonic() >= deadline:
                with self._planning_lock:
                    return not self._planning_threads

    def _shed_queued_job(self, decision):
        """Admission queue timeout: the job was accepted (status queued,
        visible, cancellable) but never admitted — move it to a
        terminal FAILED state whose error is the structured retryable
        shed, so the waiting client's poll raises AdmissionRejected."""
        if self.state.is_job_cancelled(decision.job_id):
            return  # a racing cancel already made it terminal
        self.state.save_job_status(
            decision.job_id,
            JobStatus("failed", error=str(decision.error())))

    def _plan_sql(self, sql: str, catalog_entries):
        from ..sql.parser import CreateExternalTable, parse_sql
        from ..sql.planner import CatalogTable, SqlPlanner

        catalog = {}
        for ct in catalog_entries:
            src = serde.source_from_proto(ct.source, device=_HOST)
            catalog[ct.name] = CatalogTable(
                ct.name, src, ct.source.primary_key or None
            )
        stmt = parse_sql(sql)
        if isinstance(stmt, CreateExternalTable):
            raise ClusterError(
                "CREATE EXTERNAL TABLE is a client-side statement; the "
                "scheduler keeps no durable catalog"
            )

        def system_source(name):
            # server-planned SQL over system.* tables: materialize the
            # SCHEDULER's snapshot at plan time (executors scan the
            # shipped rows)
            from ..observability.systables import SystemTableSource

            return SystemTableSource(
                name, rows=self.systables.table_rows(name))

        return SqlPlanner(catalog,
                          system_provider=system_source).plan(stmt)

    def _plan_job(self, job_id: str, logical_plan, settings=None,
                  sql=None, catalog_entries=None):
        try:
            with trace_span("scheduler.plan_job", job=job_id):
                self._plan_job_inner(job_id, logical_plan, settings, sql,
                                     catalog_entries)
        except Exception as e:  # noqa: BLE001 - job-level failure
            log.exception("planning failed for job %s", job_id)
            if not self.state.is_job_cancelled(job_id):
                # a cancel that raced planning stays terminal-cancelled
                self.state.save_job_status(
                    job_id, JobStatus("failed", error=str(e)))

    def _resolve_subqueries(self, job_id: str, logical_plan, opts):
        """Run ``logical_plan``'s uncorrelated scalar subqueries on the
        scheduler's device with the job's planner options ``opts``, and
        inline their values, as the JAX scheduler's ``plan_logical`` does
        on its default device. The job's cancel fires the token bound
        meanwhile."""
        import dataclasses

        from ..client import _resolve_device

        found = []
        map_scalar_subqueries(logical_plan,
                              lambda sq: found.append(sq) or sq)
        if not found:
            return logical_plan
        device = _resolve_device(self.device)
        for sq in found:
            if sq.plan is not None:
                _scans_on(sq.plan, device)
        token = CancelToken(job_id)
        with self._subquery_lock:
            self._subquery_tokens[job_id] = token
        if self.state.is_job_cancelled(job_id):
            token.cancel("client")  # cancelled before the bind
        try:
            with bind_token(token):
                return resolve_scalar_subqueries(
                    logical_plan, dataclasses.replace(opts, device=device))
        finally:
            with self._subquery_lock:
                self._subquery_tokens.pop(job_id, None)

    def _plan_job_inner(self, job_id: str, logical_plan, settings=None,
                        sql=None, catalog_entries=None):
        from ..physical.planner import PlannerOptions

        t0 = time.time()
        # persist the query settings: stage-completion re-planning reads
        # its adaptive.* knobs from here for the job's whole lifetime
        self.state.save_job_settings(job_id, settings or {})
        if logical_plan is None:
            logical_plan = self._plan_sql(sql, catalog_entries or [])
        digest = None
        try:
            # plan digest: identifies the query in slow-query summaries
            # and profile artifacts without re-planning it — and keys
            # the cost-feedback store below
            from ..observability.profiler import plan_digest

            digest = plan_digest(logical_plan)
            self.state.save_job_digest(job_id, digest)
        except Exception:  # noqa: BLE001 - digest is advisory
            pass
        opts = PlannerOptions.from_settings(settings, _HOST)
        try:
            # cost feedback: observed costs from prior runs of this
            # plan shape refine the INITIAL partition counts and join
            # strategy (AQE still corrects mid-flight; explicit client
            # settings always win inside advise)
            opts, cost_notes = self.costs.advise(digest, opts, settings)
            if cost_notes:
                log.info("cost feedback for job %s: %s", job_id,
                         "; ".join(cost_notes))
        except Exception:  # noqa: BLE001 - advisory
            log.exception("cost advise failed for job %s", job_id)
        # where the JAX scheduler's plan_logical resolves them: after the
        # digest (which names the query as submitted), on the device
        logical_plan = self._resolve_subqueries(job_id, logical_plan,
                                                opts)
        phys = plan_logical(logical_plan, opts)
        stages = DistributedPlanner().plan_query_stages(job_id, phys)
        stages = _fuse_mesh_stages(
            stages, _cluster_mesh_devices(self.state, settings)
        )
        for stage in stages:
            deps = [
                sid
                for u in find_unresolved_shuffles(stage.child)
                for sid in u.query_stage_ids
            ]
            nparts = stage.output_partitioning().num_partitions
            plan_bytes = serde.physical_to_proto(stage.child).SerializeToString()
            shuffle_spec = None
            if stage.shuffle_output_partitions:
                hx = [
                    serde.expr_to_proto(e).SerializeToString()
                    for e in (stage.shuffle_hash_exprs or [])
                ]
                shuffle_spec = (hx, stage.shuffle_output_partitions)
            self.state.save_stage_plan(
                job_id, stage.stage_id, plan_bytes, nparts, deps,
                shuffle_spec,
                mesh_devices=_mesh_requirement(stage.child),
            )
            for p in range(nparts):
                self.state.save_task_status(
                    TaskStatus(PartitionId(job_id, stage.stage_id, p))
                )
        if self.state.is_job_cancelled(job_id):
            # cancelled while planning (client cancel or an expired
            # deadline): nothing may reach the ready queue
            log.info("job %s cancelled during planning; not enqueued",
                     job_id)
            return
        # ledger stamp BEFORE the job becomes runnable: once enqueued,
        # the terminal hook may pop the job's stamps at any moment
        self._ledger_stamp(job_id, "planning", time.time() - t0)
        self.state.enqueue_job(job_id)
        # durable control plane: the full stage set + task rows are
        # persisted and the ready stages enqueued — restart recovery
        # may now trust them (absent marker ⇒ planning replays)
        self.journal.mark_planned(job_id)
        log.info(
            "planned job %s into %d stages in %.0fms",
            job_id, len(stages), 1000 * (time.time() - t0),
        )

    # -- RPC: PollWork ------------------------------------------------------

    def PollWork(self, request: pb.PollWorkParams, context=None):
        fault_point("scheduler.poll_work",
                    executor=request.metadata.id[:8])
        res = None
        if request.metadata.HasField("resources"):
            r = request.metadata.resources
            res = {
                "rss_bytes": int(r.rss_bytes),
                "device_bytes": int(r.device_bytes),
                "inflight_tasks": int(r.inflight_tasks),
                "ingest_pool_depth": int(r.ingest_pool_depth),
                "peak_host_bytes": int(r.peak_host_bytes),
                "shuffle_inflight_bytes": int(r.shuffle_inflight_bytes),
                "spill_bytes_total": int(r.spill_bytes_total),
            }
        meta = ExecutorMeta(
            id=request.metadata.id,
            host=request.metadata.host,
            port=request.metadata.port,
            num_devices=request.metadata.num_devices or 1,
            resources=res,
        )
        self.state.save_executor_metadata(meta)
        # live progress plane: fold the heartbeat's piggybacked task
        # samples into the tracker. Advisory by contract — any failure
        # here must not touch the scheduling work below.
        if request.task_progress:
            try:
                for tp in request.task_progress:
                    self.progress.record_report(
                        tp.partition_id.job_id,
                        tp.partition_id.stage_id,
                        tp.partition_id.partition_id,
                        {
                            "rows_so_far": int(tp.rows_so_far),
                            "input_rows_total": int(tp.input_rows_total),
                            "bytes_so_far": int(tp.bytes_so_far),
                            "elapsed_seconds": tp.elapsed_seconds,
                            "operator": tp.operator,
                            "stage_version": int(tp.stage_version),
                        })
            except Exception:  # noqa: BLE001 - best-effort
                log.debug("progress fold failed", exc_info=True)
        jobs_touched = set(self.state.reap_lost_tasks())
        # lifecycle reap: expired server-side deadlines + the slow-query
        # killer (already-terminal, so not re-synchronized below)
        self.state.reap_expired_jobs()
        # admission queue: heartbeats drive timeout sheds + freed-slot
        # admissions (throttled internally, like the reap pass)
        self.admission.pump()
        # late reports from tasks of a cancelled job: the terminal state
        # stands — no recovery, no re-queue, and a completion must not
        # resurrect dependents. Memoized per request: is_job_cancelled
        # falls back to a KV read, and a poll's reports almost always
        # share one job — don't pay one read per report on the hottest
        # handler
        _cancel_memo: dict = {}
        for ts in request.task_status:
            jid = ts.partition_id.job_id
            cancelled = _cancel_memo.get(jid)
            if cancelled is None:
                cancelled = _cancel_memo[jid] = \
                    self.state.is_job_cancelled(jid)
            if cancelled:
                continue
            if ts.WhichOneof("status") == "completed" and \
                    ts.completed.HasField("profile"):
                # distributed profiler: the task's profile window is
                # observability payload, not scheduling state — route it
                # to the bounded collector before the status conversion
                # (stale-version reports still ran; their spans count)
                prof = serde.task_profile_from_proto(ts.completed.profile)
                if prof is not None:
                    self.profiles.add_task_profile(
                        ts.partition_id.job_id, prof,
                        nbytes=len(ts.completed.profile.records_json))
            st = _task_status_from_proto(ts)
            jobs_touched.add(st.partition.job_id)
            if not self.state.accept_report_version(st):
                # the task was cut from a stage version an adaptive
                # re-plan superseded: its output layout no longer
                # matches the plan — drop the report (the state reset
                # any stranded current-version twin)
                continue
            if st.state == "completed":
                self.state.task_completed(st)
            elif st.state == "failed" and self.state.is_completed(st.partition):
                # the losing speculative duplicate failed AFTER the
                # original completed: the recorded result stands — a
                # failure report must not clobber it or trigger recovery
                log.info("dropping failure report for already-completed "
                         "task %s", st.partition.key())
            elif st.state == "failed" and \
                    self.state.absorb_speculative_failure(st.partition):
                # one of two in-flight copies (original + speculative
                # duplicate) failed while its twin may still succeed:
                # don't fail the job or burn recovery budget yet
                log.warning("absorbing first failure of speculated task "
                            "%s; twin copy still in flight (%s)",
                            st.partition.key(), st.error)
            elif st.state == "failed" and (
                self.state.recover_fetch_failure(st)
                or self.state.recover_transient_failure(st)
            ):
                log.warning(
                    "recovering job %s: task %s failed transiently — "
                    "re-queued (%s)",
                    st.partition.job_id, st.partition.key(), st.error,
                )
            else:
                self.state.save_task_status(st)
        result = pb.PollWorkResult()
        # autoscaler scale-down: tell a flagged executor to stop
        # accepting work (it drains its in-flight tasks and exits via
        # its own graceful path) — and don't hand it a task this poll
        draining = meta.id in self.drain_requests
        if draining:
            result.drain = True
        if request.can_accept_task and not draining:
            task = self.state.next_task(meta.num_devices)
            if task is None and self.speculation_age_secs > 0:
                task = self.state.speculative_task(
                    meta.num_devices, self.speculation_age_secs, meta.id,
                    # rate-based trigger off the live progress samples
                    # (age stays the fallback when no samples exist)
                    lag_fn=self.progress.speculation_lag_fn(),
                )
                if task is not None:
                    log.warning("speculating straggler task %s on executor "
                                "%s", task.key(), meta.id)
            if task is not None:
                try:
                    # a SPAN (not an instant): its duration is the real
                    # per-task plan resolution cost, and the merged
                    # artifact draws the flow arrow from this slice into
                    # the matching executor.task slice
                    with trace_span("scheduler.task_dispatch",
                                    task=task.key(), job=task.job_id,
                                    executor=meta.id[:8]):
                        result.task.CopyFrom(
                            self._task_definition(task, meta))
                    self.tasks_dispatched += 1
                except Exception as e:  # noqa: BLE001
                    log.exception("task resolution failed for %s", task)
                    st = TaskStatus(task, "failed", error=str(e))
                    # a tagged ShuffleFetchError here means a completed
                    # producer's data became unreachable (stage_locations
                    # refused to emit an unroutable address) — re-queue the
                    # producer instead of failing the consumer
                    if not self.state.recover_fetch_failure(st):
                        self.state.save_task_status(st)
                    jobs_touched.add(task.job_id)
        # piggyback recently-cancelled job ids: executors abort matching
        # running tasks at batch boundaries and clean partial outputs
        result.cancelled_jobs.extend(self.state.cancelled_job_ids())
        for job_id in jobs_touched:
            self.state.synchronize_job_status(job_id)
        return result

    def _task_definition(self, task: PartitionId, meta: ExecutorMeta
                         ) -> pb.TaskDefinition:
        row = self.state.get_stage_plan(task.job_id, task.stage_id)
        node = pb.PhysicalPlanNode()
        node.ParseFromString(row.plan_bytes)
        plan = serde.physical_from_proto(node, device=_HOST)
        if row.deps:
            locations = self.state.stage_locations(task.job_id,
                                                   stages=set(row.deps))
            # expand hash-shuffled producer locations into per-consumer
            # files, and collect per-dep reader info: adaptive read
            # layouts plus the producer's hash columns (so the resolved
            # reader reports trustworthy co-partitioning)
            reader_info = {}
            for dep in row.deps:
                dep_row = self.state.get_stage_plan(task.job_id, dep)
                info = {}
                if dep_row.shuffle_spec is not None:
                    hx_bytes, n_out = dep_row.shuffle_spec
                    info["hash_columns"] = _hash_column_names(hx_bytes)
                    info["original_partitions"] = n_out
                    if locations.get(dep):
                        # (missing/empty deps stay absent so shuffle
                        # resolution fails loudly with PlanError, not a
                        # zero-group reader)
                        locations[dep] = _expand_shuffle_locations(
                            locations[dep], n_out
                        )
                    # adaptive layouts only apply to still-shuffled deps
                    # (a demoted probe keeps a fallback layout that is
                    # meaningless once its shuffle spec was stripped)
                    if row.reader_layouts and dep in row.reader_layouts:
                        info["read_partitions"] = row.reader_layouts[dep]
                reader_info[dep] = info
            plan = remove_unresolved_shuffles(plan, locations, reader_info,
                                              device=_HOST)
        self.state.save_task_status(
            TaskStatus(task, "running", executor_id=meta.id,
                       started_at=time.time(), stage_version=row.version)
        )
        td = pb.TaskDefinition()
        td.task_id.job_id = task.job_id
        td.task_id.stage_id = task.stage_id
        td.task_id.partition_id = task.partition_id
        td.stage_version = row.version
        td.plan.CopyFrom(serde.physical_to_proto(plan))
        if row.shuffle_spec is not None:
            hx_bytes, n_out = row.shuffle_spec
            for hb in hx_bytes:
                e = pb.LogicalExprNode()
                e.ParseFromString(hb)
                td.shuffle_hash_exprs.append(e)
            td.shuffle_output_partitions = n_out
        return td

    # -- RPC: CancelJob -----------------------------------------------------

    def CancelJob(self, request: pb.CancelJobParams, context=None):
        """Cooperative cancellation entry point: move the job to its
        terminal Cancelled state and drop its queued tasks. Running
        tasks abort at batch boundaries once their executor's next poll
        carries the id (PollWorkResult.cancelled_jobs)."""
        cancelled = self.state.cancel_job(request.job_id,
                                          request.reason or "client")
        st = self.state.get_job_status(request.job_id)
        return pb.CancelJobResult(
            cancelled=cancelled,
            state=st.state if st is not None else "unknown",
        )

    # -- RPC: GetJobStatus --------------------------------------------------

    def GetJobStatus(self, request: pb.GetJobStatusParams, context=None):
        # lifecycle reap rides status polls too: with every executor
        # down there are no PollWork calls, but a waiting client still
        # drives deadline/slow-query-kill enforcement for its job —
        # and the admission pump, so a queue drains (or times out)
        # even with zero executors registered
        self.state.reap_expired_jobs()
        self.admission.pump()
        st = self.state.get_job_status(request.job_id)
        result = pb.GetJobStatusResult()
        if st is None:
            result.status.failed.error = f"unknown job {request.job_id}"
        elif st.state == "queued":
            result.status.queued.SetInParent()
            info = self.admission.queue_info(request.job_id)
            if info:
                result.status.queued.queue_position = \
                    info["queue_position"]
                result.status.queued.reason = info["reason"] or ""
                result.status.queued.queued_seconds = \
                    info["queued_seconds"]
                result.status.queued.recovered = \
                    bool(info.get("recovered"))
        elif st.state == "running":
            result.status.running.SetInParent()
        elif st.state == "cancelled":
            result.status.cancelled.reason = \
                getattr(st, "cancel_reason", None) or "unknown"
        elif st.state == "failed":
            result.status.failed.error = st.error or "unknown error"
            from ..errors import AdmissionRejected

            parsed = AdmissionRejected.parse(st.error or "")
            if parsed is not None:
                # a queue-timeout shed: structured AND machine-readable
                result.status.failed.retry_after_secs = parsed[1]
        else:
            for loc in st.partition_locations or []:
                result.status.completed.partition_location.append(
                    serde.location_to_proto(loc)
                )
            if getattr(st, "stage_metrics", None):
                serde.stage_metrics_to_proto(
                    st.stage_metrics, result.status.completed.stage_metrics
                )
        # live progress snapshot (extended GetJobStatus): present while
        # the tracker knows the job — the client's on_progress callback
        # and ctx.job_progress() read it from here. Skipped entirely
        # when the plane is disabled: status polls are a hot path and
        # the off knob must actually take the work off it
        from ..observability.progress import progress_interval_secs

        if progress_interval_secs() is not None:
            try:
                snap = self.progress.snapshot(request.job_id)
                if snap is not None:
                    serde.job_progress_to_proto(snap, result.progress)
            except Exception:  # noqa: BLE001 - advisory
                log.debug("progress snapshot failed", exc_info=True)
        return result

    # -- RPC: GetJobProfile --------------------------------------------------

    def GetJobProfile(self, request: pb.GetJobProfileParams, context=None):
        """Serve the job's merged profile artifact (distributed
        profiler): the remote ``df.profile()`` path. Built on demand
        from the collected task payloads + the scheduler's
        flight-recorder window when no ambient/slow build cached one."""
        import json as _json

        result = pb.GetJobProfileResult()
        art = self.profiles.build(request.job_id)
        if art is None:
            result.error = (f"no profile data for job {request.job_id} "
                            "(unknown job, or its window aged out of "
                            "the bounded collector)")
        else:
            result.artifact_json = _json.dumps(art, default=str).encode()
        return result

    # -- RPC: GetSystemTable -------------------------------------------------

    def GetSystemTable(self, request: pb.GetSystemTableParams,
                       context=None):
        """Serve one system.* table's rows from the SCHEDULER's
        snapshot: remote contexts route their system-table scans here
        so ``system.executors`` / ``system.queries`` reflect cluster
        state, not the client process."""
        import json as _json

        result = pb.GetSystemTableResult()
        try:
            rows = self.systables.table_rows(request.table)
        except KeyError as e:
            result.error = str(e)
        except Exception as e:  # noqa: BLE001 - diagnosis plane
            log.exception("system table build failed: %s", request.table)
            result.error = f"{type(e).__name__}: {e}"
        else:
            result.rows_json = _json.dumps(rows, default=str).encode()
        return result

    # -- RPC: GetExecutorsMetadata ------------------------------------------

    def GetExecutorsMetadata(self, request, context=None):
        result = pb.GetExecutorsMetadataResult()
        for e in self.state.get_executors_metadata():
            result.metadata.append(
                pb.ExecutorMetadata(id=e.id, host=e.host, port=e.port,
                                    num_devices=e.num_devices)
            )
        return result

    # -- RPC: GetFileMetadata -----------------------------------------------

    def GetFileMetadata(self, request: pb.GetFileMetadataParams, context=None):
        from ..io import ParquetSource

        if request.file_type.lower() not in ("parquet", ""):
            raise ClusterError("only Parquet metadata is supported "
                               "(reference parity: lib.rs:184-222)")
        src = ParquetSource(request.path, device=_HOST)
        return pb.GetFileMetadataResult(
            schema=serde.schema_to_proto(src.table_schema()),
            num_partitions=src.num_partitions(),
        )


def _hash_column_names(hx_bytes) -> list:
    """Column names a shuffle stage hash-partitioned on, or [] when any
    hash expr is not a plain column (then co-partitioning cannot be
    keyed by name and the reader stays Partitioning("unknown")).
    Memoized — the exprs are immutable per stage but this runs on every
    task dispatch of every consumer."""
    return list(_hash_column_names_cached(tuple(hx_bytes or ())))


@functools.lru_cache(maxsize=512)
def _hash_column_names_cached(hx_bytes: tuple) -> tuple:
    from .. import expr as ex

    names = []
    for hb in hx_bytes:
        e = pb.LogicalExprNode()
        e.ParseFromString(hb)
        parsed = serde.expr_from_proto(e)
        if not isinstance(parsed, ex.ColumnRef):
            return ()
        names.append(parsed.column)
    return tuple(names)


def _expand_shuffle_locations(producer_locs, n_out: int):
    """Per-producer completed-task locations -> one location per
    (producer, consumer-partition) shuffle file."""
    from .dataplane import shuffle_file_name
    from .types import PartitionLocation

    out = []
    for loc in producer_locs:
        base = os.path.dirname(loc.path) if loc.path else ""
        for q in range(n_out):
            out.append(
                PartitionLocation(
                    job_id=loc.job_id, stage_id=loc.stage_id,
                    partition_id=loc.partition_id,
                    executor_id=loc.executor_id, host=loc.host,
                    port=loc.port,
                    path=os.path.join(base, shuffle_file_name(q)) if base else "",
                    stats=loc.stats, shuffle_output=q,
                )
            )
    return out


def _task_status_from_proto(ts: pb.TaskStatus) -> TaskStatus:
    pid = PartitionId(ts.partition_id.job_id, ts.partition_id.stage_id,
                      ts.partition_id.partition_id)
    ver = ts.stage_version
    which = ts.WhichOneof("status")
    if which == "running":
        return TaskStatus(pid, "running", executor_id=ts.running.executor_id,
                          stage_version=ver)
    if which == "failed":
        return TaskStatus(pid, "failed", error=ts.failed.error,
                          stage_version=ver)
    if which == "completed":
        return TaskStatus(
            pid, "completed", executor_id=ts.completed.executor_id,
            path=ts.completed.path,
            stats=serde.stats_from_proto(ts.completed.stats),
            metrics=serde.task_metrics_from_proto(ts.completed.metrics),
            stage_version=ver,
        )
    return TaskStatus(pid, stage_version=ver)


# ---------------------------------------------------------------------------
# gRPC wiring (hand-rolled handlers; no grpc_tools codegen available)
# ---------------------------------------------------------------------------

_RPCS = {
    "ExecuteQuery": (pb.ExecuteQueryParams, pb.ExecuteQueryResult),
    "PollWork": (pb.PollWorkParams, pb.PollWorkResult),
    "CancelJob": (pb.CancelJobParams, pb.CancelJobResult),
    "GetJobStatus": (pb.GetJobStatusParams, pb.GetJobStatusResult),
    "GetJobProfile": (pb.GetJobProfileParams, pb.GetJobProfileResult),
    "GetSystemTable": (pb.GetSystemTableParams, pb.GetSystemTableResult),
    "GetExecutorsMetadata": (
        pb.GetExecutorsMetadataParams, pb.GetExecutorsMetadataResult,
    ),
    "GetFileMetadata": (pb.GetFileMetadataParams, pb.GetFileMetadataResult),
}


def serve_scheduler(state: SchedulerState, host: str = "0.0.0.0",
                    port: int = 50050, max_workers: int = 16,
                    speculation_age_secs: float = 60.0,
                    metrics_port: "int | None" = None, device="cuda"):
    """Start the scheduler gRPC server; returns (grpc_server, service).
    ``metrics_port`` starts the health plane (None = resolve
    ``BALLISTA_METRICS_PORT``, default off; 0 = ephemeral). ``device``:
    where server-planned scalar subqueries run."""
    svc = SchedulerService(state, speculation_age_secs=speculation_age_secs,
                           metrics_port=metrics_port, device=device)
    handlers = {}
    for name, (req_t, _resp_t) in _RPCS.items():
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            getattr(svc, name),
            request_deserializer=req_t.FromString,
            response_serializer=lambda m: m.SerializeToString(),
        )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         options=_GRPC_MSG_OPTS)
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE, handlers),)
    )
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server, svc, bound


class SchedulerClient:
    """Thin typed client over the generic gRPC channel."""

    def __init__(self, host: str, port: int):
        self.channel = grpc.insecure_channel(f"{host}:{port}",
                                             options=_GRPC_MSG_OPTS)
        self._stubs = {}
        for name, (req_t, resp_t) in _RPCS.items():
            self._stubs[name] = self.channel.unary_unary(
                f"/{SERVICE}/{name}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_t.FromString,
            )

    def __getattr__(self, name):
        if name in _RPCS:
            stub = self._stubs[name]

            def call(request, _stub=stub, _name=name):
                # client-side fault point: a triggered failure surfaces
                # as an RPC error exactly where a flaky network would
                fault_point("client.rpc", method=_name)
                return _stub(request)

            return call
        raise AttributeError(name)

    def close(self):
        self.channel.close()
