"""Scheduler restart recovery: one explicit pass over the durable
backend before serving. (The JAX package's module, with the one change
the port's serde asks for: a journaled plan is rebuilt on the CPU.)

``SchedulerState._rehydrate`` (run at construction) already rebuilds
the stage-dependency bookkeeping and re-queues the pending/running
tasks of non-terminal jobs. :func:`recover` layers the control-plane
semantics on top:

1. **Trust only routable shuffle outputs** — a task recorded
   ``completed`` whose producing executor has no durable address
   record cannot serve its partitions: it is reset to pending (its
   consumers leave the ready queue) and the producer stage re-queues,
   exactly the ``recover_fetch_failure`` shape without waiting for a
   consumer to trip first.
2. **Replay lost planning** — a non-terminal job without the journal's
   ``planned`` marker crashed mid-plan: its partial stage/task rows
   are wiped and planning re-runs from the journaled submission
   (admitted jobs relaunch; queued jobs re-enter the admission queue).
3. **Restore the admission queue** — journaled queued-but-unadmitted
   submissions rebuild their :class:`Decision` (priority, deadline and
   ORIGINAL enqueue time preserved, so re-pumping keeps the
   priority/deadline order and queue timeouts keep counting from the
   first enqueue) and re-enter the queue, marked ``recovered`` for
   GetJobStatus. Server-side deadlines re-arm from the journal.
4. **Fail orphans loudly** — a non-terminal job with neither stages
   nor a journal record (journal degraded, or pre-durability rows)
   moves to terminal ``failed`` so its waiting client gets an answer
   instead of a hang; ``system.sessions``/history stay consistent
   because the terminal transition flows through the normal
   ``save_job_status`` path.

The pass is idempotent (running it on a fresh or memory-backed state
is a no-op), emits one ``controlplane.recover`` trace event with every
counter, and never raises: a partially-unreadable backend recovers
what it can and reports the rest.
"""

from __future__ import annotations

import logging
import pickle
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

log = logging.getLogger("ballista.controlplane")


@dataclass
class RecoveryReport:
    """Counters from one :func:`recover` pass (the shape
    ``bench_serving``'s restart phase and the chaos tests assert on)."""

    jobs_seen: int = 0            # non-terminal jobs found in the backend
    jobs_inflight: int = 0        # planned jobs resumed task-level
    tasks_requeued: int = 0       # ready-queue entries after the pass
    producers_reset: int = 0      # completed tasks with unroutable outputs
    queued_restored: int = 0      # admission-queue entries rebuilt
    relaunched: int = 0           # admitted jobs re-planned from journal
    orphans_failed: int = 0       # unrecoverable jobs failed loudly
    deadlines_restored: int = 0
    recovery_seconds: float = 0.0
    errors: List[str] = field(default_factory=list)

    def as_dict(self) -> dict:
        return asdict(self)

    @property
    def recovered_jobs(self) -> int:
        return self.jobs_inflight + self.queued_restored + self.relaunched


def _nonterminal_jobs(state) -> Dict[str, object]:
    """job_id -> JobStatus for every non-terminal persisted job."""
    prefix = state._k("jobs") + "/"
    out = {}
    for k, v in state.kv.get_from_prefix(prefix):
        try:
            status = pickle.loads(v)
        except Exception:  # noqa: BLE001 - torn record: skip
            continue
        if status.state in ("completed", "failed", "cancelled"):
            continue
        out[k[len(prefix):]] = status
    return out


def _reset_unroutable_outputs(state, job_id: str) -> int:
    """Reset completed tasks whose producing executor left no durable
    address record (their shuffle outputs are unreachable); pull their
    consumers from the ready queue and re-queue the producer stage."""
    reset = 0
    with state._lock:
        for sid in state.stage_ids(job_id):
            lost = [
                t for t in state.get_task_statuses(job_id, sid)
                if t.state == "completed"
                and (not t.executor_id
                     or state.executor_address(t.executor_id) is None)
            ]
            if not lost:
                continue
            for t in lost:
                state._reset_task(t.partition)
            reset += len(lost)
            consumers = {
                s for (j, s), deps in state._stage_deps.items()
                if j == job_id and sid in deps
            }
            state._ready = [
                p for p in state._ready
                if not (p.job_id == job_id and p.stage_id in consumers)
            ]
            deps = state._stage_deps.get((job_id, sid), [])
            if all(state._stage_complete(job_id, d) for d in deps):
                state._enqueue_stage(job_id, sid)
    return reset


def _wipe_partial_plan(state, job_id: str) -> None:
    """Remove a crashed planning pass's partial stage/task rows so the
    replay starts clean (and the stale ready-queue entries with them)."""
    with state._lock:
        for prefix in (state._k("stages", job_id) + "/",
                       state._k("tasks", job_id) + "/"):
            for k, _v in state.kv.get_from_prefix(prefix):
                state.kv.delete(k)
        for sid in [s for (j, s) in list(state._stage_deps)
                    if j == job_id]:
            state._stage_deps.pop((job_id, sid), None)
            state._stage_parts.pop((job_id, sid), None)
            state._stage_mesh.pop((job_id, sid), None)
            state._stage_versions.pop((job_id, sid), None)
        state._ready = [p for p in state._ready if p.job_id != job_id]


def _args_from_entry(entry: dict):
    """Rebuild the planning args tuple ExecuteQuery would have built."""
    from ... import serde
    from ...proto import ballista_pb2 as pb

    job_id = entry["job_id"]
    settings = dict(entry.get("settings") or {})
    if entry.get("plan_bytes"):
        node = pb.LogicalPlanNode()
        node.ParseFromString(entry["plan_bytes"])
        # the scheduler plans on the CPU (distributed/scheduler.py)
        plan = serde.plan_from_proto(node, device="cpu")
        return (job_id, plan, settings, None, None)
    catalog = []
    for raw in entry.get("catalog") or []:
        ct = pb.CatalogTable()
        ct.ParseFromString(raw)
        catalog.append(ct)
    return (job_id, None, settings, entry.get("sql") or "", catalog)


def recover(service) -> RecoveryReport:
    """Run the full recovery pass against ``service``'s state/journal/
    admission plane. Safe on any backend; returns the counter report."""
    from ...observability.tracing import trace_event
    from ..admission import AdmissionConfig, Decision

    state = service.state
    journal = service.journal
    report = RecoveryReport()
    t0 = time.time()
    try:
        jobs = _nonterminal_jobs(state)
    except Exception as e:  # noqa: BLE001 - degrade, never refuse
        log.exception("recovery scan failed; serving without recovery")
        report.errors.append(f"scan: {e}")
        report.recovery_seconds = time.time() - t0
        return report
    report.jobs_seen = len(jobs)
    entries = {e["job_id"]: e for e in journal.submissions()}
    now = time.time()
    for job_id, _status in sorted(jobs.items()):
        entry = entries.get(job_id)
        try:
            if journal.is_planned(job_id):
                # planning completed before the crash: task-level
                # recovery (the ready queue was rehydrated; add the
                # unroutable-output check on top)
                report.producers_reset += _reset_unroutable_outputs(
                    state, job_id)
                report.jobs_inflight += 1
                state._job_started.setdefault(job_id, now)
                service.progress.register_job(job_id)
                service.admission.restore_admitted(
                    job_id, (entry or {}).get("session_id")
                    or "anonymous")
            elif entry is not None:
                _wipe_partial_plan(state, job_id)
                args = _args_from_entry(entry)
                state._job_started.setdefault(
                    job_id, entry.get("enqueued_at") or now)
                service.progress.register_job(job_id)
                if entry.get("deadline_ts"):
                    state.save_job_deadline(job_id, entry["deadline_ts"])
                    report.deadlines_restored += 1
                if entry.get("action") == "queue":
                    cfg = AdmissionConfig.from_settings(
                        entry.get("settings"))
                    d = Decision(
                        "queue", job_id,
                        entry.get("session_id") or "anonymous",
                        reason=entry.get("reason") or "recovered",
                        retry_after_secs=cfg.retry_after_secs,
                        config=cfg,
                        deadline_ts=entry.get("deadline_ts"),
                        enqueued_at=entry.get("enqueued_at") or now,
                        recovered=True,
                    )
                    service.admission.enqueue(d, args)
                    report.queued_restored += 1
                else:
                    # admitted but crashed mid-plan: replay planning
                    # (the slot it held re-occupies first)
                    service.admission.restore_admitted(
                        job_id, entry.get("session_id") or "anonymous")
                    service._launch_job(args)
                    report.relaunched += 1
            else:
                from ..types import JobStatus

                state.save_job_status(job_id, JobStatus(
                    "failed",
                    error="job lost at scheduler restart (no durable "
                          "submission record)"))
                report.orphans_failed += 1
        except Exception as e:  # noqa: BLE001 - recover what we can
            log.exception("recovery failed for job %s", job_id)
            report.errors.append(f"{job_id}: {e}")
    report.tasks_requeued = state.ready_queue_depth()
    report.recovery_seconds = round(time.time() - t0, 4)
    if report.queued_restored:
        # re-pump NOW: restored entries launch in priority/deadline
        # order without waiting for the first heartbeat
        try:
            service.admission.pump(force=True)
        except Exception:  # noqa: BLE001 - the next pump retries
            log.exception("post-recovery pump failed")
    counters = {k: v for k, v in report.as_dict().items()
                if k != "errors"}
    try:
        trace_event("controlplane.recover", **counters)
    except Exception:  # noqa: BLE001 - observability only
        pass
    if report.jobs_seen or report.errors:
        log.warning("control-plane recovery: %s", counters)
    else:
        log.info("control-plane recovery: clean state, nothing to do")
    return report
