"""Overload-safe multi-tenant admission plane: quotas, priorities,
load shedding.

Every ``ExecuteQuery`` submission passes a gate BEFORE any planning
work starts. The gate reads the per-session metering the progress
plane accumulates (``system.sessions`` — observability/progress.py)
and the live cluster load (ready-queue depth + executor-heartbeat
in-flight tasks) against per-session quotas and a global saturation
bound, and lands on one rung of the degradation ladder:

    admit  ->  queue  ->  shed

- **admit** — the job plans and runs exactly as before (the default:
  every quota knob defaults to unlimited, so an unconfigured cluster
  behaves identically to the pre-admission engine).
- **queue** — transient pressure (session/cluster concurrency caps, a
  saturated ready queue) holds the submission in a bounded admission
  queue ordered by ``admission.priority`` (higher first), then the
  job's server-side deadline (sooner first), then arrival. The job is
  visible as status=queued with its queue position via GetJobStatus,
  ``/debug/jobs`` and ``system.queries``; it is bounded by
  ``admission.queue_timeout_secs`` (shed on expiry), by its own
  deadline, and by the existing CancelJob path — a queued submission
  can never stall silently.
- **shed** — non-transient pressure (an exhausted cumulative session
  budget, a full admission queue, a draining scheduler) rejects the
  submission with a structured retryable error
  (:class:`~ballista_tpu_torch.errors.AdmissionRejected`) carrying
  ``retry_after_secs``; ``remote_collect`` honors it within the
  client's job timeout.

Configuration rides the established knob registry: per key,
``settings["admission.X"]`` > env ``BALLISTA_ADMISSION_X`` > default
(same resolution order as ``adaptive.*``). Decisions emit
``admission.*`` trace events, Prometheus gauges/counters + a
queue-wait histogram, and ``system.admission`` rows; the
``scheduler.admit`` / ``scheduler.admission_queue`` fault points feed
the chaos overload sweep (tests/test_admission.py).

The queue itself is in-memory scheduler state, but every accepted
submission is ALSO journaled through the control plane
(distributed/controlplane/journal.py) at decision time: a scheduler
restarted against a durable backend rebuilds queued (never-admitted)
submissions — priority, deadline and original enqueue time preserved
— in its ``recover()`` pass, marked ``recovered`` in queue-info and
GetJobStatus. Only a memory-backed (or journal-degraded) scheduler
keeps the old contract: queued submissions drop and their waiting
clients see an unknown-job error and resubmit.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..errors import AdmissionRejected, FaultInjected
from ..testing.faults import fault_point

log = logging.getLogger("ballista.admission")


def _as_bool(raw, key: str, default: bool) -> bool:
    # one truthy/falsy contract for every knob section (adaptive owns
    # the canonical tuple — a drift here would split the config dialect)
    from ..adaptive.config import _as_bool as _adaptive_bool

    return _adaptive_bool(raw, key, default)


@dataclass(frozen=True)
class AdmissionConfig:
    """The ``admission.*`` knob section. Every limit defaults to 0 =
    unlimited, so admission is a no-op until an operator (env) or a
    session (settings) configures pressure bounds."""

    enabled: bool = True
    # -- per-session quotas (session.id travels with the query settings)
    # concurrent admitted (non-terminal) jobs per session; excess QUEUES
    max_session_jobs: int = 0
    # cumulative budgets vs the system.sessions meter; excess SHEDS
    session_task_seconds: float = 0.0
    session_shuffle_bytes: int = 0
    session_host_bytes: int = 0
    # -- global bounds
    # concurrent admitted jobs across all sessions; excess QUEUES
    max_running_jobs: int = 0
    # ready-queue depth + heartbeat in-flight tasks; past it, QUEUE
    saturation_tasks: int = 0
    # admission queue bound; past it, SHED (default 64: a bounded queue
    # is the point — unbounded waiting is the failure mode this plane
    # exists to remove)
    max_queue_depth: int = 64
    # a submission queued longer than this is SHED with retry-after
    queue_timeout_secs: float = 30.0
    # the retry-after hint stamped on sheds
    retry_after_secs: float = 1.0
    # ordering: higher priority pops first (per-query setting)
    priority: float = 0.0

    @staticmethod
    def from_settings(settings: Optional[Dict[str, str]] = None,
                      env: Optional[Dict[str, str]] = None
                      ) -> "AdmissionConfig":
        s = settings or {}
        env = os.environ if env is None else env

        def raw(key: str):
            if key in s:
                return s[key]
            return env.get("BALLISTA_" + key.upper().replace(".", "_"))

        def boolean(key: str, default: bool) -> bool:
            v = raw(key)
            return default if v is None else _as_bool(v, key, default)

        def number(key: str, default: float, cast=float):
            v = raw(key)
            if v is None:
                return default
            try:
                n = cast(str(v).strip())
            except ValueError:
                raise ValueError(
                    f"config key {key!r}: expected a number, got {v!r}"
                ) from None
            if n < 0:
                raise ValueError(f"config key {key!r}: must be >= 0")
            return n

        return AdmissionConfig(
            enabled=boolean("admission.enabled", True),
            max_session_jobs=number("admission.max_session_jobs", 0, int),
            session_task_seconds=number(
                "admission.session_task_seconds", 0.0),
            session_shuffle_bytes=number(
                "admission.session_shuffle_bytes", 0, int),
            session_host_bytes=number(
                "admission.session_host_bytes", 0, int),
            max_running_jobs=number("admission.max_running_jobs", 0, int),
            saturation_tasks=number("admission.saturation_tasks", 0, int),
            max_queue_depth=number("admission.max_queue_depth", 64, int),
            queue_timeout_secs=number(
                "admission.queue_timeout_secs", 30.0),
            retry_after_secs=number("admission.retry_after_secs", 1.0),
            # priority may legitimately be negative: raw parse
            priority=float(raw("admission.priority") or 0.0),
        )


@dataclass
class Decision:
    """One gate verdict. ``action`` is the ladder rung; queue entries
    also carry everything the pump needs to launch or shed later."""

    action: str  # "admit" | "queue" | "shed"
    job_id: str
    session_id: str
    reason: str = ""
    retry_after_secs: float = 0.0
    config: AdmissionConfig = field(default_factory=AdmissionConfig)
    deadline_ts: Optional[float] = None
    enqueued_at: float = 0.0
    args: Optional[tuple] = None  # held planning args for queued jobs
    # rebuilt from the control-plane journal by a restarted scheduler's
    # recover() pass (GetJobStatus surfaces it as QueuedJob.recovered)
    recovered: bool = False

    def error(self) -> AdmissionRejected:
        return AdmissionRejected(self.reason, self.retry_after_secs,
                                 job_id=self.job_id)


class AdmissionController:
    """The scheduler's admission gate + bounded submission queue.

    Thread-safety: one RLock guards the queue/active maps; every state
    transition that re-enters the scheduler (save_job_status fires the
    terminal hook, which calls back into :meth:`on_terminal`) happens
    OUTSIDE the lock — the pump collects its actions under the lock and
    executes them after releasing it."""

    DECISION_RING = 256
    PUMP_INTERVAL_SECS = 0.2

    def __init__(self, state=None,
                 launch_fn: Optional[Callable[[tuple], None]] = None,
                 shed_fn: Optional[Callable[[Decision], None]] = None):
        self._state = state
        self.launch_fn = launch_fn
        # shed_fn(decision): move an already-accepted (queued) job to
        # its terminal shed state — wired to the scheduler service
        self.shed_fn = shed_fn
        # queue_wait_fn(job_id, wait_secs): stamp the admitted job's
        # queue wait into its latency ledger (observability/ledger.py)
        # — wired by the scheduler, best-effort
        self.queue_wait_fn: Optional[Callable[[str, float], None]] = None
        self._lock = threading.RLock()
        self._queue: List[Decision] = []
        self._active_session: Dict[str, str] = {}  # job_id -> session
        self._session_jobs: Dict[str, int] = {}
        self._last_pump = 0.0
        self.draining = False
        self.admitted_total = 0
        self.queued_total = 0
        self.sheds_total = 0
        self._decisions: deque = deque(maxlen=self.DECISION_RING)

    # -- load + metering signals --------------------------------------------

    def _cluster_load(self) -> int:
        """Tasks the cluster already owes work for: ready-queue depth
        plus the in-flight counts every executor heartbeat reports."""
        st = self._state
        if st is None:
            return 0
        load = 0
        try:
            load += st.ready_queue_depth()
        except Exception:  # noqa: BLE001 - advisory signal
            pass
        try:
            for m in st.get_executors_metadata():
                res = getattr(m, "resources", None) or {}
                load += int(res.get("inflight_tasks") or 0)
        except Exception:  # noqa: BLE001 - advisory signal
            pass
        return load

    @staticmethod
    def _session_meter_row(session_id: str) -> dict:
        """The session's cumulative metering record (system.sessions)."""
        from ..observability.progress import process_session_meter

        for rec in process_session_meter().rows():
            if rec.get("session_id") == session_id:
                return rec
        return {}

    # -- the gate ------------------------------------------------------------

    def gate(self, job_id: str, settings: Dict[str, str],
             deadline_secs: float = 0.0) -> Decision:
        """Evaluate one submission. A malformed ``admission.*`` value
        raises ValueError to the submitter (a configured-but-broken
        quota must fail LOUDLY, not silently stop being enforced —
        same posture as a bad ``job.deadline``). Beyond that the gate
        never raises into ExecuteQuery: a triggered ``scheduler.admit``
        fault (IoError-shaped, transient) degrades to a retryable shed;
        any OTHER internal error fails OPEN (admit, logged loudly) — an
        admission bug must not take a serving cluster's front door
        down."""
        from ..observability.progress import SESSION_SETTING

        session_id = str((settings or {}).get(SESSION_SETTING)
                         or "anonymous")
        # user config errors are not "internal": parse OUTSIDE the
        # fail-open guard so they surface to the submitter
        cfg = AdmissionConfig.from_settings(settings)
        try:
            fault_point("scheduler.admit", job=job_id,
                        session=session_id[:12])
            decision = self._decide(job_id, session_id, cfg,
                                    deadline_secs)
        except FaultInjected as e:
            decision = Decision("shed", job_id, session_id,
                                reason="admission-fault",
                                retry_after_secs=1.0)
            log.warning("admission gate fault for job %s: %s", job_id, e)
        except Exception:  # noqa: BLE001 - fail OPEN
            log.exception("admission gate failed for job %s; admitting",
                          job_id)
            decision = self._reserve(Decision("admit", job_id,
                                              session_id,
                                              reason="gate-error"))
        self._record(decision)
        return decision

    def _decide(self, job_id: str, session_id: str,
                cfg: AdmissionConfig, deadline_secs: float) -> Decision:
        def shed(reason: str) -> Decision:
            return Decision("shed", job_id, session_id, reason=reason,
                            retry_after_secs=cfg.retry_after_secs,
                            config=cfg)

        def queued(reason: str) -> Decision:
            # caller holds self._lock: the depth check and the queue
            # RESERVATION are one critical section (racing gates must
            # not grow the queue past the bound), and the queue-full
            # backstop only applies to work that would actually queue —
            # an admissible submission never pays for other tenants'
            # backlog. The entry enters the queue NOW with args pending
            # (the pump skips args-less entries until enqueue() lands).
            if cfg.max_queue_depth and \
                    len(self._queue) >= cfg.max_queue_depth:
                return shed("queue-full")
            d = Decision(
                "queue", job_id, session_id, reason=reason,
                retry_after_secs=cfg.retry_after_secs, config=cfg,
                deadline_ts=(time.time() + deadline_secs
                             if deadline_secs > 0 else None),
                enqueued_at=time.time(),
            )
            self._queue.append(d)
            self._sort_locked()
            return d

        if not cfg.enabled:
            return self._reserve(Decision(
                "admit", job_id, session_id, reason="disabled",
                config=cfg))
        if self.draining:
            return shed("draining")
        # cumulative session budgets: non-transient — queueing would
        # never clear them, so over-budget submissions SHED
        if (cfg.session_task_seconds or cfg.session_shuffle_bytes
                or cfg.session_host_bytes):
            meter = self._session_meter_row(session_id)
            if cfg.session_task_seconds and float(
                    meter.get("task_seconds") or 0.0) >= \
                    cfg.session_task_seconds:
                return shed("session-task-seconds")
            if cfg.session_shuffle_bytes and int(
                    meter.get("bytes_shuffled") or 0) >= \
                    cfg.session_shuffle_bytes:
                return shed("session-shuffle-bytes")
            if cfg.session_host_bytes and int(
                    meter.get("peak_host_bytes") or 0) >= \
                    cfg.session_host_bytes:
                return shed("session-host-bytes")
        # LOCK ORDER: the cluster-load probe takes the STATE lock, so it
        # runs before the controller lock (the terminal hook holds the
        # state lock while calling into the controller — nesting the
        # other way would deadlock); load is advisory, staleness is fine
        load = self._cluster_load() if cfg.saturation_tasks else 0
        with self._lock:
            if cfg.max_session_jobs and \
                    self._session_jobs.get(session_id, 0) >= \
                    cfg.max_session_jobs:
                return queued("session-concurrency")
            if cfg.max_running_jobs and \
                    len(self._active_session) >= cfg.max_running_jobs:
                return queued("cluster-concurrency")
            if cfg.saturation_tasks and load >= cfg.saturation_tasks:
                return queued("saturated")
            # check-and-reserve is ONE critical section: two racing
            # gates must not both admit past the same quota
            return self._reserve(Decision("admit", job_id, session_id,
                                          config=cfg))

    def _reserve(self, d: Decision) -> Decision:
        """Take the admitted job's concurrency slot (re-entrant lock:
        callers may already hold it)."""
        with self._lock:
            self.admitted_total += 1
            self._active_session[d.job_id] = d.session_id
            self._session_jobs[d.session_id] = \
                self._session_jobs.get(d.session_id, 0) + 1
        return d

    # -- bookkeeping ---------------------------------------------------------

    def _record(self, d: Decision) -> None:
        from ..observability.tracing import trace_event

        # admits reserved their slot inside the decision's critical
        # section (_reserve); only the counters remain here
        if d.action == "queue":
            with self._lock:
                self.queued_total += 1
        elif d.action == "shed":
            with self._lock:
                self.sheds_total += 1
        row = {
            "job_id": d.job_id, "session_id": d.session_id,
            "decision": d.action, "reason": d.reason or None,
            "priority": d.config.priority,
            "cluster_load": None, "queue_wait_seconds": None,
            "retry_after_seconds": d.retry_after_secs or None,
            "decided_at": time.time(),
        }
        if d.action != "admit":
            # only pressure decisions pay for the load snapshot
            row["cluster_load"] = self._cluster_load()
        with self._lock:
            self._decisions.append(row)
        try:
            trace_event(f"admission.{d.action}", job=d.job_id,
                        session=d.session_id[:12], reason=d.reason)
        except Exception:  # noqa: BLE001 - observability only
            pass
        if d.action != "admit":
            log.warning("admission %s job %s (session %s): %s",
                        d.action.upper(), d.job_id, d.session_id[:12],
                        d.reason)

    def enqueue(self, decision: Decision, args: tuple) -> None:
        """Attach an accepted-but-queued submission's planning args.
        The queue SLOT was already reserved inside the gate's critical
        section (the depth bound must be atomic with the decision);
        direct-constructed decisions (tests, tools) are inserted here."""
        with self._lock:
            decision.args = args
            # dedup by job_id, not identity: a repeated recovery pass
            # rebuilds fresh Decision objects for jobs already waiting
            if not any(d.job_id == decision.job_id for d in self._queue):
                self._queue.append(decision)
                self._sort_locked()

    def restore_admitted(self, job_id: str, session_id: str) -> None:
        """Restart recovery: re-occupy the concurrency slot of a job
        that was ADMITTED before the previous scheduler died (in-flight
        or replayed planning), so post-restart pumping still honors
        ``max_running_jobs``/``max_session_jobs`` and the job's terminal
        transition releases a slot that actually exists."""
        with self._lock:
            if job_id in self._active_session:
                return
            self._active_session[job_id] = session_id
            self._session_jobs[session_id] = \
                self._session_jobs.get(session_id, 0) + 1

    def _sort_locked(self) -> None:
        # priority (higher first), then server-side deadline (sooner
        # first — a job with less time left must not rot behind
        # deadline-less work), then arrival order
        self._queue.sort(key=lambda d: (
            -d.config.priority,
            d.deadline_ts if d.deadline_ts is not None else float("inf"),
            d.enqueued_at,
        ))

    def on_terminal(self, job_id: str) -> None:
        """Terminal-transition hook (every admitted OR queued job):
        release the session's concurrency slot and drop any queue entry
        (a cancelled/deadline-reaped queued job must leave the queue)."""
        with self._lock:
            session = self._active_session.pop(job_id, None)
            if session is not None:
                n = self._session_jobs.get(session, 0) - 1
                if n > 0:
                    self._session_jobs[session] = n
                else:
                    self._session_jobs.pop(session, None)
            self._queue = [d for d in self._queue if d.job_id != job_id]

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def admittable_queue_depth(self) -> int:
        """Queued entries that added cluster capacity could actually
        admit. A job queued behind its OWN session's concurrency quota
        (``admission.max_session_jobs``) stays queued no matter how
        many executors join — counting it would make the autoscaler
        buy machines a single tenant's quota forbids it from using.
        Walked in pop order with virtual slots: once a session's
        running + admittable-queued jobs reach its quota, the rest of
        that session's backlog is invisible to scaling."""
        with self._lock:
            virtual = dict(self._session_jobs)
            n = 0
            for d in self._queue:
                cfg = d.config
                cap = cfg.max_session_jobs if cfg is not None else 0
                if cap and virtual.get(d.session_id, 0) >= cap:
                    continue
                virtual[d.session_id] = virtual.get(d.session_id, 0) + 1
                n += 1
            return n

    def queue_info(self, job_id: str) -> Optional[dict]:
        """Queue position (1-based, in pop order) + reason + wait so
        far, or None when the job is not admission-queued."""
        now = time.time()
        with self._lock:
            for i, d in enumerate(self._queue):
                if d.job_id == job_id:
                    return {
                        "queue_position": i + 1,
                        "reason": d.reason,
                        "queued_seconds": round(now - d.enqueued_at, 3),
                        "recovered": d.recovered,
                    }
        return None

    def decision_rows(self) -> List[dict]:
        """``system.admission``: recent decisions, oldest first."""
        with self._lock:
            return [dict(r) for r in self._decisions]

    def begin_drain(self) -> None:
        """Overload/shutdown degradation: reject every NEW submission
        (shed, reason=draining) while admitted work — including already
        queued submissions — finishes normally."""
        with self._lock:
            self.draining = True
        log.warning("admission plane draining: new submissions are shed")

    # -- the pump ------------------------------------------------------------

    def pump(self, force: bool = False) -> None:
        """Advance the queue: shed expired entries, launch entries the
        current load/concurrency allows. Called from PollWork and
        GetJobStatus (throttled) and from every terminal transition
        (forced) — the same piggyback cadence the reap pass rides, so
        the queue drains even with zero executors polling."""
        now = time.time()
        with self._lock:
            if not self._queue:
                return
            if not force and now - self._last_pump < \
                    self.PUMP_INTERVAL_SECS:
                return
            self._last_pump = now
        try:
            fault_point("scheduler.admission_queue",
                        depth=self.queue_depth())
        except FaultInjected:
            # transient by contract: the queue entry is untouched and
            # the next pump retries — a queue fault may DELAY dispatch,
            # never lose or hang a submission
            log.warning("admission queue pump fault injected; will "
                        "retry on the next pump")
            return
        to_shed: List[Decision] = []
        to_launch: List[Decision] = []
        # LOCK ORDER: the load probe takes the state lock — before the
        # controller lock (see gate); one snapshot serves the round
        load = self._cluster_load()
        with self._lock:
            keep: List[Decision] = []
            for d in self._queue:
                timeout = d.config.queue_timeout_secs
                if timeout and now - d.enqueued_at >= timeout:
                    to_shed.append(d)
                else:
                    keep.append(d)
            self._queue = keep
            self._sort_locked()
            # admission scan in pop order: entries whose own limits
            # (the submitting client's knobs govern, like adaptive.*)
            # still block are SKIPPED, not waited behind — a session at
            # its quota must not convoy other sessions' ready work
            remaining: List[Decision] = []
            for d in self._queue:
                cfg = d.config
                if d.args is None:
                    # slot reserved by the gate but ExecuteQuery hasn't
                    # attached the planning args yet: not launchable
                    # for a few microseconds — leave it
                    remaining.append(d)
                    continue
                blocked = (
                    (cfg.max_session_jobs and
                     self._session_jobs.get(d.session_id, 0) >=
                     cfg.max_session_jobs)
                    or (cfg.max_running_jobs and
                        len(self._active_session) >=
                        cfg.max_running_jobs)
                    or (cfg.saturation_tasks and
                        load >= cfg.saturation_tasks)
                )
                if blocked:
                    remaining.append(d)
                    continue
                self._active_session[d.job_id] = d.session_id
                self._session_jobs[d.session_id] = \
                    self._session_jobs.get(d.session_id, 0) + 1
                self.admitted_total += 1
                to_launch.append(d)
            self._queue = remaining
        # state transitions OUTSIDE the lock: both paths re-enter the
        # scheduler (shed saves a terminal status whose hook calls
        # on_terminal; launch spawns the planning thread)
        for d in to_shed:
            self._shed_queued(d, now)
        for d in to_launch:
            self._launch_queued(d, now)

    def _observe_wait(self, d: Decision, now: float, outcome: str) -> None:
        from ..observability.registry import observe_histogram
        from ..observability.tracing import trace_event

        wait = max(now - d.enqueued_at, 0.0)
        try:
            observe_histogram("ballista_admission_queue_wait_seconds",
                              {"outcome": outcome}, wait)
        except Exception:  # noqa: BLE001 - observability only
            pass
        with self._lock:
            self._decisions.append({
                "job_id": d.job_id, "session_id": d.session_id,
                "decision": outcome, "reason": d.reason or None,
                "priority": d.config.priority, "cluster_load": None,
                "queue_wait_seconds": round(wait, 3),
                "retry_after_seconds": d.retry_after_secs or None,
                "decided_at": now,
            })
        try:
            trace_event(f"admission.{outcome}", job=d.job_id,
                        session=d.session_id[:12],
                        queue_wait_seconds=round(wait, 3))
        except Exception:  # noqa: BLE001 - observability only
            pass

    def _shed_queued(self, d: Decision, now: float) -> None:
        with self._lock:
            self.sheds_total += 1
        d.reason = "queue-timeout"
        self._observe_wait(d, now, "shed")
        log.warning("admission queue timeout: shedding job %s after "
                    "%.1fs", d.job_id, now - d.enqueued_at)
        if self.shed_fn is not None:
            try:
                self.shed_fn(d)
            except Exception:  # noqa: BLE001 - must not kill the pump
                log.exception("queued-job shed failed for %s", d.job_id)

    def _job_is_terminal(self, job_id: str) -> bool:
        st = self._state
        if st is None:
            return False
        try:
            js = st.get_job_status(job_id)
        except Exception:  # noqa: BLE001 - advisory
            return False
        return js is not None and js.state in ("completed", "failed",
                                               "cancelled")

    def _launch_queued(self, d: Decision, now: float) -> None:
        if self._job_is_terminal(d.job_id):
            # a cancel/deadline raced the enqueue (its terminal hook
            # found no queue entry yet): the job must not launch, and
            # the slot just reserved for it must be released — a leaked
            # slot would deny the session forever
            log.info("queued job %s went terminal before admission; "
                     "dropping", d.job_id)
            self.on_terminal(d.job_id)
            return
        self._observe_wait(d, now, "admitted")
        if self.queue_wait_fn is not None:
            try:
                self.queue_wait_fn(d.job_id,
                                   max(now - d.enqueued_at, 0.0))
            except Exception:  # noqa: BLE001 - ledger is advisory
                pass
        log.info("admitting queued job %s after %.1fs (reason was %s)",
                 d.job_id, now - d.enqueued_at, d.reason)
        if self.launch_fn is not None:
            try:
                self.launch_fn(d.args)
            except Exception:  # noqa: BLE001 - surface as job failure
                # the job would otherwise sit status=queued forever
                # with its slot held: release the slot and shed it as
                # a retryable failure the waiting client sees
                log.exception("queued-job launch failed for %s",
                              d.job_id)
                self.on_terminal(d.job_id)
                d.reason = "launch-error"
                if self.shed_fn is not None:
                    try:
                        self.shed_fn(d)
                    except Exception:  # noqa: BLE001 - best-effort
                        log.exception("launch-failure shed failed for "
                                      "%s", d.job_id)
