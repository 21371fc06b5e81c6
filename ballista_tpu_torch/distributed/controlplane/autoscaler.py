"""Demand-driven executor autoscaler.

The reference scales executors with k8s replica counts, decoupled from
the scheduler; this engine's fleet was fixed at launch. The autoscaler
closes the loop inside the scheduler: a small decision loop reads the
demand signals the engine already computes —

- **backlog**: ready-queue depth plus admission-queue depth (the admission
  plane's saturation signals),
- **latency**: the live rate-based ETA plane — the max
  ``eta_seconds`` across in-flight jobs,
- **supply**: live executor leases + in-flight task gauges,

and lands on one of three actions per tick: **scale-up** (spawn one
executor via the installed hook), **scale-down** (drain one idle
executor after a cooldown), or hold. The fleet is bounded by
``autoscale.min_executors``/``autoscale.max_executors``; one action
per ``autoscale.cooldown_secs`` keeps the loop from flapping.

Spawn hooks: :meth:`LocalCluster.add_executor` in-process, or
:class:`SubprocessExecutorLauncher` for the real
``executor_main`` binary. Scale-down always goes through the graceful
path — in-process executors get ``Executor.stop(drain=True)``;
subprocess executors get SIGTERM (executor_main's drain signal) after
the scheduler's ``PollWorkResult.drain`` piggyback told them to stop
accepting work.

Every decision is visible: a bounded ring serves ``system.autoscaler``
rows, counters/gauges ride the scheduler's /metrics, and each action
emits a ``controlplane.autoscale`` trace event. The
``autoscaler.spawn`` fault point makes spawn failures a first-class
chaos surface (transient by contract: a failed spawn skips the tick
and the next one retries).

Knobs (settings > env ``BALLISTA_AUTOSCALE_*`` > default, the
admission.* resolution order): see :class:`AutoscalerConfig`.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ...errors import FaultInjected
from ...testing.faults import fault_point

log = logging.getLogger("ballista.autoscaler")


@dataclass(frozen=True)
class AutoscalerConfig:
    """The ``autoscale.*`` knob section. Disabled by default: an
    unconfigured cluster keeps its launch-time fleet exactly."""

    enabled: bool = False
    # fleet bounds (min is also the idle floor scale-down respects)
    min_executors: int = 1
    max_executors: int = 4
    # scale up when backlog (ready + admission queue) reaches this
    backlog_tasks: int = 8
    # ... or when any live job's rate-based ETA exceeds this (0 = off)
    eta_secs: float = 0.0
    # at most one scaling action per cooldown window
    cooldown_secs: float = 5.0
    # drain an executor only after the cluster has been idle this long
    idle_secs: float = 30.0
    # decision loop cadence
    interval_secs: float = 1.0

    @staticmethod
    def from_settings(settings: Optional[Dict[str, str]] = None,
                      env: Optional[Dict[str, str]] = None
                      ) -> "AutoscalerConfig":
        s = settings or {}
        env = os.environ if env is None else env

        def raw(key: str):
            if key in s:
                return s[key]
            return env.get("BALLISTA_" + key.upper().replace(".", "_"))

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

        def boolean(key: str, default: bool) -> bool:
            v = raw(key)
            if v is None:
                return default
            from ...adaptive.config import _as_bool

            return _as_bool(v, key, default)

        cfg = AutoscalerConfig(
            enabled=boolean("autoscale.enabled", False),
            min_executors=number("autoscale.min_executors", 1, int),
            max_executors=number("autoscale.max_executors", 4, int),
            backlog_tasks=number("autoscale.backlog_tasks", 8, int),
            eta_secs=number("autoscale.eta_secs", 0.0),
            cooldown_secs=number("autoscale.cooldown_secs", 5.0),
            idle_secs=number("autoscale.idle_secs", 30.0),
            interval_secs=number("autoscale.interval_secs", 1.0),
        )
        if cfg.max_executors and cfg.min_executors > cfg.max_executors:
            raise ValueError(
                "autoscale.min_executors exceeds autoscale.max_executors"
            )
        return cfg


class Autoscaler:
    """The decision loop. ``signal_fn`` returns the demand snapshot
    (``backlog``, ``inflight``, ``executors``, ``eta_seconds``);
    ``spawn_fn()`` adds one executor, ``drain_fn()`` drains one idle
    executor and returns an identifier (or None when nothing is
    drainable). Both hooks run OUTSIDE the decision lock."""

    DECISION_RING = 256

    def __init__(self, config: AutoscalerConfig,
                 signal_fn: Callable[[], dict],
                 spawn_fn: Callable[[], object],
                 drain_fn: Callable[[], Optional[str]]):
        self.config = config
        self.signal_fn = signal_fn
        self.spawn_fn = spawn_fn
        self.drain_fn = drain_fn
        self._lock = threading.Lock()
        self._decisions: deque = deque(maxlen=self.DECISION_RING)
        self._last_action = 0.0
        self._idle_since: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.scale_ups_total = 0
        self.scale_downs_total = 0
        self.target = config.min_executors

    # -- loop ----------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("autoscaler tick failed")
            self._stop.wait(self.config.interval_secs)

    # -- one decision --------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """Evaluate the signals once; returns the action taken
        ("scale-up" | "scale-down") or None for a hold. Exposed for
        tests — the loop is just tick() on a timer."""
        cfg = self.config
        now = time.time() if now is None else now
        sig = self.signal_fn() or {}
        backlog = int(sig.get("backlog") or 0)
        inflight = int(sig.get("inflight") or 0)
        n = int(sig.get("executors") or 0)
        eta = float(sig.get("eta_seconds") or 0.0)
        busy = backlog > 0 or inflight > 0
        with self._lock:
            if busy:
                self._idle_since = None
            elif self._idle_since is None:
                self._idle_since = now
            idle_for = (now - self._idle_since
                        if self._idle_since is not None else 0.0)
            cooled = now - self._last_action >= cfg.cooldown_secs
        action = reason = None
        if n < cfg.min_executors:
            action, reason = "scale-up", "min-floor"
        elif cooled and n < cfg.max_executors and (
                backlog >= cfg.backlog_tasks
                or (cfg.eta_secs and eta >= cfg.eta_secs)):
            action = "scale-up"
            reason = ("backlog" if backlog >= cfg.backlog_tasks
                      else "eta")
        elif cooled and not busy and n > cfg.min_executors and \
                idle_for >= cfg.idle_secs:
            action, reason = "scale-down", "idle"
        if action is None:
            return None
        return self._act(action, reason, now,
                         backlog=backlog, inflight=inflight,
                         executors=n, eta=eta)

    def _act(self, action: str, reason: str, now: float, *,
             backlog: int, inflight: int, executors: int,
             eta: float) -> Optional[str]:
        drained = None
        try:
            if action == "scale-up":
                # chaos surface: a triggered fail skips this tick; the
                # demand signal persists so the next tick retries
                fault_point("autoscaler.spawn", executors=executors)
                self.spawn_fn()
            else:
                drained = self.drain_fn()
                if drained is None:
                    return None  # nothing idle enough to drain
        except FaultInjected as e:
            log.warning("autoscaler spawn fault injected; retrying "
                        "next tick: %s", e)
            return None
        except Exception:  # noqa: BLE001 - hook failure: hold
            log.exception("autoscaler %s hook failed", action)
            return None
        with self._lock:
            self._last_action = now
            if action == "scale-up":
                self.scale_ups_total += 1
                self.target = min(executors + 1,
                                  self.config.max_executors or
                                  executors + 1)
            else:
                self.scale_downs_total += 1
                self.target = max(executors - 1,
                                  self.config.min_executors)
            self._decisions.append({
                "decided_at": now,
                "action": action,
                "reason": reason,
                "executors": executors,
                "target": self.target,
                "backlog": backlog,
                "inflight_tasks": inflight,
                "eta_seconds": round(eta, 3) if eta else None,
                "drained": drained,
            })
        log.warning("autoscaler %s (%s): executors %d -> target %d "
                    "(backlog=%d inflight=%d eta=%.1fs)", action,
                    reason, executors, self.target, backlog, inflight,
                    eta)
        try:
            from ...observability.tracing import trace_event

            trace_event("controlplane.autoscale", action=action,
                        reason=reason, executors=executors,
                        target=self.target, backlog=backlog)
        except Exception:  # noqa: BLE001 - observability only
            pass
        return action

    def decision_rows(self) -> List[dict]:
        """``system.autoscaler``: recent decisions, oldest first."""
        with self._lock:
            return [dict(r) for r in self._decisions]


class SubprocessExecutorLauncher:
    """Spawn/drain hooks over the real executor binary
    (``python -m ballista_tpu_torch.distributed.executor_main``). Spawned
    processes inherit the environment plus any overrides; drain sends
    SIGTERM — executor_main's graceful-drain signal — to the youngest
    live child (LIFO keeps the launch-time fleet stable)."""

    def __init__(self, scheduler_host: str, scheduler_port: int,
                 extra_args: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None):
        self.scheduler_host = scheduler_host
        self.scheduler_port = scheduler_port
        self.extra_args = list(extra_args or [])
        self.env = env
        self._procs: List[subprocess.Popen] = []
        self._lock = threading.Lock()

    def spawn(self) -> subprocess.Popen:
        argv = [
            sys.executable, "-m",
            "ballista_tpu_torch.distributed.executor_main",
            "--scheduler-host", self.scheduler_host,
            "--scheduler-port", str(self.scheduler_port),
        ] + self.extra_args
        proc = subprocess.Popen(argv, env=self.env)
        with self._lock:
            self._procs.append(proc)
        log.info("spawned executor subprocess pid=%d", proc.pid)
        return proc

    def drain(self) -> Optional[str]:
        import signal as _signal

        with self._lock:
            self._reap_locked()
            if not self._procs:
                return None
            proc = self._procs.pop()
        proc.send_signal(_signal.SIGTERM)
        log.info("draining executor subprocess pid=%d (SIGTERM)",
                 proc.pid)
        return str(proc.pid)

    def _reap_locked(self) -> None:
        self._procs = [p for p in self._procs if p.poll() is None]

    def alive(self) -> int:
        with self._lock:
            self._reap_locked()
            return len(self._procs)

    def stop_all(self, timeout: float = 10.0) -> None:
        with self._lock:
            procs, self._procs = self._procs, []
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
