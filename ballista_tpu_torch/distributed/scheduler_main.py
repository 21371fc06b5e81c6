"""Scheduler binary: ``python -m ballista_tpu_torch.distributed.scheduler_main``.

(reference: rust/scheduler/src/main.rs:43-115 + scheduler_config_spec.toml
— layered config: defaults < /etc/ballista-tpu/scheduler.toml <
--config-file < env BALLISTA_SCHEDULER_* < CLI flags.)

The port of the JAX package's binary. The scheduler runs no task, so it
needs no device. Memory and sqlite state work; ``--state etcd:...`` and
``--flight-port`` raise: ``etcd.py``, ``proto/etcd_pb2.py`` and
``flight.py`` are not ported (ROADMAP queue 1 item 9b).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

from ..errors import NotImplementedError_
from .config import layered_config

DEFAULTS = {
    "namespace": "default",
    "bind_host": "0.0.0.0",
    "port": 50050,
    "config_backend": "memory",  # memory | sqlite | etcd
    "sqlite_path": "ballista-state.db",
    "speculation_secs": 60,  # duplicate stragglers after this; 0 = off
    "flight_port": -1,  # Arrow Flight SQL front-end; -1 = off, 0 = ephemeral
    "metrics_port": 0,  # health plane (/healthz, /metrics); -1 = off
    "log_level": "INFO",
    # durable control plane: --state sqlite:/path is shorthand for
    # config_backend + its path in one flag (etcd: raises, module doc)
    "state": "",
    # demand-driven autoscaler (off unless on): spawns/drains
    # executor_main subprocesses against this scheduler; bounds and
    # thresholds ride the autoscale.* knob family (BALLISTA_AUTOSCALE_*)
    "autoscale": "off",
}


def main(argv=None) -> int:
    # sigwait below only receives a signal that is BLOCKED; without
    # this mask SIGTERM takes the default disposition (immediate kill)
    # and the graceful-drain path never runs. Masked first thing so
    # every thread the server spawns inherits the block and the signal
    # can only be consumed by the main thread's sigwait.
    signal.pthread_sigmask(signal.SIG_BLOCK,
                           {signal.SIGINT, signal.SIGTERM})
    ap = argparse.ArgumentParser(description="ballista-tpu scheduler")
    ap.add_argument("--config-file", default=None)
    for key in DEFAULTS:
        ap.add_argument("--" + key.replace("_", "-"), default=None)
    args = ap.parse_args(argv)

    cfg = layered_config(
        "scheduler", DEFAULTS, args.config_file,
        cli={k: getattr(args, k) for k in DEFAULTS},
    )
    if cfg["state"]:
        # --state sqlite:<path> | etcd:<urls> | memory
        kind, _, rest = str(cfg["state"]).partition(":")
        cfg["config_backend"] = kind
        if kind == "sqlite" and rest:
            cfg["sqlite_path"] = rest
    backends = ("memory", "sqlite", "etcd")
    if cfg["config_backend"] not in backends:
        # validate post-layering so env/TOML typos fail loudly instead of
        # silently falling back to the in-memory backend
        ap.error(f"config_backend must be one of {backends}, "
                 f"got {cfg['config_backend']!r}")

    if int(cfg["flight_port"]) >= 0:
        # checked before anything starts: the Arrow Flight front-end
        raise NotImplementedError_(
            "--flight-port: the Arrow Flight endpoint is not ported yet "
            "(ROADMAP queue 1 item 9b)")

    logging.basicConfig(
        level=cfg["log_level"].upper(),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    from .scheduler import serve_scheduler
    from .state import MemoryBackend, SchedulerState, SqliteBackend

    if cfg["config_backend"] == "sqlite":
        backend = SqliteBackend(cfg["sqlite_path"])
    elif cfg["config_backend"] == "etcd":
        raise NotImplementedError_(
            "etcd state is not ported yet (ROADMAP queue 1 item 9b); "
            "use --state memory or --state sqlite:<path>")
    else:
        backend = MemoryBackend()
    state = SchedulerState(backend, cfg["namespace"])
    server, _svc, port = serve_scheduler(
        state, cfg["bind_host"], cfg["port"],
        speculation_age_secs=float(cfg["speculation_secs"]),
        metrics_port=int(cfg["metrics_port"]),
    )
    print(f"ballista-tpu scheduler listening on {cfg['bind_host']}:{port} "
          f"(backend={cfg['config_backend']}, ns={cfg['namespace']})",
          flush=True)
    # restart recovery: one explicit pass BEFORE executors poll — a
    # durable backend rebuilds the admission queue, replays planning
    # lost mid-flight and fails orphans loudly (memory backend: no-op)
    report = _svc.recover()
    print("control-plane recovery: "
          f"recovered_jobs={report.recovered_jobs} "
          f"queued_restored={report.queued_restored} "
          f"relaunched={report.relaunched} "
          f"inflight={report.jobs_inflight} "
          f"orphans_failed={report.orphans_failed} "
          f"tasks_requeued={report.tasks_requeued} "
          f"seconds={report.recovery_seconds}", flush=True)
    launcher = None
    if str(cfg["autoscale"]).lower() in ("on", "1", "true", "yes"):
        from .controlplane import (AutoscalerConfig,
                                   SubprocessExecutorLauncher)

        as_cfg = AutoscalerConfig.from_settings({"autoscale.enabled":
                                                 "on"})
        loop_host = ("127.0.0.1"
                     if cfg["bind_host"] in ("0.0.0.0", "::", "localhost",
                                             "127.0.0.1")
                     else cfg["bind_host"])
        launcher = SubprocessExecutorLauncher(loop_host, port)
        _svc.attach_autoscaler(as_cfg, launcher.spawn,
                               drain_fn=launcher.drain)
        print(f"autoscaler on: executors {as_cfg.min_executors}.."
              f"{as_cfg.max_executors} (backlog>={as_cfg.backlog_tasks}"
              f", cooldown={as_cfg.cooldown_secs}s)", flush=True)
    if _svc.health is not None:
        print(f"ballista-tpu scheduler health plane on "
              f"127.0.0.1:{_svc.health.port}", flush=True)
    stop = signal.sigwait([signal.SIGINT, signal.SIGTERM])
    if stop == signal.SIGTERM:
        # graceful degradation (admission ladder's last rung): shed NEW
        # submissions while admitted work finishes, bounded by the same
        # drain knob executors use
        print(f"signal {stop}; draining (new submissions are shed)",
              flush=True)
        _svc.begin_drain()
        import time as _time

        from .executor import drain_timeout_secs

        deadline = _time.time() + drain_timeout_secs()
        while _time.time() < deadline:
            try:
                if not _svc.progress.live_snapshots() and \
                        _svc.admission.queue_depth() == 0:
                    break
            except Exception:  # noqa: BLE001 - shutdown path
                break
            _time.sleep(0.25)
    else:
        print(f"signal {stop}; shutting down", flush=True)
    if launcher is not None:
        launcher.stop_all()
    _svc.close_health()
    server.stop(grace=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
