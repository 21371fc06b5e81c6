"""Scheduler binary: ``python -m ballista_tpu_torch.distributed.scheduler_main``.

(reference: rust/scheduler/src/main.rs:43-115 + scheduler_config_spec.toml
— layered config: defaults < /etc/ballista-tpu/scheduler.toml <
--config-file < env BALLISTA_SCHEDULER_* < CLI flags.)

The port of the JAX package's binary. The scheduler runs no task; the
one query work it does itself is a server-planned query's scalar
subqueries, which run on ``--device`` (``cuda`` by default, the JAX
binary's default device; a scheduler that receives none creates no CUDA
context). State lives in memory, in sqlite or in etcd (``--state
etcd:host:port`` or ``--etcd-urls``). ``--flight-port`` serves Arrow
Flight (``flight.py``): a ``DoGet`` whose ticket is raw SQL runs through
a loopback remote context on ``--device``, which resolves the query's
scalar subqueries there, as the JAX binary's loopback context does on
its default device; the rest runs on the executors' devices.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

from .config import layered_config

DEFAULTS = {
    "namespace": "default",
    "bind_host": "0.0.0.0",
    "port": 50050,
    "config_backend": "memory",  # memory | sqlite | etcd
    "sqlite_path": "ballista-state.db",
    "etcd_urls": "localhost:2379",
    "speculation_secs": 60,  # duplicate stragglers after this; 0 = off
    "flight_port": -1,  # Arrow Flight SQL front-end; -1 = off, 0 = ephemeral
    "metrics_port": 0,  # health plane (/healthz, /metrics); -1 = off
    "log_level": "INFO",
    # durable control plane: --state sqlite:/path or etcd:host:port is
    # shorthand for config_backend + its path/urls in one flag
    "state": "",
    # demand-driven autoscaler (off unless on): spawns/drains
    # executor_main subprocesses against this scheduler; bounds and
    # thresholds ride the autoscale.* knob family (BALLISTA_AUTOSCALE_*)
    "autoscale": "off",
    # where server-planned scalar subqueries and the Flight loopback
    # context's run: cuda | cpu
    "device": "cuda",
}


_STOP_SIGNALS: list = []


def _on_stop_signal(signum, _frame) -> None:
    _STOP_SIGNALS.append(signum)


def _wait_for_stop() -> int:
    """The first SIGINT or SIGTERM since ``main`` started.

    Handlers, not the JAX binary's blocked mask and ``sigwait``: the
    threads numpy's BLAS starts while the package imports, before
    ``main`` can mask anything, do not block the signals, so a SIGTERM
    the kernel hands one of them takes its default action and kills the
    process before the drain (exit -15). A handler runs whichever
    thread the signal lands on, and the main thread sees it here."""
    import time as _time

    while not _STOP_SIGNALS:
        _time.sleep(0.1)
    return _STOP_SIGNALS[0]


def main(argv=None) -> int:
    # installed first thing: a stop signal from now on is recorded for
    # _wait_for_stop, whatever thread receives it
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _on_stop_signal)
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
        elif kind == "etcd" and rest:
            cfg["etcd_urls"] = rest
    backends = ("memory", "sqlite", "etcd")
    if cfg["config_backend"] not in backends:
        # validate post-layering so env/TOML typos fail loudly instead of
        # silently falling back to the in-memory backend
        ap.error(f"config_backend must be one of {backends}, "
                 f"got {cfg['config_backend']!r}")

    logging.basicConfig(
        level=cfg["log_level"].upper(),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    from .scheduler import serve_scheduler
    from .state import MemoryBackend, SchedulerState, SqliteBackend

    if cfg["config_backend"] == "sqlite":
        backend = SqliteBackend(cfg["sqlite_path"])
    elif cfg["config_backend"] == "etcd":
        from .etcd import EtcdBackend

        backend = EtcdBackend(cfg["etcd_urls"])
    else:
        backend = MemoryBackend()
    state = SchedulerState(backend, cfg["namespace"])
    server, _svc, port = serve_scheduler(
        state, cfg["bind_host"], cfg["port"],
        speculation_age_secs=float(cfg["speculation_secs"]),
        metrics_port=int(cfg["metrics_port"]), device=cfg["device"],
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
    flight_server = None
    if int(cfg["flight_port"]) >= 0:
        flight_server = _serve_flight(cfg, port, ap)
    if _svc.health is not None:
        print(f"ballista-tpu scheduler health plane on "
              f"127.0.0.1:{_svc.health.port}", flush=True)
    stop = _wait_for_stop()
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
    if flight_server is not None:
        flight_server.shutdown()
    _svc.close_health()
    server.stop(grace=2)
    return 0


def _serve_flight(cfg, port: int, ap):
    """Arrow Flight front-end: foreign clients (the reference's JDBC
    driver shape — jdbc:arrow://host:flight_port) send raw SQL as a
    DoGet ticket; the query runs through the NORMAL cluster path
    (submit -> schedule -> executors -> fetch) via a loopback client
    context on the scheduler's device, where its scalar subqueries
    run."""
    from ..client import BallistaContext
    from .flight import available as flight_available, serve_flight

    if not flight_available():
        ap.error("--flight-port requires pyarrow.flight")
    # loopback target: a wildcard/loopback bind is reachable via
    # 127.0.0.1; a specific interface is only reachable at that addr
    loop_host = ("127.0.0.1"
                 if cfg["bind_host"] in ("0.0.0.0", "::", "localhost",
                                         "127.0.0.1")
                 else cfg["bind_host"])
    fctx = BallistaContext.remote(loop_host, port,
                                  device=cfg["device"])

    def execute_sql(sql):
        df = fctx.sql(sql)
        if df._plan is None and df._raw_sql is None:  # DDL: CREATE
            import numpy as np  # EXTERNAL TABLE registered above

            return {"status": np.asarray(["OK"], dtype=object)}
        return df.collect()

    flight_server, fport = serve_flight(
        cfg["bind_host"], int(cfg["flight_port"]), execute_sql=execute_sql)
    print(f"ballista-tpu Arrow Flight SQL endpoint on "
          f"{cfg['bind_host']}:{fport}", flush=True)
    return flight_server


if __name__ == "__main__":
    sys.exit(main())
