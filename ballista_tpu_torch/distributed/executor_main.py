"""Executor binary: ``python -m ballista_tpu_torch.distributed.executor_main``.

(reference: rust/executor/src/main.rs:55-164 + executor_config_spec.toml
— layered config: defaults < /etc/ballista-tpu/executor.toml <
--config-file < env BALLISTA_EXECUTOR_* < CLI flags; ``--local`` embeds
a standalone scheduler in-process like the reference's local mode.)

The port of the JAX package's binary: ``--device`` (``cuda`` by default,
``cpu`` when asked) is the one torch device every task runs on, and the
executor reports that one device to the scheduler. Meshes are not
ported (ROADMAP queue 1 item 10): ``--mesh-group-size`` above 1 raises,
and the reference's ``--num-devices`` and other mesh-group options are
not accepted.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

from .config import layered_config

DEFAULTS = {
    "namespace": "default",
    "scheduler_host": "localhost",
    "scheduler_port": 50050,
    "bind_host": "localhost",
    "external_host": "",
    "port": 0,  # data-plane port (0 = ephemeral)
    "work_dir": "",
    "concurrent_tasks": 4,
    # mesh group: executors on several hosts forming ONE device mesh;
    # not ported, so above 1 raises (module doc)
    "mesh_group_size": 0,
    # C++ shuffle-server daemon serves the data plane (GIL-free); "off"
    # keeps the in-process Python server (also the automatic fallback)
    "native_dataplane": "on",
    "metrics_port": 0,  # health plane (/healthz, /metrics); -1 = off
    "log_level": "INFO",
    "device": "cuda",  # torch device of every task; "cpu" when asked
}


def main(argv=None) -> int:
    # sigwait below only receives a signal that is BLOCKED; without
    # this mask SIGTERM takes the default disposition (immediate kill)
    # and the graceful-drain path never runs on the real binary.
    # Masked first thing so every thread the executor spawns inherits
    # the block and only the main thread's sigwait consumes the signal.
    signal.pthread_sigmask(signal.SIG_BLOCK,
                           {signal.SIGINT, signal.SIGTERM})
    ap = argparse.ArgumentParser(description="ballista-tpu executor")
    ap.add_argument("--config-file", default=None)
    ap.add_argument("--local", action="store_true",
                    help="embed a standalone scheduler in-process")
    for key in DEFAULTS:
        ap.add_argument("--" + key.replace("_", "-"), default=None)
    args = ap.parse_args(argv)

    cfg = layered_config(
        "executor", DEFAULTS, args.config_file,
        cli={k: getattr(args, k) for k in DEFAULTS},
    )

    logging.basicConfig(
        level=cfg["log_level"].upper(),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )

    from ..client import _resolve_device
    from ..errors import NotImplementedError_
    from .dataplane import native_dataplane_enabled as _native_enabled
    from .executor import Executor, ExecutorConfig

    group_size = int(cfg["mesh_group_size"])
    if group_size > 1:
        raise NotImplementedError_(
            "mesh groups are not ported yet (ROADMAP queue 1 item 10)")
    device = _resolve_device(cfg["device"])

    scheduler_port = cfg["scheduler_port"]
    if args.local:
        from .scheduler import serve_scheduler
        from .state import MemoryBackend, SchedulerState

        state = SchedulerState(MemoryBackend(), cfg["namespace"])
        # the embedded scheduler runs server-planned scalar subqueries
        # on the executor's device, as LocalCluster's does
        _server, _svc, scheduler_port = serve_scheduler(
            state, "localhost", 0, device=device
        )
        print(f"embedded scheduler on localhost:{scheduler_port}", flush=True)

    exec_cfg = ExecutorConfig(
        host=cfg["external_host"] or cfg["bind_host"],
        bind_host=cfg["bind_host"],
        port=cfg["port"],
        work_dir=cfg["work_dir"] or None,
        concurrent_tasks=cfg["concurrent_tasks"],
        scheduler_host="localhost" if args.local else cfg["scheduler_host"],
        scheduler_port=scheduler_port,
        native_dataplane=_native_enabled(cfg["native_dataplane"]),
        metrics_port=int(cfg["metrics_port"]),
        device=device,
    )
    executor = Executor(exec_cfg)
    executor.start()
    print(
        f"ballista-tpu executor {executor.id[:8]} polling "
        f"{exec_cfg.scheduler_host}:{exec_cfg.scheduler_port}, data plane on "
        f"{exec_cfg.host}:{executor.port}, work_dir={exec_cfg.work_dir}, "
        f"device={device}",
        flush=True,
    )
    if executor.health_port is not None:
        print(f"ballista-tpu executor health plane on "
              f"127.0.0.1:{executor.health_port}", flush=True)
    stop = signal.sigwait([signal.SIGINT, signal.SIGTERM])
    drain = stop == signal.SIGTERM
    print(f"signal {stop}; shutting down"
          + (" (graceful drain)" if drain else ""), flush=True)
    # SIGTERM (the orchestrator's polite stop) drains: stop accepting,
    # let in-flight tasks finish within the bound, flush pending status
    # reports. SIGINT (ctrl-C) keeps the immediate shutdown.
    executor.stop(drain=drain)
    return 0


if __name__ == "__main__":
    sys.exit(main())
