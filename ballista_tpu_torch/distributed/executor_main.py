"""Executor binary: ``python -m ballista_tpu_torch.distributed.executor_main``.

(reference: rust/executor/src/main.rs:55-164 + executor_config_spec.toml
— layered config: defaults < /etc/ballista-tpu/executor.toml <
--config-file < env BALLISTA_EXECUTOR_* < CLI flags; ``--local`` embeds
a standalone scheduler in-process like the reference's local mode.)

The port of the JAX package's binary: ``--device`` (``cuda`` by default,
``cpu`` when asked) is the torch device every task runs on, and
``--num-devices`` n is the number of mesh slots the executor reports to
the scheduler, all on that device (default 1; n >= 2 lets the scheduler
fuse mesh stages). ``--mesh-group-size`` k > 1 joins k such processes
into one mesh group (``parallel/multihost.py``,
``distributed/mesh_group.py``): rank 0 (``--mesh-group-rank``) leads and
reports k x n slots, the others follow; ``--mesh-group-coordinator``
is rank 0's ``host:port`` for the group's TCP store and
``--mesh-group-channel`` the leader's task channel. The JAX package's
``--mesh-local-devices`` (virtual CPU devices per process) is accepted
and, when set, overrides ``--num-devices`` inside a group.

SIGINT/SIGTERM stop the binary through signal handlers, as
``scheduler_main`` does (``_wait_for_stop``), not the JAX binary's
blocked mask and ``sigwait``.
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
    "num_devices": 1,  # mesh slots on --device
    # -- mesh group: executor processes forming ONE mesh (module doc) --
    "mesh_group_size": 0,  # processes in the group; 0 = no group
    "mesh_group_rank": 0,  # this process's rank (0 = leader)
    "mesh_group_coordinator": "",  # rank 0's TCP store host:port
    "mesh_group_channel": "",  # leader's task channel (host:port);
    #                            leader binds it, followers dial it
    "mesh_local_devices": 0,  # slots per process in a group (0 = --num-devices)
    # C++ shuffle-server daemon serves the data plane (GIL-free); "off"
    # keeps the in-process Python server (also the automatic fallback)
    "native_dataplane": "on",
    "metrics_port": 0,  # health plane (/healthz, /metrics); -1 = off
    "log_level": "INFO",
    "device": "cuda",  # torch device of every task; "cpu" when asked
}


_STOP_SIGNALS: list = []


def _on_stop_signal(signum, _frame) -> None:
    _STOP_SIGNALS.append(signum)


def _wait_for_stop() -> int:
    """The first SIGINT or SIGTERM since ``main`` started.

    Handlers, not the JAX binary's blocked mask and ``sigwait``: threads
    that start while the package imports, before ``main`` can mask
    anything (numpy's BLAS threads, torch's), do not block the signals,
    so a SIGTERM the kernel hands one of them takes its default action
    and kills the process before the drain (exit -15). A handler runs
    whichever thread the signal lands on, and the main thread sees it
    here."""
    import time as _time

    while not _STOP_SIGNALS:
        _time.sleep(0.1)
    return _STOP_SIGNALS[0]


def main(argv=None) -> int:
    # installed first thing: a stop signal from now on is recorded for
    # _wait_for_stop, whatever thread receives it
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _on_stop_signal)
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

    group_opts = [k for k in ("mesh_group_rank", "mesh_group_coordinator",
                              "mesh_group_channel", "mesh_local_devices")
                  if str(cfg[k]) not in ("", "0")]
    if int(cfg["mesh_group_size"]) <= 1 and group_opts:
        ap.error(", ".join("--" + k.replace("_", "-") for k in group_opts)
                 + " configure a mesh group: they need --mesh-group-size "
                 "above 1")
    if int(cfg["mesh_group_size"]) > 1 and not (
            cfg["mesh_group_coordinator"] and cfg["mesh_group_channel"]):
        ap.error(f"--mesh-group-size {cfg['mesh_group_size']} needs "
                 "--mesh-group-coordinator and --mesh-group-channel "
                 "(host:port each)")

    logging.basicConfig(
        level=cfg["log_level"].upper(),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )

    from ..client import _resolve_device
    from .dataplane import native_dataplane_enabled as _native_enabled
    from .executor import Executor, ExecutorConfig

    device = _resolve_device(cfg["device"])
    num_devices = int(cfg["num_devices"])
    group_size = int(cfg["mesh_group_size"])
    group_rank = int(cfg["mesh_group_rank"])
    leader = None
    if group_size > 1:
        # join the group's process group first: every member must, or
        # the first to reach a collective waits for the rest
        from ..parallel import multihost

        local = int(cfg["mesh_local_devices"]) or num_devices
        multihost.init_group(cfg["mesh_group_coordinator"], group_size,
                             group_rank, local_device_count=local,
                             device=device)
        num_devices = local * group_size
        print(f"mesh group rank {group_rank}: global mesh has "
              f"{num_devices} slots", flush=True)
        host, _, port_s = cfg["mesh_group_channel"].rpartition(":")
        from . import mesh_group

        if group_rank == 0:
            leader = mesh_group.GroupLeader(
                cfg["bind_host"], int(port_s), group_size - 1
            )
            print(f"mesh group leader channel on "
                  f"{cfg['bind_host']}:{leader.port}; waiting for "
                  f"{group_size - 1} follower(s)", flush=True)
            leader.wait_members()
        else:
            print(f"mesh group follower rank {group_rank} joining "
                  f"{host}:{port_s}", flush=True)
            # a follower has nothing to drain: a stop signal ends it
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.signal(signal.SIGINT, signal.default_int_handler)
            mesh_group.run_follower(host or "localhost", int(port_s),
                                    device=device)
            # the leader closed the channel: the group is done (no
            # barrier: the leader may be gone already)
            multihost.shutdown_group(barrier=False)
            return 0

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
        num_devices=num_devices,
        native_dataplane=_native_enabled(cfg["native_dataplane"]),
        metrics_port=int(cfg["metrics_port"]),
        device=device,
    )
    executor = Executor(exec_cfg, mesh_group=leader)
    executor.start()
    print(
        f"ballista-tpu executor {executor.id[:8]} polling "
        f"{exec_cfg.scheduler_host}:{exec_cfg.scheduler_port}, data plane on "
        f"{exec_cfg.host}:{executor.port}, work_dir={exec_cfg.work_dir}, "
        f"device={device}, slots={num_devices}"
        + (f", mesh group of {group_size} x "
           f"{num_devices // group_size} devices" if leader else ""),
        flush=True,
    )
    if executor.health_port is not None:
        print(f"ballista-tpu executor health plane on "
              f"127.0.0.1:{executor.health_port}", flush=True)
    stop = _wait_for_stop()
    drain = stop == signal.SIGTERM
    print(f"signal {stop}; shutting down"
          + (" (graceful drain)" if drain else ""), flush=True)
    if leader is not None:
        leader.close()
    # SIGTERM (the orchestrator's polite stop) drains: stop accepting,
    # let in-flight tasks finish within the bound, flush pending status
    # reports. SIGINT (ctrl-C) keeps the immediate shutdown.
    executor.stop(drain=drain)
    if leader is not None:
        multihost.shutdown_group(barrier=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
