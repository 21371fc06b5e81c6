"""The port's multi-tenant serving line: K concurrent sessions against
ONE warm ``LocalCluster`` on the card, plus the durable control plane's
phases (restart recovery, demand-driven autoscaling). The counterpart of
the repo's ``bench_serving.py``, which measures the JAX package, with
the same phases, fields and query mix.

Each session is its own ``BallistaContext`` (own ``session.id``, so the
admission plane and ``system.sessions`` metering see real tenants)
running a mixed TPC-H workload (q1/q3/q5/q12/q16/q18, rotated per
session so the plan-shape interleaving differs across tenants) through
the admission gate. Prints ONE JSON line:

    {"metric": "serving_qps", "value": <queries/s>,
     "serving_p50_seconds": ..., "serving_p99_seconds": ...,
     "serving_sheds": ..., "serving_errors": ..., ...}

The serving line also carries the always-on latency ledger's per-lane
view (docs/observability.md): ``serving_<phase>_p50_seconds`` /
``serving_<phase>_p99_seconds`` for every ledger phase, the number of
storm ledgers observed (``serving_ledgers``) and ``p99_attribution`` —
the lane(s) where the p99 exemplar query diverges most from the p50
centroid, i.e. the place to look first when the tail regresses.

``--phase restart`` measures scheduler restart recovery over a durable
sqlite backend: submit a mixed batch (one admitted + planned, the rest
queued), abandon the service mid-flight, rebuild it on the same file
and time ``recover()`` — the line carries ``recovery_seconds`` and
``recovered_jobs``. ``--phase autoscale`` storms a min-sized cluster
with a 2x session burst under the autoscaler and reports
``autoscale_events`` and the burst's tail latency
(``autoscale_p99_seconds``).

``dev/check_bench_regress.py`` gates serving_qps (higher), the latency
percentiles and recovery_seconds (lower), recovered_jobs /
autoscale_events (nonzero) and the error counts (zero) between two such
lines; it reads the port's lines as they are. Every line also names its
device (``device``, ``power_limit_w``: the card's name and power limit
as nvidia-smi reports them).

Usage:
    python -m ballista_tpu_torch.bench_serving
        [--phase serving|restart|autoscale] [--scale 0.05] [--data DIR]
        [--sessions 4] [--queries-per-session 6] [--executors 2]
        [--slots 2] [--max-running 4] [--session-quota 2]
        [--device cuda|cpu]

The executors run their tasks on ``--device`` (default ``cuda``; without
a card the run exits non-zero unless ``--device cpu``); the scheduler
plans on the CPU. Wall clocks stop after the collect has its rows on the
host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from .benchmarks import (REPO_ROOT, add_device_argument, card_info,
                         ensure_tpch, query_sql, register_tables,
                         require_device)

QUERY_MIX = ("q1", "q3", "q5", "q12", "q16", "q18")


def _percentile(sorted_vals, p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(round(p * (len(sorted_vals) - 1))),
              len(sorted_vals) - 1)
    return sorted_vals[idx]


def _ledger_phase_vals(ledgers, phase: str):
    """Sorted per-query seconds of one ledger phase (the synthetic
    ``unattributed`` phase reads the remainder field)."""
    if phase == "unattributed":
        vals = [float(e.get("unattributed_seconds", 0.0))
                for e in ledgers]
    else:
        vals = [float((e.get("phases") or {}).get(phase, 0.0))
                for e in ledgers]
    return sorted(vals)


def _p99_attribution(ledgers) -> str:
    """Name the lane(s) where the p99 exemplar query diverges most from
    the per-lane p50 centroid — "where did the tail go". Lanes within
    25% of the worst divergence all make the cut (joined with ``+``);
    a perfectly flat tail falls back to the exemplar's largest lane,
    so the attribution is non-empty whenever any ledger exists."""
    if not ledgers:
        return ""
    from .observability.ledger import LEDGER_PHASES

    by_wall = sorted(ledgers,
                     key=lambda e: float(e.get("wall_seconds", 0.0)))
    exemplar = by_wall[min(int(round(0.99 * (len(by_wall) - 1))),
                           len(by_wall) - 1)]
    ex_phases = dict(exemplar.get("phases") or {})
    ex_phases["unattributed"] = float(
        exemplar.get("unattributed_seconds", 0.0))
    divergence = {}
    for phase in (*LEDGER_PHASES, "unattributed"):
        p50 = _percentile(_ledger_phase_vals(ledgers, phase), 0.50)
        divergence[phase] = float(ex_phases.get(phase, 0.0)) - p50
    top = max(divergence.values())
    if top <= 0:
        return max(ex_phases, key=lambda p: ex_phases.get(p, 0.0))
    return "+".join(p for p, d in sorted(divergence.items(),
                                         key=lambda kv: -kv[1])
                    if d >= 0.25 * top)


def run_serving(data_dir: str, sessions: int = 4,
                queries_per_session: int = 6, executors: int = 2,
                slots: int = 2, max_running: int = 4,
                session_quota: int = 2, job_timeout: float = 600.0,
                mix=QUERY_MIX, device="cuda", on_result=None) -> dict:
    """The measured phase: warm the cluster (one pass over the mix on a
    warmup session — jit compiles amortize exactly like a long-lived
    serving deployment), then storm it with K concurrent sessions and
    report latency percentiles, throughput and admission decisions.
    ``on_result(query, rows)``, when given, receives every completed
    query's ``to_pydict()`` (from the session threads too)."""
    from .client import BallistaContext
    from .distributed.executor import LocalCluster
    from .errors import AdmissionRejected
    from .observability import ledger as obs_ledger

    sqls = {q: query_sql(q) for q in mix}

    # per-lane latency attribution: the LocalCluster's scheduler runs
    # in-process, so its assembled job ledgers land in THIS process's
    # ledger log — size it to hold the whole storm (for this phase only)
    saved_log = os.environ.get("BALLISTA_LEDGER_LOG")
    os.environ.setdefault(
        "BALLISTA_LEDGER_LOG",
        str(max(4096, 2 * sessions * queries_per_session)))
    obs_ledger.reset_process_log()

    cluster = None
    try:
        cluster = LocalCluster(num_executors=executors,
                               concurrent_tasks=slots, device=device)
        # -- warm pass: one unloaded run of every mix query ----------------
        warm_ctx = BallistaContext.remote(
            "localhost", cluster.port, device=device,
            **{"job.timeout": str(job_timeout),
               "session.id": "serving-warmup"})
        register_tables(warm_ctx, data_dir)
        solo = {}
        for q in mix:
            t0 = time.time()
            out = warm_ctx.sql(sqls[q]).to_pydict()
            solo[q] = round(time.time() - t0, 4)
            if on_result is not None:
                on_result(q, out)

        # -- the storm -----------------------------------------------------
        svc = cluster.service
        admitted0 = svc.admission.admitted_total
        sheds0 = svc.admission.sheds_total
        latencies: list = []
        errors: list = []
        lat_lock = threading.Lock()
        peak_queue = [0]
        stop = threading.Event()

        def watch_queue():
            while not stop.is_set():
                peak_queue[0] = max(peak_queue[0],
                                    svc.admission.queue_depth())
                time.sleep(0.05)

        watcher = threading.Thread(target=watch_queue, daemon=True)
        watcher.start()

        def run_session(idx: int):
            settings = {
                "job.timeout": str(job_timeout),
                "session.id": f"serving-{idx}",
                "admission.max_running_jobs": str(max_running),
                "admission.max_session_jobs": str(session_quota),
            }
            ctx = BallistaContext.remote("localhost", cluster.port,
                                         device=device, **settings)
            register_tables(ctx, data_dir)
            for j in range(queries_per_session):
                q = mix[(idx + j) % len(mix)]
                t0 = time.time()
                try:
                    out = ctx.sql(sqls[q]).to_pydict()
                except AdmissionRejected as e:
                    # terminal shed (client retries exhausted): counted
                    # separately — not an engine error
                    with lat_lock:
                        errors.append((q, f"shed:{e.reason}"))
                except Exception as e:  # noqa: BLE001 - recorded
                    with lat_lock:
                        errors.append((q, f"{type(e).__name__}: {e}"))
                else:
                    with lat_lock:
                        latencies.append((q, time.time() - t0))
                    if on_result is not None:
                        on_result(q, out)

        threads = [threading.Thread(target=run_session, args=(i,))
                   for i in range(sessions)]
        t0 = time.time()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.time() - t0
        stop.set()
        watcher.join(1)

        lats = sorted(s for _, s in latencies)
        per_query = {}
        for q, s in latencies:
            per_query.setdefault(q, []).append(s)
        # storm-window ledgers only (warmup recorded before t0): where
        # each query's wall time went, phase by phase
        ledgers = [e for e in
                   obs_ledger.process_ledger_log().entries(since=t0)
                   if e.get("origin") == "cluster"
                   and e.get("status") == "completed"]
        result = {
            "metric": "serving_qps",
            "unit": "queries/s",
            "value": round(len(lats) / wall, 3) if wall > 0 else 0.0,
            "serving_wall_seconds": round(wall, 3),
            "serving_sessions": sessions,
            "serving_queries": sessions * queries_per_session,
            "serving_completed": len(lats),
            "serving_errors": len([e for e in errors
                                   if not e[1].startswith("shed:")]),
            "serving_sheds": (svc.admission.sheds_total - sheds0),
            "serving_admitted": (svc.admission.admitted_total
                                 - admitted0),
            "serving_peak_queue_depth": peak_queue[0],
            "serving_p50_seconds": round(_percentile(lats, 0.50), 4),
            "serving_p99_seconds": round(_percentile(lats, 0.99), 4),
            "serving_max_seconds": round(lats[-1], 4) if lats else 0.0,
            "serving_solo_seconds": solo,
            "serving_query_p50": {
                q: round(_percentile(sorted(v), 0.5), 4)
                for q, v in sorted(per_query.items())},
            "serving_ledgers": len(ledgers),
            "p99_attribution": _p99_attribution(ledgers),
        }
        for phase in obs_ledger.LEDGER_PHASES:
            vals = _ledger_phase_vals(ledgers, phase)
            result[f"serving_{phase}_p50_seconds"] = round(
                _percentile(vals, 0.50), 4)
            result[f"serving_{phase}_p99_seconds"] = round(
                _percentile(vals, 0.99), 4)
        if errors:
            result["serving_error_sample"] = str(errors[:3])[:300]
        return result
    finally:
        if cluster is not None:
            cluster.shutdown()
        if saved_log is None:
            os.environ.pop("BALLISTA_LEDGER_LOG", None)
        else:
            os.environ["BALLISTA_LEDGER_LOG"] = saved_log


def _tpch_query_params(sql: str, data_dir: str, settings: dict, device):
    """ExecuteQueryParams for server-side SQL planning: the raw query
    plus one catalog descriptor per TPC-H table (what submit_sql ships
    over the wire, built directly for in-process service calls)."""
    from . import serde
    from .io import TblSource
    from .proto import ballista_pb2 as pb
    from .testing.tpch_schema import TPCH_PKS, TPCH_SCHEMAS

    params = pb.ExecuteQueryParams()
    params.sql = sql
    for k, v in settings.items():
        params.settings[k] = v
    for name, sch in TPCH_SCHEMAS.items():
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            path = os.path.join(data_dir, f"{name}.tbl")
        entry = params.catalog.add()
        entry.name = name
        entry.source.CopyFrom(
            serde.source_to_proto(TblSource(path, sch, device=device),
                                  TPCH_PKS[name]))
    return params


def run_restart(data_dir: str, jobs: int = 6, mix=QUERY_MIX,
                job_timeout: float = 600.0, device="cuda") -> dict:
    """The restart phase: submit a mixed batch against a sqlite-backed
    scheduler (admission.max_running_jobs=1 makes one job admit + plan
    while the rest queue), abandon the service without any shutdown,
    rebuild it over the same file and time the recovery pass — the
    serving gap a real restart would cost."""
    import shutil
    import tempfile

    from .distributed.scheduler import SchedulerService
    from .distributed.state import SchedulerState, SqliteBackend

    sqls = {q: query_sql(q) for q in mix}
    tmp = tempfile.mkdtemp(prefix="ballista-restart-bench-")
    db = os.path.join(tmp, "state.db")
    try:
        svc = SchedulerService(SchedulerState(SqliteBackend(db)),
                               device=device)
        settings = {
            "session.id": "restart-bench",
            "admission.max_running_jobs": "1",
            "admission.queue_timeout_secs": str(job_timeout),
        }
        job_ids = []
        for j in range(jobs):
            r = svc.ExecuteQuery(_tpch_query_params(
                sqls[mix[j % len(mix)]], data_dir, settings, device))
            job_ids.append(r.job_id)
        deadline = time.time() + job_timeout
        while not svc.journal.is_planned(job_ids[0]):
            if time.time() > deadline:
                raise RuntimeError("first job never finished planning")
            time.sleep(0.01)
        svc.close_health()  # abandon in place: the "crash"

        t0 = time.time()
        svc2 = SchedulerService(SchedulerState(SqliteBackend(db)),
                                device=device)
        report = svc2.recover()
        recovery_wall = time.time() - t0  # rehydrate + recovery pass
        svc2.close_health()
        return {
            "metric": "recovered_jobs",
            "unit": "jobs",
            "value": report.recovered_jobs,
            "recovered_jobs": report.recovered_jobs,
            "recovery_seconds": round(recovery_wall, 4),
            "recovery_pass_seconds": report.recovery_seconds,
            "recovery_inflight": report.jobs_inflight,
            "recovery_queued_restored": report.queued_restored,
            "recovery_relaunched": report.relaunched,
            "recovery_tasks_requeued": report.tasks_requeued,
            "recovery_orphans_failed": report.orphans_failed,
            "recovery_errors": len(report.errors),
            "restart_jobs_submitted": jobs,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_autoscale(data_dir: str, sessions: int = 4,
                  queries_per_session: int = 6, executors: int = 2,
                  slots: int = 2, job_timeout: float = 600.0,
                  mix=QUERY_MIX, device="cuda", on_result=None) -> dict:
    """The autoscale phase: a 2x session burst against a MIN-sized
    fleet with the autoscaler on — it must grow toward the max bound
    and keep the burst's tail latency finite, then drain back once
    idle. Decisions land in system.autoscaler. ``on_result`` as in
    ``run_serving``."""
    from .client import BallistaContext
    from .distributed.controlplane import AutoscalerConfig
    from .distributed.executor import LocalCluster

    sqls = {q: query_sql(q) for q in mix}
    burst_sessions = 2 * sessions

    cluster = LocalCluster(num_executors=1, concurrent_tasks=slots,
                           device=device)
    try:
        svc = cluster.service
        svc.attach_autoscaler(
            AutoscalerConfig(enabled=True, min_executors=1,
                             max_executors=executors, backlog_tasks=2,
                             cooldown_secs=1.0, idle_secs=2.0,
                             interval_secs=0.25),
            spawn_fn=cluster.add_executor,
            drain_fn=cluster.remove_executor)

        warm_ctx = BallistaContext.remote(
            "localhost", cluster.port, device=device,
            **{"job.timeout": str(job_timeout),
               "session.id": "autoscale-warmup"})
        register_tables(warm_ctx, data_dir)
        for q in mix:
            out = warm_ctx.sql(sqls[q]).to_pydict()
            if on_result is not None:
                on_result(q, out)

        latencies: list = []
        errors: list = []
        lat_lock = threading.Lock()
        peak_executors = [1]
        stop = threading.Event()

        def watch_fleet():
            while not stop.is_set():
                peak_executors[0] = max(peak_executors[0],
                                        len(cluster.executors))
                time.sleep(0.05)

        watcher = threading.Thread(target=watch_fleet, daemon=True)
        watcher.start()

        def run_session(idx: int):
            ctx = BallistaContext.remote(
                "localhost", cluster.port, device=device,
                **{"job.timeout": str(job_timeout),
                   "session.id": f"autoscale-{idx}"})
            register_tables(ctx, data_dir)
            for j in range(queries_per_session):
                q = mix[(idx + j) % len(mix)]
                t0 = time.time()
                try:
                    out = ctx.sql(sqls[q]).to_pydict()
                except Exception as e:  # noqa: BLE001 - recorded
                    with lat_lock:
                        errors.append((q, f"{type(e).__name__}: {e}"))
                else:
                    with lat_lock:
                        latencies.append(time.time() - t0)
                    if on_result is not None:
                        on_result(q, out)

        threads = [threading.Thread(target=run_session, args=(i,))
                   for i in range(burst_sessions)]
        t0 = time.time()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.time() - t0
        stop.set()
        watcher.join(1)

        scaler = svc.autoscaler
        lats = sorted(latencies)
        return {
            "metric": "autoscale_qps",
            "unit": "queries/s",
            "value": round(len(lats) / wall, 3) if wall > 0 else 0.0,
            "autoscale_wall_seconds": round(wall, 3),
            "autoscale_sessions": burst_sessions,
            "autoscale_completed": len(lats),
            "autoscale_errors": len(errors),
            "autoscale_events": (scaler.scale_ups_total
                                 + scaler.scale_downs_total),
            "autoscale_ups": scaler.scale_ups_total,
            "autoscale_downs": scaler.scale_downs_total,
            "autoscale_peak_executors": peak_executors[0],
            "autoscale_max_executors": executors,
            "autoscale_p50_seconds": round(_percentile(lats, 0.50), 4),
            "autoscale_p99_seconds": round(_percentile(lats, 0.99), 4),
            "autoscale_error_sample": (str(errors[:3])[:300]
                                       if errors else ""),
        }
    finally:
        cluster.shutdown()


def run_phase(phase: str, data_dir: str, device, sessions: int = 4,
              queries_per_session: int = 6, executors: int = 2,
              slots: int = 2, max_running: int = 4,
              session_quota: int = 2, on_result=None) -> dict:
    """One phase's JSON line, with the caches' counters and the device
    it ran on. ``on_result(query, rows)`` receives every query result of
    the serving and autoscale phases (the restart phase runs none)."""
    if phase == "restart":
        result = run_restart(data_dir, jobs=sessions * 2, device=device)
    elif phase == "autoscale":
        result = run_autoscale(
            data_dir, sessions=sessions,
            queries_per_session=queries_per_session,
            executors=executors, slots=slots, device=device,
            on_result=on_result)
    elif phase == "serving":
        result = run_serving(
            data_dir, sessions=sessions,
            queries_per_session=queries_per_session,
            executors=executors, slots=slots, max_running=max_running,
            session_quota=session_quota, device=device,
            on_result=on_result)
    else:
        raise ValueError(f"unknown phase {phase!r}")
    # warm-path cache effectiveness rides along on every line
    from .cache import cache_counters

    cc = cache_counters()
    result["table_cache_hits"] = int(cc["table_cache_hits"])
    result["result_cache_hits"] = int(cc["result_cache_hits"])
    result["donated_buffers"] = int(cc["donated_buffers"])
    result["phase"] = phase
    result.update(card_info(device))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.bench_serving",
        description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("serving", "restart",
                                        "autoscale"),
                    default="serving")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--data", default=os.path.join(
        REPO_ROOT, "bench_data", "serving"))
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--queries-per-session", type=int, default=6)
    ap.add_argument("--executors", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-running", type=int, default=4)
    ap.add_argument("--session-quota", type=int, default=2)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device, "bench_serving")
    data_dir = ensure_tpch(os.path.join(args.data, f"sf{args.scale:g}"),
                           args.scale, num_parts=2,
                           log=lambda m: print(m, file=sys.stderr))
    result = run_phase(args.phase, data_dir, device, args.sessions,
                       args.queries_per_session, args.executors,
                       args.slots, args.max_running, args.session_quota)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
