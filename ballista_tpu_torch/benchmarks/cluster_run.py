"""q5-class TPC-H queries through a cluster of the port (the
counterpart of ``benchmarks/cluster_run.py``: BASELINE.json's
configuration 4, q5 over 4 executors with a shuffle): a ``LocalCluster``
of N executors on ``--device``, each query's result checked against the
standalone engine on the same data.

    python -m ballista_tpu_torch.benchmarks.cluster_run \\
        --data bench_data/sf1 [--executors 4] [--queries q5] [--runs 2] \\
        [--shuffle-partitions 8] [--out FILE] [--device cuda|cpu]

On one card every executor runs its tasks on that card; the structure
(several executors, hash-shuffle stages, partitioned joins) is what the
configuration is about. A mismatch raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import (add_device_argument, card_info, frame_mismatch, query_sql,
               register_tables, require_device, timed, write_line)


def _sorted(frame):
    return frame.sort_values(list(frame.columns)).reset_index(drop=True)


def run_cluster(data: str, queries, runs: int, device, executors: int = 4,
                concurrent_tasks: int = 2, shuffle_partitions: str = "8",
                timeout: float = 7200.0, speculation_secs: float = 0.0,
                check: bool = True) -> dict:
    from ..client import BallistaContext
    from ..distributed.executor import LocalCluster

    device = torch.device(device)
    result = {
        "data": data,
        "platform": device.type,
        "executors": executors,
        "concurrent_tasks": concurrent_tasks,
        "shuffle_partitions": shuffle_partitions,
        "speculation_secs": speculation_secs,
        "queries": {},
    }
    result.update(card_info(device))
    cluster = LocalCluster(num_executors=executors,
                           concurrent_tasks=concurrent_tasks,
                           speculation_age_secs=speculation_secs,
                           device=device)
    try:
        ctx = BallistaContext.remote(
            "localhost", cluster.port, device=device,
            **{"join.partitions": shuffle_partitions,
               "agg.partitions": shuffle_partitions,
               "job.timeout": str(timeout)})
        register_tables(ctx, data)
        for qname in queries:
            qname = qname.strip()
            sql = query_sql(qname)
            first, out = timed(ctx.sql(sql).collect, device)
            times = []
            for _ in range(runs - 1):
                secs, out = timed(ctx.sql(sql).collect, device)
                times.append(secs)
            entry = {"first_s": round(first, 4), "rows_out": int(len(out))}
            if times:
                entry["warm_s"] = round(min(times), 4)
            print(f"# cluster {qname}: first={first:.2f}s "
                  f"warm={min(times) if times else float('nan'):.2f}s "
                  f"rows={len(out)}", file=sys.stderr)
            if check:
                sctx = BallistaContext.standalone(device=device)
                register_tables(sctx, data)
                secs, sa = timed(sctx.sql(sql).collect, device)
                entry["standalone_s"] = round(secs, 4)
                problem = frame_mismatch(_sorted(out), _sorted(sa),
                                         rtol=1e-5, atol=1e-5, label=qname)
                if problem is not None:
                    raise AssertionError(
                        f"cluster result differs from standalone: {problem}")
                entry["matches_standalone"] = True
                del sctx
            result["queries"][qname] = entry
    finally:
        cluster.shutdown()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.benchmarks.cluster_run")
    ap.add_argument("--data", required=True)
    ap.add_argument("--executors", type=int, default=4)
    ap.add_argument("--concurrent-tasks", type=int, default=2)
    ap.add_argument("--queries", default="q5")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--shuffle-partitions", default="8",
                    help="hash-shuffle width of joins and aggregations "
                         "(the join.partitions/agg.partitions settings)")
    ap.add_argument("--skip-standalone-check", action="store_true")
    ap.add_argument("--timeout", type=float, default=7200.0,
                    help="per-query job timeout seconds")
    ap.add_argument("--speculation-secs", type=float, default=0.0,
                    help="straggler speculation age; 0 = off")
    ap.add_argument("--out", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device, "cluster_run")
    result = run_cluster(args.data, args.queries.split(","), args.runs,
                         device, args.executors, args.concurrent_tasks,
                         args.shuffle_partitions, args.timeout,
                         args.speculation_secs,
                         check=not args.skip_standalone_check)
    write_line(json.dumps(result), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
