"""First-run sweep on the port: every TPC-H query once in a fresh
process, each query's wall (the counterpart of ``benchmarks/sweep.py``).
A first run's wall holds its parse, upload and the warm-up and capture
of each new program.

    python -m ballista_tpu_torch.benchmarks.sweep --path bench_data/sf0.05 \\
        [--queries 1,5,18] [--device cuda|cpu]

Prints one line a query and a JSON line at the end (``total_s``,
``sum_query_s``, ``worst``, ``worst_s``, ``times``, ``device``,
``power_limit_w``).
"""

from __future__ import annotations

import argparse
import json
import time

from . import (add_device_argument, card_info, query_sql, register_tables,
               require_device, timed)

ALL_QUERIES = ",".join(str(i) for i in range(1, 23))


def run_sweep(path: str, queries, device, fmt: str = "tbl"):
    """(result line, {query: to_pydict result})."""
    from ..client import BallistaContext

    t0 = time.perf_counter()
    ctx = BallistaContext.standalone(device=device)
    register_tables(ctx, path, fmt, cached=True)
    times, results = {}, {}
    for q in queries:
        secs, results[f"q{q}"] = timed(ctx.sql(query_sql(q)).to_pydict,
                                       device)
        times[f"q{q}"] = round(secs, 4)
        print(f"q{q}: {times[f'q{q}']:.2f}s", flush=True)
    worst = max(times, key=times.get)
    line = {
        "total_s": round(time.perf_counter() - t0, 2),
        "sum_query_s": round(sum(times.values()), 2),
        "worst": worst,
        "worst_s": times[worst],
        "times": times,
    }
    line.update(card_info(device))
    return line, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.benchmarks.sweep")
    ap.add_argument("--path", required=True)
    ap.add_argument("--format", default="tbl", choices=["tbl", "parquet"])
    ap.add_argument("--queries", default=ALL_QUERIES)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device, "sweep")
    line, _ = run_sweep(args.path, args.queries.split(","), device,
                        args.format)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
