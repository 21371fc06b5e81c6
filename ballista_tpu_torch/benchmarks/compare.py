"""The port against the pandas oracle, timed side by side (the
counterpart of ``benchmarks/compare.py``; the reference compares with
Spark, ``spark/benchmarks/src/main/scala/.../Main.scala:24-121``). Every
query runs through both on the same data and every result is checked:
floats within rtol 1e-6 and atol 1e-6, everything else exactly.

    python -m ballista_tpu_torch.benchmarks.compare \\
        --path bench_data/sf0.05 [--queries 1,5,18] [--iterations 2] \\
        [--out FILE] [--device cuda|cpu]

The oracle is ``benchmarks/tpch/oracle.py`` (``testing/tpch_oracle.py``
loads it) and needs pandas. A mismatch makes the exit code 1, after the
JSON line (``all_match`` false).
"""

from __future__ import annotations

import argparse
import json

from . import (add_device_argument, card_info, frame_mismatch, query_sql,
               register_tables, require_device, timed, write_line)
from .sweep import ALL_QUERIES


def run_compare(path: str, queries, iterations: int, device,
                fmt: str = "tbl") -> dict:
    """The comparison's JSON line (``rows`` holds one entry a query)."""
    from ..client import BallistaContext
    from ..testing import tpch_oracle

    oracle = tpch_oracle.load()
    ctx = BallistaContext.standalone(device=device)
    register_tables(ctx, path, fmt, cached=True)
    tables = oracle.load_tables(path)
    rows = []
    print(f"{'query':>6} | {'port (s)':>10} | {'pandas (s)':>10} "
          f"| {'speedup':>7} | match")
    print("-" * 56)
    for q in queries:
        qname = f"q{q}"
        df = ctx.sql(query_sql(qname))
        first = timed(df.collect, device)[0]  # scan, first calls, execute
        bt = min(timed(df.collect, device)[0] for _ in range(iterations))
        oracle_fn = oracle.ORACLES[qname]
        oracle_fn(tables)
        pt = min(timed(lambda: oracle_fn(tables), "cpu")[0]
                 for _ in range(iterations))
        problem = frame_mismatch(df.collect(), oracle_fn(tables),
                                 label=qname)
        speed = pt / bt if bt > 0 else float("inf")
        rows.append({"query": qname, "port_s": round(bt, 4),
                     "port_first_s": round(first, 4),
                     "pandas_s": round(pt, 4), "speedup": round(speed, 2),
                     "match": problem is None})
        if problem is not None:
            rows[-1]["mismatch"] = problem[:300]
        print(f"{qname:>6} | {bt:10.4f} | {pt:10.4f} | {speed:6.2f}x "
              f"| {'OK' if problem is None else 'MISMATCH'}", flush=True)
    total_b = sum(r["port_s"] for r in rows)
    total_p = sum(r["pandas_s"] for r in rows)
    print("-" * 56)
    line = {"path": path,
            "total_port_s": round(total_b, 4),
            "total_pandas_s": round(total_p, 4),
            "speedup": round(total_p / total_b, 2) if total_b > 0 else 0.0,
            "all_match": all(r["match"] for r in rows),
            "rows": rows}
    line.update(card_info(device))
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.benchmarks.compare")
    ap.add_argument("--path", required=True)
    ap.add_argument("--format", default="tbl", choices=["tbl", "parquet"])
    ap.add_argument("--queries", default=ALL_QUERIES)
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device, "compare")
    line = run_compare(args.path, args.queries.split(","), args.iterations,
                       device, args.format)
    write_line(json.dumps(line), args.out)
    return 0 if line["all_match"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
