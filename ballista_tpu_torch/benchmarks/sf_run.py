"""Large-scale-factor TPC-H runs on the port (the counterpart of
``benchmarks/sf_run.py``: BASELINE.json's configurations 2-3, q1/q3 at
SF10), each checked against the pandas oracle.

    python -m ballista_tpu_torch.benchmarks.sf_run --data bench_data/sf10 \\
        [--queries q1,q3] [--runs 2] [--no-oracle] [--out FILE] \\
        [--device cuda|cpu]

Files over ``io.text.STREAM_CHUNK_BYTES`` (``BALLISTA_SCAN_CHUNK_BYTES``)
are parsed in byte ranges by the native scanner (the bounded-RAM
streaming scan). Each query gets a fresh context and its
first and fastest later wall; the oracle
(``benchmarks/tpch/oracle.py``, loaded by ``testing/tpch_oracle.py``)
reads only the tables the query needs. A mismatch raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import (add_device_argument, card_info, count_lineitem_rows,
               frame_mismatch, query_sql, register_tables, require_device,
               timed, write_line)

# tables each query's oracle needs (loading all 8 at SF10 wastes memory)
ORACLE_TABLES = {
    "q1": ["lineitem"],
    "q3": ["customer", "orders", "lineitem"],
    "q5": ["customer", "orders", "lineitem", "supplier", "nation", "region"],
    "q6": ["lineitem"],
}


def run_query(ctx, qname: str, runs: int):
    """(pandas result, first wall, fastest later wall)."""
    sql = query_sql(qname)
    first, out = timed(ctx.sql(sql).collect, ctx.device)
    times = []
    for _ in range(max(runs - 1, 1)):
        secs, out = timed(ctx.sql(sql).collect, ctx.device)
        times.append(secs)
    return out, first, min(times)


def check_oracle(data_dir: str, qname: str, got) -> str:
    from ..testing import tpch_oracle

    oracle = tpch_oracle.load()
    tables = oracle.load_tables(data_dir, only=ORACLE_TABLES.get(qname))
    problem = frame_mismatch(got, oracle.ORACLES[qname](tables), rtol=1e-5,
                             atol=1e-5, label=qname)
    if problem is not None:
        raise AssertionError(f"oracle mismatch: {problem}")
    return "ok"


def run_sf(data: str, queries, runs: int, device,
           oracle: bool = True) -> dict:
    from ..client import BallistaContext
    from ..io import text

    device = torch.device(device)
    rows = count_lineitem_rows(data)
    result = {"data": data, "platform": device.type, "lineitem_rows": rows,
              "stream_chunk_bytes": text.STREAM_CHUNK_BYTES, "queries": {}}
    result.update(card_info(device))
    for qname in queries:
        qname = qname.strip()
        # a fresh context a query: it holds only this query's tables
        ctx = BallistaContext.standalone(device=device)
        register_tables(ctx, data)
        out, first, warm = run_query(ctx, qname, runs)
        entry = {
            "first_s": round(first, 4),
            "warm_s": round(warm, 4),
            "rows_out": int(len(out)),
            "lineitem_rows_per_s_first": round(rows / first, 1),
        }
        print(f"# {qname}: first={first:.2f}s warm={warm:.2f}s "
              f"rows={len(out)}", file=sys.stderr)
        if oracle:
            t0 = time.perf_counter()
            entry["oracle"] = check_oracle(data, qname, out)
            entry["oracle_s"] = round(time.perf_counter() - t0, 2)
            print(f"# {qname}: oracle ok ({entry['oracle_s']}s)",
                  file=sys.stderr)
        result["queries"][qname] = entry
        del ctx
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.benchmarks.sf_run")
    ap.add_argument("--data", required=True)
    ap.add_argument("--queries", default="q1,q3")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--no-oracle", action="store_true")
    ap.add_argument("--out", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device, "sf_run")
    result = run_sf(args.data, args.queries.split(","), args.runs, device,
                    oracle=not args.no_oracle)
    write_line(json.dumps(result), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
