"""The TPC-H benchmark CLI on the port (the counterpart of
``benchmarks/tpch/main.py``, after the reference's
``rust/benchmarks/tpch/src/main.rs:97-265``: ``tpch benchmark`` runs a
query N times and reports each iteration's and the mean milliseconds,
``tpch convert`` rewrites ``.tbl`` data).

    python -m ballista_tpu_torch.benchmarks.tpch benchmark --path DIR \\
        --query 1 [--iterations 3] [--host H --port P] [--cached] \\
        [--debug] [--device cuda|cpu]
    python -m ballista_tpu_torch.benchmarks.tpch convert --input DIR \\
        --output DIR [--partitions N]
    python -m ballista_tpu_torch.benchmarks.tpch gen --output DIR \\
        [--scale 0.01] [--parts 2]

``benchmark`` runs standalone on ``--device`` (default ``cuda``; without
a card it exits unless ``--device cpu``), or, with ``--host``, submits
to that scheduler through ``BallistaContext.remote`` (the executors run
on their own devices; ``--device`` is where the client resolves scalar
subqueries). Each iteration is timed on the host clock after the card's
work is done. ``convert`` writes Parquet through
``testing/parquet_convert.py`` (the JAX converter's layout and types);
the JAX CLI's CSV output (pandas, quoted fields) is left out, since the
port's CSV scanner reads unquoted files. ``gen`` calls
``benchmarks/tpch/datagen.py``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import (add_device_argument, query_sql, register_tables,
               require_device, timed)


def run_benchmark(args):
    """(per-iteration milliseconds, the last iteration's result as
    ``to_pydict``) of ``benchmark``'s query; prints as the reference
    does."""
    from ..client import BallistaContext

    device = require_device(args.device, "tpch benchmark")
    if args.host:
        ctx = BallistaContext.remote(
            args.host, args.port, device=device,
            **{"batch.size": str(args.batch_size)})
    else:
        ctx = BallistaContext.standalone(device=device)
    register_tables(ctx, args.path, args.format, cached=args.cached)
    sql = query_sql(args.query)
    if args.debug:
        print(sql)
        print(ctx.sql(sql).explain())
    times, out = [], None
    for i in range(args.iterations):
        secs, out = timed(ctx.sql(sql).to_pydict, device)
        ms = 1000 * secs
        times.append(ms)
        print(f"Query {args.query} iteration {i} took {ms:.1f} ms",
              flush=True)
    print(f"Query {args.query} avg time: {sum(times) / len(times):.2f} ms",
          flush=True)
    if args.debug and out is not None:
        for name, values in out.items():
            print(f"{name}: {values.tolist()}")
    return times, out


def cmd_benchmark(args) -> int:
    run_benchmark(args)
    return 0


def _source_path(input_dir: str, name: str):
    path = os.path.join(input_dir, name)
    if os.path.exists(path):
        return path
    path = os.path.join(input_dir, f"{name}.tbl")
    return path if os.path.exists(path) else None


def cmd_convert(args) -> int:
    """``.tbl`` tables to Parquet (``testing/parquet_convert.py``), in
    ``--partitions`` files a table."""
    from ..testing.parquet_convert import convert_table
    from ..testing.tpch_schema import TPCH_SCHEMAS

    os.makedirs(args.output, exist_ok=True)
    for name, sch in TPCH_SCHEMAS.items():
        src_path = _source_path(args.input, name)
        if src_path is None:
            print(f"skipping {name}: not found", file=sys.stderr)
            continue
        out_dir = os.path.join(args.output, name)
        rows = convert_table(src_path, sch, out_dir,
                             partitions=max(args.partitions, 1))
        print(f"converted {name}: {rows} rows -> {out_dir}")
    return 0


def cmd_gen(args) -> int:
    from . import REPO_ROOT

    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    from benchmarks.tpch import datagen

    t0 = time.perf_counter()
    datagen.generate(args.output, args.scale, args.parts)
    print(f"generated scale {args.scale} in {time.perf_counter() - t0:.1f}s "
          f"at {args.output}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "ballista_tpu_torch.benchmarks.tpch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("benchmark")
    b.add_argument("--path", required=True)
    b.add_argument("--format", default="tbl", choices=["tbl", "parquet"])
    b.add_argument("--query", type=int, required=True)
    b.add_argument("--iterations", type=int, default=3)
    b.add_argument("--host", default="")
    b.add_argument("--port", type=int, default=50050)
    b.add_argument("--batch-size", type=int, default=1 << 20)
    b.add_argument("--cached", action="store_true")
    b.add_argument("--debug", action="store_true")
    add_device_argument(b)
    b.set_defaults(fn=cmd_benchmark)

    c = sub.add_parser("convert")
    c.add_argument("--input", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--format", default="parquet", choices=["parquet"])
    c.add_argument("--partitions", type=int, default=1)
    c.set_defaults(fn=cmd_convert)

    g = sub.add_parser("gen")
    g.add_argument("--output", required=True)
    g.add_argument("--scale", type=float, default=0.01)
    g.add_argument("--parts", type=int, default=2)
    g.set_defaults(fn=cmd_gen)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
