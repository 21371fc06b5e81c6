"""Warm walls of TPC-H queries on the card, for one tree of the port.

Compares two versions of the port on one card: run it once per tree, in
turns (parent, change, change, parent), each in a process of its own::

    python3 ballista_tpu_torch/testing/warm_walls.py --tree <tree> \\
        --data bench_data/sf1 [--queries q3,q5] [--repeats 10] \\
        [--set adaptive.enabled=off] [--env BALLISTA_PREFETCH_BATCHES=0] \\
        [--metrics]

``--tree`` is the root of the checkout to import ``ballista_tpu_torch``
from (default: this file's). For each query it registers the TPC-H
tables of ``--data`` in a fresh card context with a table-cache budget of
8192 MB (every table of the queries fits), collects once cold and then
``--repeats`` times warm, and prints one JSON line: the tree, the card's
name, and per query the cold wall and the warm walls' median and
quartiles (host clock around the collect, ending in
``torch.cuda.synchronize()``). It uses only the port's public surface
(``BallistaContext``, ``register_tpch``, ``to_pydict``), so it runs on
earlier trees too. ``--set`` passes a context setting and ``--env`` sets
an environment variable before the first collect (each repeatable);
``--metrics`` adds each query's plan with its operators' metrics from
the last warm collect. It needs a card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.join(here, "..", ".."))
    ap.add_argument("--data", required=True)
    ap.add_argument("--queries", default="q3,q5")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--env", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--metrics", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.environ["BALLISTA_TABLE_CACHE_BUDGET_MB"] = "8192"
    os.environ.update(kv.split("=", 1) for kv in args.env)
    settings = dict(kv.split("=", 1) for kv in args.set)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("warm_walls: no CUDA device is available", file=sys.stderr)
        return 2
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    out = {"tree": tree, "card": torch.cuda.get_device_name(0),
           "settings": settings, "env": args.env, "queries": {}}
    for q in args.queries.split(","):
        sql = open(os.path.join(tree, "benchmarks", "tpch", "queries",
                                f"{q}.sql")).read()
        ctx = BallistaContext.standalone(**settings)
        register_tpch(ctx, args.data)
        df = ctx.sql(sql)
        walls = []
        for _ in range(args.repeats + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            df.to_pydict()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        warm = walls[1:]
        out["queries"][q] = {
            "cold_s": walls[0],
            "warm_median_s": float(np.median(warm)),
            "warm_quartiles_s": [float(np.percentile(warm, 25)),
                                 float(np.percentile(warm, 75))],
            "warm_s": warm,
        }
        if args.metrics:
            out["queries"][q]["plan_metrics"] = \
                df.physical_plan().pretty_metrics()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
