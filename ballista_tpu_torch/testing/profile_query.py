"""Per-operator wall attribution of one standalone query on the port
(the counterpart of ``dev/profile_query.py``).

Wraps every physical operator's ``execute`` so that each batch it yields
charges the time spent producing it to that operator. The card runs
asynchronously, so the time shows where the host waits for it (a sync
before a host read), exactly as in the JAX package's version. Parents
include their children's time (nested iteration): read top-down.

    python -m ballista_tpu_torch.testing.profile_query [--query q5]
        [--data bench_data/sf1] [--runs 2] [--sql TEXT]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

from ..benchmarks import (REPO_ROOT, add_device_argument, query_sql,
                          register_tables, require_device, sync)


def _wrap(node, stats, seen) -> None:
    if id(node) in seen:
        return
    seen.add(id(node))
    label = node.display().split("\n")[0][:72]
    orig = node.execute

    def timed_execute(partition, _orig=orig, _label=label):
        it = _orig(partition)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                stats[_label][0] += time.perf_counter() - t0
                return
            stats[_label][0] += time.perf_counter() - t0
            stats[_label][1] += 1
            yield b

    node.execute = timed_execute
    for c in node.children():
        _wrap(c, stats, seen)


def profile(ctx, sql: str, runs: int = 2):
    """(best warm wall, {operator label: (seconds, batches)}) of ``runs``
    collects of ``sql`` after one cold collect."""
    device = ctx.device
    df = ctx.sql(sql)
    sync(device)
    t0 = time.perf_counter()
    df.to_pydict()
    sync(device)
    print(f"# cold: {time.perf_counter() - t0:.3f}s", file=sys.stderr)
    phys = getattr(df, "_phys", None)
    if phys is None:
        raise RuntimeError("the collect kept no physical plan (_phys)")
    stats = collections.defaultdict(lambda: [0.0, 0])
    _wrap(phys, stats, set())
    best = None
    for i in range(runs):
        for v in stats.values():
            v[0], v[1] = 0.0, 0
        sync(device)
        t0 = time.perf_counter()
        df.to_pydict()
        sync(device)
        dt = time.perf_counter() - t0
        print(f"# run {i}: {dt:.3f}s", file=sys.stderr)
        if best is None or dt < best[0]:
            best = (dt, {k: tuple(v) for k, v in stats.items()})
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.testing.profile_query")
    ap.add_argument("--query", default="q5")
    ap.add_argument("--data", default=os.path.join(REPO_ROOT, "bench_data",
                                                   "sf1"))
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--sql", default=None,
                    help="profile this SQL text instead of --query")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device, "profile_query")

    from ..client import BallistaContext

    print(f"# device: {device}", file=sys.stderr)
    ctx = BallistaContext.standalone(device=device)
    register_tables(ctx, args.data, cached=True)
    total, snap = profile(ctx, args.sql or query_sql(args.query), args.runs)
    print(f"\n=== warm {args.query}: {total:.3f}s ===")
    for label, (sec, nb) in sorted(snap.items(), key=lambda kv: -kv[1][0]):
        print(f"{sec:8.3f}s  {nb:5d} batches  {label}")
    print(f"# (nested totals; wall={total:.3f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
