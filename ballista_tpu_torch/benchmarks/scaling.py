"""1 -> N slot curves of the port's fused mesh operators (the
counterpart of ``benchmarks/scaling.py``): the ``MeshAggExec`` and
``MeshJoinExec`` programs the scheduler fuses (the row exchange between
slots and each slot's final aggregate or join) over meshes of 1, 2, 4
and 8 slots.

Three operators: ``mesh_agg`` groups on an int64 key of 4096 values (the
sort-based grouping, as ``benchmarks/scaling.py`` has it),
``mesh_agg_dict`` on a utf8 key of 200 values (dense grouping: on a card
each slot's partial and final sums are the hand-written
``dense_grouped_sums`` kernel, q1's path) and ``mesh_join`` an inner
join. Two curves an operator:

- weak: rows per slot fixed, the total grows with N (efficiency
  t1 / tN, ideal 1.0);
- strong: the total fixed, split N ways (efficiency t1 / (N * tN), ideal
  1.0).

Every point's result is held against a plain numpy computation of the
same aggregate or join on the same generated rows, and the run fails
unless they are equal.

What the curve measures depends on where the slots are. On one card
every slot is the same H100: a mesh is one governed program (one CUDA
graph) that loops over the slots and exchanges rows as tensor ops on
the stacked ``[n, cap]`` layout, so the curve shows how each slot's work
and the in-graph exchange grow with N on one card, not scaling across
cards (the exchange across cards, NCCL between processes, is not
measured anywhere yet). On the CPU the slots share the host's cores.

    python -m ballista_tpu_torch.benchmarks.scaling [--rows-per-dev 262144]
        [--total-rows 1048576] [--runs 3] [--devices 1,2,4,8]
        [--out FILE] [--device cuda|cpu]

Walls are host clocks around a whole ``execute`` with the card's work
synchronised; ``first_s`` includes the warm-up and capture.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import (add_device_argument, card_info, require_device, sync,
               write_line)

DICT_GROUPS = 200  # under the dense grouping's limit of 256 groups


def _agg_exec(n_dev: int, rows: int, device, n_groups: int = 4096,
              dict_key: bool = False):
    """A ``MeshAggExec`` as the scheduler fuses it: scan -> partial
    aggregate per partition, the exchange on the group key, each slot's
    final aggregate. ``dict_key`` makes the key a utf8 column (its
    dictionary codes come out). Returns (the node, its rows as numpy
    computes them: ``k, sum(v), count`` sorted)."""
    from .. import Int64, Utf8, col, count, sum_
    from .. import schema as mk_schema
    from ..distributed.planner import DistributedPlanner
    from ..distributed.scheduler import _fuse_mesh_stages
    from ..io import MemTableSource
    from ..logical import LogicalPlanBuilder
    from ..physical.mesh_agg import MeshAggExec
    from ..physical.planner import PlannerOptions, create_physical_plan

    rng = np.random.default_rng(11)
    k = rng.integers(0, n_groups, rows)
    v = rng.integers(0, 1000, rows)
    keys, inv = np.unique(k, return_inverse=True)  # dict-ok: numpy's group-by
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, v)
    if dict_key:
        # the sorted dictionary of the values present: key i is code i
        k = np.array([f"g{x:04d}" for x in range(n_groups)],
                     dtype=object)[k]
        keys = np.arange(len(keys))
    want = np.stack([keys, sums, np.bincount(inv, minlength=len(keys))],
                    axis=1).astype(np.int64)
    s = mk_schema(("k", Utf8 if dict_key else Int64), ("v", Int64))
    src = MemTableSource.from_pydict(s, {"k": k, "v": v},
                                     num_partitions=max(n_dev, 1),
                                     device=device)
    plan = (LogicalPlanBuilder.scan("t", src)
            .aggregate([col("k")], [sum_(col("v")).alias("sv"),
                                    count().alias("n")])
            .build())
    phys = create_physical_plan(
        plan, PlannerOptions(agg_partitions=max(n_dev, 2), device=device))
    stages = DistributedPlanner().plan_query_stages("scale", phys)
    # fusion needs a mesh of >= 2; the 1-slot point runs the same fused
    # node over one slot, where the exchange is the identity
    node = _fuse_mesh_stages(stages, max(n_dev, 2))[-1].child
    if not isinstance(node, MeshAggExec):
        raise AssertionError(f"fused stage is {type(node).__name__}")
    return MeshAggExec(node.producer, node.group_exprs, node.agg_exprs,
                       node.hash_exprs, n_dev, node.group_capacity,
                       device=device), want


def _join_exec(n_dev: int, rows: int, device):
    """A ``MeshJoinExec``: both sides hashed over the mesh, an inner
    join on each slot. Returns (the node, its rows as numpy computes
    them: ``bk, bv, pk_, pv`` sorted)."""
    from .. import Int64
    from .. import schema as mk_schema
    from ..io import MemTableSource
    from ..physical.mesh_agg import MeshJoinExec
    from ..physical.operators import ScanExec

    rng = np.random.default_rng(13)
    n_keys = max(rows // 4, 16)
    bk = np.arange(n_keys, dtype=np.int64)
    bv = rng.integers(0, 1000, n_keys)
    pk = rng.integers(0, n_keys, rows)
    pv = rng.integers(0, 1000, rows)
    # the build keys are 0..n_keys-1, unique: each probe row meets the
    # build row at its own key
    want = np.stack([pk, bv[pk], pk, pv], axis=1).astype(np.int64)
    want = want[np.lexsort(want.T[::-1])]
    bs = mk_schema(("bk", Int64), ("bv", Int64))
    ps = mk_schema(("pk_", Int64), ("pv", Int64))
    build = MemTableSource.from_pydict(
        bs, {"bk": bk, "bv": bv}, num_partitions=max(n_dev, 1),
        device=device)
    probe = MemTableSource.from_pydict(
        ps, {"pk_": pk, "pv": pv}, num_partitions=max(n_dev, 1),
        device=device)
    return MeshJoinExec(ScanExec("b", build), ScanExec("p", probe),
                        [("bk", "pk_")], "inner", n_dev,
                        device=device), want


def _rows(batches) -> np.ndarray:
    """The live rows of ``batches`` as one int64 matrix, sorted."""
    parts = []
    for b in batches:
        # the result is read once the timed runs are over
        # ballista: ignore[sync-span]
        sel = b.selection.cpu().numpy()
        # ballista: ignore[sync-span]
        parts.append(np.stack([c.values.cpu().numpy().astype(np.int64)[sel]
                               for c in b.columns], axis=1))
    mat = np.concatenate(parts) if parts else np.zeros((0, 0), np.int64)
    return mat[np.lexsort(mat.T[::-1])] if mat.size else mat


def _time_exec(node, runs: int, device):
    """(first run seconds, fastest later run, the result's rows)."""
    out = {}

    def once():
        sync(device)
        t0 = time.perf_counter()
        batches = list(node.execute(0))
        sync(device)
        out["batches"] = batches
        return time.perf_counter() - t0

    first = once()
    warm = min(once() for _ in range(max(runs, 2)))
    return first, warm, _rows(out.pop("batches"))


def run_curves(dev_counts, rows_per_dev: int, total_rows: int, runs: int,
               device) -> dict:
    device = torch.device(device)
    out = {"platform": device.type, "slots": list(dev_counts),
           "rows_per_dev": rows_per_dev, "total_rows": total_rows,
           "curves": {}}
    out.update(card_info(device))
    operators = (
        ("mesh_agg", _agg_exec),
        ("mesh_agg_dict", lambda n, rows, dev: _agg_exec(
            n, rows, dev, n_groups=DICT_GROUPS, dict_key=True)),
        ("mesh_join", _join_exec))
    for op_name, make in operators:
        for mode in ("weak", "strong"):
            points = []
            for n in dev_counts:
                rows = rows_per_dev * n if mode == "weak" else total_rows
                node, want = make(n, rows, device)
                first, warm, got = _time_exec(node, runs, device)
                if got.shape != want.shape or not np.array_equal(got, want):
                    raise AssertionError(
                        f"{op_name} {mode} over {n} slots: {got.shape[0]} "
                        f"rows differ from numpy's {want.shape[0]}")
                points.append({
                    "n_devices": n, "rows": rows,
                    "first_s": round(first, 4), "warm_s": round(warm, 6),
                    "rows_per_s": round(rows / warm, 1),
                    "rows_out": int(got.shape[0]),
                })
                print(f"# {op_name} {mode} n={n} rows={rows} "
                      f"warm={warm:.4f}s", file=sys.stderr)
            t1 = points[0]["warm_s"]
            for r in points:
                r["efficiency"] = round(
                    t1 / r["warm_s"] if mode == "weak"
                    else t1 / (r["n_devices"] * r["warm_s"]), 3)
            out["curves"][f"{op_name}_{mode}"] = points
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.benchmarks.scaling")
    ap.add_argument("--rows-per-dev", type=int, default=262_144)
    ap.add_argument("--total-rows", type=int, default=1_048_576)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--devices", default="1,2,4,8",
                    help="slot counts of the curves")
    ap.add_argument("--out", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device, "scaling")
    counts = [int(x) for x in args.devices.split(",") if x]
    result = run_curves(counts, args.rows_per_dev, args.total_rows,
                        args.runs, device)
    write_line(json.dumps(result), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
