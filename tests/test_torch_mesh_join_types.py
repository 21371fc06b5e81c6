"""The port's ``MeshJoinExec`` join types: twins of
``tests/test_mesh_join_types.py``, each on the same input.

Every join type (inner/left/semi/anti/full, NULL keys, utf8 keys with
disjoint per-partition dictionaries, the two-column rank codec, the
null-aware anti join behind ``NOT IN``) over 8 CPU slots must equal the
port's host ``JoinExec`` row for row after sorting, and the JAX
package's ``MeshJoinExec`` over its 8 virtual CPU devices on the same
partitions. The scheduler's fusion pass fuses a partitioned left join.

Tolerances: every column here is an integer or a string: exact.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from ballista_tpu_torch import datatypes as pdt
from ballista_tpu_torch.columnar import Column, ColumnBatch
from ballista_tpu_torch.io.memory import MemTableSource
from ballista_tpu_torch.physical.join import JoinExec
from ballista_tpu_torch.physical.mesh_agg import MeshJoinExec
from ballista_tpu_torch.physical.operators import ScanExec

from torch_warm_path import pinned_threads

N_DEV = 8


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    with pinned_threads():
        yield


def _frame(cols: dict) -> pd.DataFrame:
    out = pd.DataFrame(cols)
    out = out.sort_values(list(out.columns)).reset_index(drop=True)
    return out.astype(object).where(pd.notna(out), None)


def _collect_port(plan) -> pd.DataFrame:
    parts = {f.name: [] for f in plan.output_schema().fields}
    for p in range(plan.output_partitioning().num_partitions):
        for b in plan.execute(p):
            d = b.to_pydict()
            for k in parts:
                parts[k].extend(d[k].tolist())
    return _frame(parts)


def _collect_ref(plan) -> pd.DataFrame:
    frames = []
    for p in range(plan.output_partitioning().num_partitions):
        for b in plan.execute(p):
            frames.append(b.to_pandas())
    out = pd.concat(frames, ignore_index=True)
    return _frame({c: out[c].tolist() for c in out.columns})


def _both(build_parts, probe_parts, bs, ps):
    """(port build scan, port probe scan, JAX build scan, JAX probe scan)
    over the same partitions: each part a dict of numpy columns, with an
    optional ``__bk_valid`` validity mask for the first build column."""
    from ballista_tpu import datatypes as rdt
    from ballista_tpu.columnar import ColumnBatch as RBatch
    from ballista_tpu.io import MemTableSource as RMem
    from ballista_tpu.physical.operators import ScanExec as RScan

    def rschema(s):
        kinds = {"int64": rdt.Int64, "utf8": rdt.Utf8}
        return rdt.Schema([rdt.Field(f.name, kinds[f.dtype.kind])
                           for f in s.fields])

    def port_batch(s, part):
        data = {k: v for k, v in part.items() if not k.startswith("__")}
        b = ColumnBatch.from_pydict(s, data, device="cpu")
        va = part.get("__bk_valid")
        if va is not None:
            col = b.columns[0]
            validity = np.zeros(b.capacity, bool)
            validity[: len(va)] = va
            b = b.with_columns(s, (Column(col.values, col.dtype,
                                          torch.from_numpy(validity),
                                          col.dictionary),)
                               + tuple(b.columns[1:]))
        return b

    def ref_batch(s, part):
        import jax.numpy as jnp

        data = {k: v for k, v in part.items() if not k.startswith("__")}
        b = RBatch.from_pydict(s, data)
        va = part.get("__bk_valid")
        if va is not None:
            col = b.columns[0]
            validity = np.zeros(b.capacity, bool)
            validity[: len(va)] = va
            b.columns = (type(col)(col.values, col.dtype,
                                   jnp.asarray(validity),
                                   col.dictionary),) + b.columns[1:]
        return b

    rbs, rps = rschema(bs), rschema(ps)
    return (ScanExec("b", MemTableSource(bs, [[port_batch(bs, p)]
                                              for p in build_parts])),
            ScanExec("p", MemTableSource(ps, [[port_batch(ps, p)]
                                              for p in probe_parts])),
            RScan("b", RMem(rbs, [[ref_batch(rbs, p)] for p in build_parts])),
            RScan("p", RMem(rps, [[ref_batch(rps, p)] for p in probe_parts])))


def _sources(with_nulls=False):
    """test_mesh_join_types._sources' tables: duplicate keys, misses on
    both sides and (optionally) NULL build keys."""
    rng = np.random.default_rng(3)
    bs = pdt.Schema([pdt.Field("bk", pdt.Int64), pdt.Field("bv", pdt.Int64)])
    ps = pdt.Schema([pdt.Field("pk_", pdt.Int64), pdt.Field("pv", pdt.Int64)])
    bk = rng.integers(0, 12, 40)
    pk = rng.integers(5, 20, 90)  # keys 0-4 build-only, 12-19 probe-only
    build_parts = []
    for c in np.array_split(np.arange(40), 3):
        part = {"bk": bk[c], "bv": c * 10}
        if with_nulls:  # every 7th build key NULL
            part["__bk_valid"] = (c % 7) != 0
        build_parts.append(part)
    probe_parts = [{"pk_": pk[c], "pv": c}
                   for c in np.array_split(np.arange(90), 4)]
    return _both(build_parts, probe_parts, bs, ps)


def _utf8_sources():
    """utf8 join keys with DISJOINT per-partition dictionaries + a second
    Int64 key column for the two-column codec."""
    bs = pdt.Schema([pdt.Field("bk", pdt.Utf8), pdt.Field("b2", pdt.Int64),
                     pdt.Field("bv", pdt.Int64)])
    ps = pdt.Schema([pdt.Field("pk_", pdt.Utf8), pdt.Field("p2", pdt.Int64),
                     pdt.Field("pv", pdt.Int64)])
    build_parts = [{"bk": [f"k{i % 9}" for i in c], "b2": (c % 3).tolist(),
                    "bv": (c * 7).tolist()}
                   for c in np.array_split(np.arange(30), 2)]
    probe_parts = [{"pk_": [f"k{i % 14}" for i in c],  # k9..k13 miss
                    "p2": (c % 4).tolist(), "pv": c.tolist()}
                   for c in np.array_split(np.arange(80), 3)]
    return _both(build_parts, probe_parts, bs, ps)


def _check(sources, on, how, null_aware=False):
    from ballista_tpu.physical.mesh_agg import MeshJoinExec as RMeshJoin

    build, probe, rbuild, rprobe = sources
    host = JoinExec(build, probe, on, how, null_aware=null_aware,
                    device="cpu")
    mesh = MeshJoinExec(build, probe, on, how, N_DEV,
                        null_aware=null_aware, device="cpu")
    got = _collect_port(mesh)
    pd.testing.assert_frame_equal(got, _collect_port(host),
                                  check_dtype=False)
    ref = _collect_ref(RMeshJoin(rbuild, rprobe, on, how, N_DEV,
                                 null_aware=null_aware))
    pd.testing.assert_frame_equal(got, ref, check_dtype=False)
    return got


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "full"])
def test_mesh_join_matches_host(eight_devices, how):
    _check(_sources(), [("bk", "pk_")], how)


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_mesh_join_null_keys_match_host(eight_devices, how):
    """NULL join keys never match but outer semantics still emit them."""
    _check(_sources(with_nulls=True), [("bk", "pk_")], how)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "full"])
def test_mesh_join_utf8_remap_matches_host(eight_devices, how):
    """utf8 keys: probe codes are remapped into the build dictionary's
    space inside the program; misses count as unmatched."""
    _check(_utf8_sources(), [("bk", "pk_")], how)


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_mesh_join_composite_codec_matches_host(eight_devices, how):
    """Two-column (utf8, int64) keys take the exact rank codec."""
    _check(_utf8_sources(), [("bk", "pk_"), ("b2", "p2")], how)


@pytest.mark.parametrize("build_nulls", [True, False])
def test_mesh_null_aware_anti_matches_host(eight_devices, build_nulls):
    """SQL NOT IN: a null key on ANY slot's build side empties the
    result; probe null keys are always dropped."""
    got = _check(_sources(with_nulls=build_nulls), [("bk", "pk_")], "anti",
                 null_aware=True)
    if build_nulls:
        assert len(got) == 0  # NULL in the subquery: never true


def test_scheduler_fuses_partitioned_left_join(eight_devices):
    """The fusion pass fuses every partitioned join type, not just
    inner."""
    from ballista_tpu_torch.distributed.planner import DistributedPlanner
    from ballista_tpu_torch.distributed.scheduler import _fuse_mesh_stages
    from ballista_tpu_torch.logical import LogicalPlanBuilder
    from ballista_tpu_torch.physical.planner import (PlannerOptions,
                                                     create_physical_plan)

    bs = pdt.Schema([pdt.Field("bk", pdt.Int64), pdt.Field("bv", pdt.Int64)])
    ps = pdt.Schema([pdt.Field("pk_", pdt.Int64), pdt.Field("pv", pdt.Int64)])
    bsrc = MemTableSource(bs, [[ColumnBatch.from_pydict(
        bs, {"bk": list(range(30)), "bv": list(range(30))}, device="cpu")]])
    psrc = MemTableSource(ps, [[ColumnBatch.from_pydict(
        ps, {"pk_": list(range(50)), "pv": list(range(50))}, device="cpu")]])
    plan = (LogicalPlanBuilder.scan("p", psrc)
            .join(LogicalPlanBuilder.scan("b", bsrc), [("pk_", "bk")],
                  how="left")
            .build())
    phys = create_physical_plan(
        plan, PlannerOptions(join_partition_threshold=1, join_partitions=8,
                             device="cpu"))
    stages = DistributedPlanner().plan_query_stages("j1", phys)
    fused = _fuse_mesh_stages(stages, 8)
    found = []

    def walk(n):
        if isinstance(n, MeshJoinExec):
            found.append(n)
        for c in n.children():
            walk(c)

    for s in fused:
        walk(s.child)
    assert found and found[0].how == "left", [s.child.pretty()
                                              for s in fused]
