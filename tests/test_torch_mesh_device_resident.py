"""The port's device-resident mesh input path: twins of
``tests/test_mesh_device_resident.py``, each on the same input, with 8
CPU slots.

Producer output is laid out over the mesh with device gathers only (the
live counts are the only host reads), dictionaries of different
partitions are unified, and a fused stage whose producer is itself
mesh-fused consumes the producer's stacked output directly (no
re-assembly, zero shuffle files).

The capacity floor of stacked compaction is the port's own choice
(``physical/mesh_input.py`` module doc): the bucket ladder's floor,
1024 rows. On the JAX test's sparse ``[8, 1024]`` input (3 live rows a
slot) that means no compaction, where the JAX test expects 8 rows (and
fails, since its own ladder also floors at 1024); a sparse ``[8,
16384]`` input compacts to 1024. Rows are kept in order either way.

Tolerances: integer and string columns exactly; the decimal sum within
rtol 1e-9, as the JAX test.
"""

import os

import numpy as np
import pandas as pd
import pytest

from ballista_tpu_torch import Decimal, Int64, Utf8, schema
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.columnar import ColumnBatch
from ballista_tpu_torch.distributed.executor import LocalCluster
from ballista_tpu_torch.io.text import TblSource
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.physical import mesh_input

from torch_warm_path import pinned_threads


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    with pinned_threads(1):
        yield


def test_assemble_over_mesh_unifies_dictionaries():
    """Producer partitions with DIFFERENT utf8 dictionaries are unified
    on the device: the stacked batch shares one dictionary and decodes
    to exactly the producer's rows."""
    from ballista_tpu_torch.io.memory import MemTableSource
    from ballista_tpu_torch.logical import LogicalPlanBuilder
    from ballista_tpu_torch.physical.planner import (PlannerOptions,
                                                     create_physical_plan)

    s = schema(("k", Utf8), ("v", Int64))
    parts = [
        {"k": ["apple", "pear", "apple"], "v": [1, 2, 3]},
        {"k": ["kiwi", "pear", "zucchini", "kiwi"], "v": [4, 5, 6, 7]},
    ]
    src = MemTableSource(s, [[ColumnBatch.from_pydict(s, p, device="cpu")]
                             for p in parts])
    phys = create_physical_plan(LogicalPlanBuilder.scan("t", src).build(),
                                PlannerOptions())
    mesh = make_mesh(8, "cpu")
    mesh_input.reset_stats()
    stacked, cap = mesh_input.stacked_input(phys, s, mesh)
    assert mesh_input.STATS["slot_assemblies"] == 1
    assert tuple(stacked.selection.shape) == (8, cap)

    kcol = stacked.columns[0]
    assert kcol.dictionary is not None
    got, got_v = [], []
    for q in range(8):
        live = stacked.selection[q].numpy()
        got += [kcol.dictionary.values[c]
                for c in kcol.values[q].numpy()[live]]
        got_v += list(stacked.columns[1].values[q].numpy()[live])
    assert sorted(got) == sorted(k for p in parts for k in p["k"])
    assert sorted(got_v) == list(range(1, 8))


def test_chained_fused_stages_stay_in_hbm(tmp_path):
    """q5 shape: a partitioned join AND a shuffled aggregation both
    fuse; the aggregation's producer holds the fused join, so its input
    is the join's stacked output (chained), never a re-assembly, and the
    query writes zero shuffle files."""
    d = tmp_path / "dim"
    d.mkdir()
    (d / "p0.tbl").write_text("".join(f"{i}|cat{i % 5}|\n" for i in range(17)))
    f = tmp_path / "fact"
    f.mkdir()
    for part in range(3):
        rows = [f"{i}|{i % 17}|{i + 0.25:.2f}|\n"
                for i in range(300) if i % 3 == part]
        (f / f"p{part}.tbl").write_text("".join(rows))

    cluster = LocalCluster(num_executors=1, concurrent_tasks=2,
                           num_devices=8, device="cpu")
    try:
        mesh_input.reset_stats()
        ctx = BallistaContext.remote(
            "localhost", cluster.port, device="cpu",
            **{"join.partitioned.threshold": "1", "join.partitions": "8",
               "agg.partitions": "8", "mesh.devices": "8"})
        ctx.register_source("dim", TblSource(
            str(d), schema(("dkey", Int64), ("cat", Utf8)), device="cpu"),
            primary_key="dkey")
        ctx.register_source("fact", TblSource(
            str(f), schema(("fid", Int64), ("fkey", Int64),
                           ("v", Decimal(2))), device="cpu"))
        got = ctx.sql("select cat, sum(v) as sv, count(*) as n from fact, "
                      "dim where fkey = dkey group by cat order by cat"
                      ).to_pydict()
        a = np.arange(300)
        fd = pd.DataFrame({"fkey": a % 17, "v": a + 0.25})
        fd["cat"] = fd.fkey.map(lambda k: f"cat{k % 5}")
        exp = fd.groupby("cat").agg(sv=("v", "sum"), n=("v", "size")) \
            .reset_index().sort_values("cat")
        np.testing.assert_array_equal(got["cat"], exp["cat"])
        np.testing.assert_allclose(np.asarray(got["sv"], dtype=float),
                                   exp["sv"], rtol=1e-9)
        np.testing.assert_array_equal(np.asarray(got["n"], dtype=np.int64),
                                      exp["n"].astype(np.int64))
        # the fused agg consumed the fused join's stacked output
        assert mesh_input.STATS["chained_stages"] >= 1, mesh_input.STATS
        files = [x for e in cluster.executors
                 for _r, _, fs in os.walk(e.config.work_dir)
                 for x in fs if x.startswith("shuffle-")]
        assert files == [], f"host shuffle files written: {files}"
    finally:
        cluster.shutdown()


def test_host_funnel_is_gone():
    """No code path materializes producer columns on the host."""
    from ballista_tpu_torch.physical import mesh_agg

    assert not hasattr(mesh_agg, "_run_producer_over_mesh")
    assert not hasattr(mesh_agg, "_stack_device_batches")


@pytest.mark.parametrize("cap,want", [(1024, 1024), (16384, 1024)],
                         ids=["at_the_floor", "above_the_floor"])
def test_stacked_compaction_bounds_chain_capacity(cap, want):
    """A sparse stacked batch (3 live rows a slot) is compacted per slot
    to the bucket ladder's floor before feeding the next fused stage;
    one already at the floor is left as it is."""
    s = schema(("v", Int64))
    mesh = make_mesh(8, "cpu")
    slot_batches = [ColumnBatch.from_numpy(
        s, {"v": np.arange(3, dtype=np.int64) + 10 * q}, capacity=cap,
        device="cpu") for q in range(8)]
    stacked = mesh_input.stack_to_mesh(slot_batches, mesh)
    out = mesh_input._maybe_compact_stacked(stacked, mesh)
    assert int(out.selection.shape[1]) == want
    assert (out is stacked) == (cap == want)
    for q in range(8):
        live = out.selection[q].numpy()
        assert list(out.columns[0].values[q].numpy()[live]) == \
            [10 * q, 10 * q + 1, 10 * q + 2]
