"""The in-mesh shuffle in the port's distributed runtime: twins of
``tests/test_mesh_agg.py``, each on the same input, with 8 CPU slots.

A hash-shuffled SQL aggregation scheduled onto an executor that reports
a mesh of 8 slots runs as ONE fused program (a row exchange between the
slots + a per-slot final aggregate) and writes NO shuffle files through
the data plane; a partitioned join fuses into one ``MeshJoinExec``; the
host-file shuffle stays the path without a mesh. The fused stage
serializes to the JAX package's bytes; a mesh task goes only to an
executor with enough slots; the fleet's reports, not the client's
``mesh.devices``, drive fusion, and a client claim the fleet contradicts
fails the job.

Tolerances: integer and string columns exactly; the decimal sum of the
join case within rtol 1e-9, as the JAX test.
"""

import os

import numpy as np
import pandas as pd
import pytest

from ballista_tpu_torch import Decimal, Int64, Utf8, count, schema, serde
from ballista_tpu_torch import col, sum_
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.distributed.executor import LocalCluster
from ballista_tpu_torch.distributed.planner import DistributedPlanner
from ballista_tpu_torch.distributed.scheduler import _fuse_mesh_stages
from ballista_tpu_torch.io.text import TblSource
from ballista_tpu_torch.logical import LogicalPlanBuilder
from ballista_tpu_torch.physical.mesh_agg import MeshAggExec
from ballista_tpu_torch.physical.planner import (PlannerOptions,
                                                 create_physical_plan)

from torch_warm_path import pinned_threads


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """One torch, ingest and scanner thread: these files run clusters."""
    with pinned_threads(1):
        yield


def _write_mem(tmp_path, n=500, mod=23, parts=3, name="t"):
    rng = np.random.default_rng(7)
    keys = [f"g{i}" for i in rng.integers(0, mod, n)]
    vals = rng.integers(0, 100, n)
    d = tmp_path / name
    d.mkdir()
    per = -(-n // parts)
    for p in range(parts):
        lines = [f"{keys[i]}|{vals[i]}|"
                 for i in range(p * per, min((p + 1) * per, n))]
        (d / f"part{p}.tbl").write_text("\n".join(lines) + "\n")
    return str(d), pd.DataFrame({"k": keys, "v": vals})


def _mem(tmp_path, **kw):
    d, df = _write_mem(tmp_path, **kw)
    return TblSource(d, schema(("k", Utf8), ("v", Int64)), device="cpu"), df


def _shuffle_files(cluster):
    files = []
    for e in cluster.executors:
        for _root, _, fs in os.walk(e.config.work_dir):
            files += [f for f in fs if f.startswith("shuffle-")]
    return files


def _assert_frame(got, exp, cols):
    for c in cols:
        g, e = np.asarray(got[c]), np.asarray(exp[c])
        if g.dtype.kind in "iu" or e.dtype.kind in "iu":
            g, e = g.astype(np.int64), e.astype(np.int64)
        np.testing.assert_array_equal(g, e, err_msg=c)


def test_fusion_pattern_and_serde(tmp_path):
    from ballista_tpu import col as rcol, count as rcount, schema as rschema
    from ballista_tpu import sum_ as rsum, Int64 as RInt64, Utf8 as RUtf8
    from ballista_tpu import serde as rserde
    from ballista_tpu.distributed.planner import \
        DistributedPlanner as RPlanner
    from ballista_tpu.distributed.scheduler import \
        _fuse_mesh_stages as rfuse
    from ballista_tpu.io import TblSource as RTbl
    from ballista_tpu.logical import LogicalPlanBuilder as RBuilder
    from ballista_tpu.physical.planner import (
        PlannerOptions as ROpts, create_physical_plan as rcreate)

    d, _ = _write_mem(tmp_path)
    src = TblSource(d, schema(("k", Utf8), ("v", Int64)), device="cpu")
    plan = (LogicalPlanBuilder.scan("t", src)
            .aggregate([col("k")], [sum_(col("v")).alias("sv"),
                                    count().alias("n")])
            .build())
    phys = create_physical_plan(plan, PlannerOptions(agg_partitions=4))
    stages = DistributedPlanner().plan_query_stages("j1", phys)
    # unfused: a hash-shuffle producer stage + a final-agg consumer
    assert any(s.shuffle_hash_exprs for s in stages)

    fused = _fuse_mesh_stages(stages, 8)
    assert len(fused) == len(stages) - 1
    mesh_stage = fused[-1]
    assert isinstance(mesh_stage.child, MeshAggExec)
    assert mesh_stage.child.n_devices == 8
    # the fused node round-trips through proto serde
    rt = serde.physical_from_proto(serde.physical_to_proto(mesh_stage.child),
                                   device="cpu")
    assert isinstance(rt, MeshAggExec) and rt.n_devices == 8
    assert [e.name() for e in rt.hash_exprs] == ["k"]
    # ... to the JAX package's bytes for the same query
    rsrc = RTbl(d, rschema(("k", RUtf8), ("v", RInt64)))
    rplan = (RBuilder.scan("t", rsrc)
             .aggregate([rcol("k")], [rsum(rcol("v")).alias("sv"),
                                      rcount().alias("n")])
             .build())
    rstages = rfuse(RPlanner().plan_query_stages(
        "j1", rcreate(rplan, ROpts(agg_partitions=4))), 8)
    assert [s.stage_id for s in fused] == [s.stage_id for s in rstages]
    for mine, theirs in zip(fused, rstages):
        assert serde.physical_to_proto(mine.child).SerializeToString() == \
            rserde.physical_to_proto(theirs.child).SerializeToString()

    # gate respected: no mesh -> untouched
    assert _fuse_mesh_stages(stages, 0) == stages


def test_mesh_task_assignment_respects_num_devices():
    """A mesh-fused task must not be handed to an executor with fewer
    devices; plain tasks still flow to it."""
    from ballista_tpu_torch.distributed.state import (MemoryBackend,
                                                      SchedulerState)
    from ballista_tpu_torch.distributed.types import PartitionId

    state = SchedulerState(MemoryBackend())
    state.save_stage_plan("j1", 1, b"", 1, [], mesh_devices=8)
    state.save_stage_plan("j1", 2, b"", 1, [], mesh_devices=0)
    state._ready = [PartitionId("j1", 1, 0), PartitionId("j1", 2, 0)]
    # 1-device executor: skips the mesh task, gets the plain one
    assert state.next_task(num_devices=1) == PartitionId("j1", 2, 0)
    # 8-device executor: gets the mesh task
    assert state.next_task(num_devices=8) == PartitionId("j1", 1, 0)
    assert state.next_task(num_devices=8) is None


def test_cluster_mesh_shuffle_agg(tmp_path):
    src, df = _mem(tmp_path, n=800, mod=31)
    cluster = LocalCluster(num_executors=1, concurrent_tasks=2,
                           num_devices=8, device="cpu")
    try:
        ctx = BallistaContext.remote(
            "localhost", cluster.port, device="cpu",
            **{"agg.partitions": "8", "mesh.devices": "8"})
        ctx.register_source("t", src)
        got = ctx.sql("select k, sum(v) as sv, count(*) as n from t "
                      "group by k order by k").to_pydict()
        exp = df.groupby("k").agg(sv=("v", "sum"), n=("v", "size")) \
            .reset_index().sort_values("k")
        _assert_frame(got, exp, ["k", "sv", "n"])
        # the exchange stayed in the fused program: no shuffle files
        assert _shuffle_files(cluster) == []
    finally:
        cluster.shutdown()


def _write_dim_fact(tmp_path):
    d = tmp_path / "dim"
    d.mkdir()
    (d / "p0.tbl").write_text("".join(f"{i}|cat{i % 3}|\n" for i in range(11)))
    f = tmp_path / "fact"
    f.mkdir()
    for part in range(2):
        rows = [f"{i}|{i % 11}|{i + 0.5:.2f}|\n"
                for i in range(120) if i % 2 == part]
        (f / f"p{part}.tbl").write_text("".join(rows))
    return str(d), str(f)


def test_cluster_mesh_shuffle_join(tmp_path):
    """A partitioned inner join under mesh.devices fuses into ONE
    MeshJoinExec task: both sides exchanged between slots, joined per
    slot, zero shuffle files."""
    d, f = _write_dim_fact(tmp_path)
    cluster = LocalCluster(num_executors=1, concurrent_tasks=2,
                           num_devices=8, device="cpu")
    try:
        ctx = BallistaContext.remote(
            "localhost", cluster.port, device="cpu",
            **{"join.partitioned.threshold": "1", "join.partitions": "8",
               "mesh.devices": "8"})
        ctx.register_source("dim", TblSource(
            d, schema(("dkey", Int64), ("cat", Utf8)), device="cpu"),
            primary_key="dkey")
        ctx.register_source("fact", TblSource(
            f, schema(("fid", Int64), ("fkey", Int64), ("v", Decimal(2))),
            device="cpu"))
        got = ctx.sql("select cat, sum(v) as sv, count(*) as n from fact, "
                      "dim where fkey = dkey group by cat order by cat"
                      ).to_pydict()
        a = np.arange(120)
        fd = pd.DataFrame({"fkey": a % 11, "v": a + 0.5})
        fd["cat"] = fd.fkey.map(lambda k: f"cat{k % 3}")
        exp = fd.groupby("cat").agg(sv=("v", "sum"), n=("v", "size")) \
            .reset_index().sort_values("cat")
        _assert_frame(got, exp, ["cat", "n"])
        np.testing.assert_allclose(np.asarray(got["sv"], dtype=float),
                                   exp["sv"], rtol=1e-9)
        assert _shuffle_files(cluster) == []
    finally:
        cluster.shutdown()


def test_cluster_file_shuffle_without_mesh_setting(tmp_path):
    """The same shape WITHOUT a mesh: the host-file shuffle runs (and
    still matches), so the fusion is what removed the files above."""
    src, df = _mem(tmp_path, n=300, mod=11)
    cluster = LocalCluster(num_executors=1, concurrent_tasks=2,
                           device="cpu")
    try:
        ctx = BallistaContext.remote("localhost", cluster.port, device="cpu",
                                     **{"agg.partitions": "4"})
        ctx.register_source("t", src)
        got = ctx.sql("select k, sum(v) as sv from t group by k order by k"
                      ).to_pydict()
        exp = df.groupby("k").agg(sv=("v", "sum")).reset_index() \
            .sort_values("k")
        _assert_frame(got, exp, ["k", "sv"])
        assert _shuffle_files(cluster), "expected host shuffle files"
    finally:
        cluster.shutdown()


def _wait_registered(cluster, n=1, t=5.0):
    import time

    deadline = time.time() + t
    while len(cluster.state.get_executors_metadata()) < n:
        assert time.time() < deadline, "executors never registered"
        time.sleep(0.05)


def test_mesh_fusion_driven_by_fleet_reports(tmp_path):
    """Fusion fires with NO client mesh.devices setting: the scheduler
    reads the fleet's uniformly reported num_devices."""
    src, df = _mem(tmp_path, n=600, mod=19)
    cluster = LocalCluster(num_executors=1, concurrent_tasks=2,
                           num_devices=8, device="cpu")
    try:
        _wait_registered(cluster)
        ctx = BallistaContext.remote("localhost", cluster.port, device="cpu",
                                     **{"agg.partitions": "8"})
        ctx.register_source("t", src)
        got = ctx.sql("select k, sum(v) as sv from t group by k order by k"
                      ).to_pydict()
        exp = df.groupby("k").agg(sv=("v", "sum")).reset_index() \
            .sort_values("k")
        _assert_frame(got, exp, ["k", "sv"])
        assert _shuffle_files(cluster) == [], "fleet-driven fusion missing"
    finally:
        cluster.shutdown()


def test_lying_client_cannot_change_plan_shape(tmp_path):
    """A client claiming mesh.devices=8 against a 1-device fleet fails
    the job loudly: never silently fuse OR silently unfuse."""
    from ballista_tpu_torch.errors import ClusterError

    src, _ = _mem(tmp_path, n=100, mod=5)
    cluster = LocalCluster(num_executors=1, concurrent_tasks=2,
                           num_devices=1, device="cpu")
    try:
        _wait_registered(cluster)
        ctx = BallistaContext.remote(
            "localhost", cluster.port, device="cpu",
            **{"agg.partitions": "4", "mesh.devices": "8"})
        ctx.register_source("t", src)
        with pytest.raises(ClusterError, match="mesh.devices=8"):
            ctx.sql("select k, sum(v) as sv from t group by k").to_pydict()
    finally:
        cluster.shutdown()
