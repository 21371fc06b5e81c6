"""The port's plan serde (``ballista_tpu_torch/serde.py``) against the JAX
package's (``ballista_tpu/serde.py``).

- expressions and logical plans round-trip (the cases of
  ``tests/test_serde.py``), and each serializes to the JAX package's bytes;
- the physical plans of the 22 TPC-H queries at SF0.002 (two files a
  table) round-trip and execute on the CPU equal to the direct collect,
  byte for byte; their bytes equal the JAX package's for the same query;
- a plan the JAX package serialized deserializes in the port and runs
  equal to the port's own;
- the mesh kinds (``mesh_agg``, ``mesh_join``) of the JAX package's
  fused stages deserialize in the port and serialize back to its bytes,
  and ``physical_from_proto`` and ``source_from_proto`` take no plan
  without a device.

Tolerance: exact everywhere (bytes, names, and ``assert_identical`` on
results: the same program on the same inputs).
"""

import pytest

from ballista_tpu import serde as ref_serde
from ballista_tpu import expr as rex
from ballista_tpu.client import BallistaContext as ReferenceContext
from ballista_tpu.execution import plan_logical as reference_plan
from benchmarks.tpch.schema_def import register_tpch as register_reference

from ballista_tpu_torch import (Date32, Decimal, Int64, Utf8, avg, col,
                                count, date_lit, lit, max_, min_, schema,
                                sum_)
from ballista_tpu_torch import expr as ex
from ballista_tpu_torch import serde
from ballista_tpu_torch.errors import SerdeError
from ballista_tpu_torch.execution import collect_physical, plan_logical
from ballista_tpu_torch.io import TblSource
from ballista_tpu_torch.logical import LogicalPlanBuilder
from ballista_tpu_torch.physical.fusion import maybe_fuse
from ballista_tpu_torch.proto import ballista_pb2 as pb

from torch_warm_path import (assert_identical, generate_tpch, pinned_threads,
                             port_ctx, sql)

QUERIES = [f"q{i}" for i in range(1, 23)]


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    with pinned_threads():
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("serde_tpch")))


@pytest.fixture(scope="module")
def port(tpch_dir):
    return port_ctx(tpch_dir)


@pytest.fixture(scope="module")
def reference(tpch_dir):
    ref = ReferenceContext.standalone()
    register_reference(ref, tpch_dir, "tbl")
    return ref


@pytest.fixture(scope="module")
def tbl_source(tmp_path_factory):
    p = tmp_path_factory.mktemp("serde") / "t.tbl"
    p.write_text("1|2.50|x|1995-01-01|\n2|3.75|y|1996-06-15|\n")
    s = schema(("a", Int64), ("b", Decimal(2)), ("c", Utf8), ("d", Date32))
    return TblSource(str(p), s, device="cpu")


EXPRS = [
    col("a"),
    ex.ColumnRef("x", "t"),
    lit(42),
    lit(1.5),
    lit("hello"),
    lit(True),
    lit(None),
    date_lit("1998-09-02"),
    ex.Literal(12345, Decimal(2)),
    (col("a") + lit(1)) * col("b"),
    (col("a") >= lit(10)) & ~(col("c") == lit("x")),
    col("a").is_null(),
    col("a").is_not_null(),
    col("b").alias("renamed"),
    ex.Cast(col("a"), Decimal(4)),
    ex.InList(col("c"), [lit("p"), lit("q")], negated=True),
    ex.Like(col("c"), "%foo_", negated=False),
    ex.case().when(col("a") == lit(1), lit("one")).otherwise(lit("many")),
    ex.Case(col("a"), [(lit(1), lit(10))], None),
    ex.ScalarFunction("sqrt", [col("b")]),
    ex.ScalarFunction("substr", [col("c"), lit(1), lit(2)]),
    sum_(col("b")),
    avg(col("b")),
    min_(col("a")),
    max_(col("a")),
    count(),
    count(col("c")),
    ex.SortExpr(col("a"), ascending=False, nulls_first=True),
]


@pytest.mark.parametrize("e", EXPRS, ids=lambda e: e.name()[:40])
def test_expr_roundtrip_and_reference_bytes(e):
    p = serde.expr_to_proto(e)
    e2 = serde.expr_from_proto(p)
    assert e2.name() == e.name()
    wire = p.SerializeToString()
    assert serde.expr_to_proto(e2).SerializeToString() == wire
    # the JAX package reads the same bytes into the same expression and
    # writes them back unchanged
    node = pb.LogicalExprNode()
    node.ParseFromString(wire)
    theirs = ref_serde.expr_from_proto(node)
    assert isinstance(theirs, rex.Expr)
    assert theirs.name() == e.name()
    assert ref_serde.expr_to_proto(theirs).SerializeToString() == wire


def _plans(src):
    b = LogicalPlanBuilder.scan("t", src)
    return [
        b.build(),
        b.filter((col("a") > lit(1))
                 & (col("d") < date_lit("1996-01-01"))).build(),
        b.project([col("a"), (col("b") * lit(2)).alias("bb")]).build(),
        b.aggregate([col("c")], [sum_(col("b")).alias("s"),
                                 count().alias("n")]).build(),
        b.sort([ex.SortExpr(col("b"), ascending=False)]).limit(5).build(),
        b.repartition(4, [col("a")]).build(),
        b.join(LogicalPlanBuilder.scan("t2", src), on=[("a", "a")],
               how="left").build(),
    ]


@pytest.mark.parametrize("i", range(7))
def test_logical_plan_roundtrip(tbl_source, i):
    plan = _plans(tbl_source)[i]
    p = serde.plan_to_proto(plan)
    plan2 = serde.plan_from_proto(p, device="cpu")
    assert plan2.pretty() == plan.pretty()
    assert plan2.schema() == plan.schema()
    assert serde.plan_to_proto(plan2).SerializeToString() == \
        p.SerializeToString()


def _roundtrip(phys):
    wire = serde.physical_to_proto(phys).SerializeToString()
    node = pb.PhysicalPlanNode()
    node.ParseFromString(wire)
    return wire, serde.physical_from_proto(node, device="cpu")


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_physical_roundtrip_executes_equal(port, q):
    phys = plan_logical(port.sql(sql(q)).plan, port._planner_options())
    wire, back = _roundtrip(phys)
    assert back.pretty() == phys.pretty()
    assert serde.physical_to_proto(back).SerializeToString() == wire
    got = collect_physical(maybe_fuse(back))
    assert_identical(got, collect_physical(maybe_fuse(phys)), q)


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_physical_bytes_equal_reference(port, reference, q):
    mine = serde.physical_to_proto(
        plan_logical(port.sql(sql(q)).plan, port._planner_options()))
    theirs = ref_serde.physical_to_proto(
        reference_plan(reference.sql(sql(q)).plan))
    assert mine.SerializeToString() == theirs.SerializeToString(), q


@pytest.mark.parametrize("q", ["q3", "q13"])
def test_reference_written_plan_runs_in_port(port, reference, q):
    wire = ref_serde.physical_to_proto(
        reference_plan(reference.sql(sql(q)).plan)).SerializeToString()
    node = pb.PhysicalPlanNode()
    node.ParseFromString(wire)
    theirs = serde.physical_from_proto(node, device="cpu")
    assert_identical(collect_physical(maybe_fuse(theirs)),
                     port.sql(sql(q)).to_pydict(), q)


@pytest.mark.parametrize("kind,item", [
    ("mesh_join", "item 10"), ("mesh_agg", "item 10"),
])
def test_later_items_raise_serde_error(reference, kind, item):
    """The mesh kinds no longer raise: ROADMAP queue 1 ``item`` ported
    them. The JAX package's mesh-fused stages of q3 (``mesh_join``) and
    q1 (``mesh_agg``), 8 devices, deserialize in the port on the device
    asked for, hold the kind's operator, and serialize back to the JAX
    package's bytes."""
    from ballista_tpu.distributed.planner import DistributedPlanner
    from ballista_tpu.distributed.scheduler import _fuse_mesh_stages
    from ballista_tpu.physical.planner import PlannerOptions
    from ballista_tpu_torch.physical.mesh_agg import (MeshAggExec,
                                                      MeshJoinExec)

    assert item == "item 10"
    q = "q3" if kind == "mesh_join" else "q1"
    phys = reference_plan(reference.sql(sql(q)).plan, PlannerOptions(
        agg_partitions=4, join_partition_threshold=100))
    stages = _fuse_mesh_stages(
        DistributedPlanner().plan_query_stages("j", phys), 8)
    want = MeshJoinExec if kind == "mesh_join" else MeshAggExec
    found = []

    def walk(n):
        found.extend([n] if isinstance(n, want) else [])
        for c in n.children():
            walk(c)

    for stage in stages:
        wire = ref_serde.physical_to_proto(stage.child)
        node = serde.physical_from_proto(wire, device="cpu")
        walk(node)
        assert serde.physical_to_proto(node).SerializeToString() == \
            wire.SerializeToString()
    assert found and all(n.n_devices == 8 and n.device.type == "cpu"
                         for n in found)


@pytest.mark.parametrize("analyze", [False, True],
                         ids=["explain", "explain_analyze"])
def test_explain_nodes_deserialize(port, reference, analyze):
    """The EXPLAIN kinds: q1's plan serializes to the JAX package's
    bytes and deserializes onto the device asked for, and the rebuilt
    node runs."""
    from ballista_tpu_torch.physical.explain import (ExplainAnalyzeExec,
                                                     ExplainExec)

    text = ("explain analyze " if analyze else "explain ") + sql("q1")
    mine = serde.physical_to_proto(
        plan_logical(port.sql(text).plan, port._planner_options()))
    theirs = ref_serde.physical_to_proto(
        reference_plan(reference.sql(text).plan))
    assert mine.SerializeToString() == theirs.SerializeToString()
    back = serde.physical_from_proto(mine, device="cpu")
    assert isinstance(back, ExplainAnalyzeExec if analyze else ExplainExec)
    assert back.device.type == "cpu"
    out = collect_physical(back)
    want = ("plan_with_metrics" if analyze else "physical_plan")
    assert want in list(out["plan_type"])


def test_system_source_raises_serde_error():
    """A system-table source ships its rows and is rebuilt from them on
    the device asked for (the cluster path's system tables); a source
    kind that is not remotable still raises SerdeError."""
    import json

    rows = [{"executor_id": "e1", "num_devices": 1}]
    desc = pb.TableSourceDesc(kind="system", path="system.executors",
                              payload=json.dumps(rows).encode())
    src = serde.source_from_proto(desc, device="cpu")
    assert src.table == "system.executors" and src.current_rows() == rows
    [batch] = list(src.scan(0))
    assert batch.device.type == "cpu"
    assert batch.to_pydict()["executor_id"].tolist() == ["e1"]
    with pytest.raises(SerdeError, match="not remotable"):
        serde.source_from_proto(
            pb.TableSourceDesc(kind="memory", path="t"), device="cpu")


def test_deserializing_needs_a_device(tbl_source):
    from ballista_tpu_torch.physical.operators import ScanExec

    node = serde.physical_to_proto(ScanExec("t", tbl_source))
    with pytest.raises(TypeError):
        serde.physical_from_proto(node)
    with pytest.raises(TypeError):
        serde.source_from_proto(node.scan.source)
    with pytest.raises(TypeError):
        serde.plan_from_proto(serde.plan_to_proto(_plans(tbl_source)[0]))
    back = serde.physical_from_proto(node, device="cpu")
    assert back.source.device.type == "cpu"


def test_location_and_stats_roundtrip():
    from ballista_tpu_torch.distributed.types import PartitionLocation

    loc = PartitionLocation(
        "job1", 2, 3, "exec", "localhost", 5000, path="/x/y",
        stats={"num_rows": 7, "num_batches": 1, "num_bytes": 99,
               "shuffle_partition_bytes": [40, 59],
               "columns": [{"name": "a", "null_count": 0,
                            "distinct_count": 3, "min": 1, "max": 9}]},
        shuffle_output=1)
    p = serde.location_to_proto(loc)
    assert serde.location_from_proto(p) == loc
    assert ref_serde.location_to_proto(
        ref_serde.location_from_proto(p)).SerializeToString() == \
        p.SerializeToString()
