"""The first slice end to end: TPC-H q1 and q6 through the port's
standalone entry points on the CPU equal the JAX package exactly, and the
pandas oracle (the repo's golden source) within the float tolerance the
TPC-H tests use — every q1/q6 output is a scaled-int64 decimal, a count or
a dictionary string, but the oracle computes in float64."""

import os

import numpy as np
import pytest

from benchmarks.tpch import datagen, oracle
from benchmarks.tpch.schema_def import register_tpch as register_reference
import ballista_tpu as ref_pkg
from ballista_tpu.client import BallistaContext as ReferenceContext

import ballista_tpu_torch as bt
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.errors import ExecutionError, NotImplementedError_
from ballista_tpu_torch.kernels import aggregate as agg_mod
from ballista_tpu_torch.physical.aggregate import HashAggregateExec
from ballista_tpu_torch.physical.operators import MergeExec, SortExec
from ballista_tpu_torch.testing.tpch_schema import register_tpch

from torch_warm_path import pinned_threads


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """Two torch, ingest and scanner threads for this file's queries
    (``torch_warm_path.pinned_threads``)."""
    with pinned_threads():
        yield


QDIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "tpch",
                    "queries")


def _sql(q):
    return open(os.path.join(QDIR, f"{q}.sql")).read()


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_q1"))
    datagen.generate(d, scale=0.002, num_parts=2)
    ref = ReferenceContext.standalone()
    register_reference(ref, d, "tbl")
    port = BallistaContext.standalone(device="cpu")
    register_tpch(port, d)
    return ref, port, oracle.load_tables(d, only=["lineitem"])


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_query_equals_reference_exactly(tpch, q):
    ref, port, _ = tpch
    want = ref.sql(_sql(q)).collect()
    got = port.sql(_sql(q)).to_pydict()
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype, c
        np.testing.assert_array_equal(got[c], w, err_msg=c)


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_query_equals_oracle(tpch, q):
    _, port, tables = tpch
    got = port.sql(_sql(q)).collect()
    exp = oracle.ORACLES[q](tables).reset_index(drop=True)
    assert list(got.columns) == list(exp.columns)
    assert len(got) == len(exp)
    for c in exp.columns:
        g, e = got[c], exp[c]
        if e.dtype.kind in "fc":
            np.testing.assert_allclose(g.astype(float), e.astype(float),
                                       rtol=1e-6, atol=1e-6, err_msg=c)
        else:
            np.testing.assert_array_equal(g.to_numpy(), e.to_numpy(),
                                          err_msg=c)


def test_q1_runs_the_dense_sums_path(tpch, monkeypatch):
    """Partial aggregate per partition (2 files) + final aggregate: three
    calls of dense_grouped_sums, the kernel on a card."""
    _, port, _ = tpch
    calls = []
    real = agg_mod.dense_grouped_sums

    def spy(gids, live, values, g):
        calls.append((int(gids.shape[0]), len(values), g))
        return real(gids, live, values, g)

    monkeypatch.setattr(agg_mod, "dense_grouped_sums", spy)
    df = port.sql(_sql("q1"))
    df.to_pydict()
    assert len(calls) == 3
    assert all(g == 6 for _, _, g in calls)  # 3 return flags x 2 statuses
    assert [k for _, k, _ in calls[:2]] == [7, 7]  # 4 sums + 3 avg sums
    chain, node = [], df.physical_plan()
    while node.children():
        chain.append(node)
        node = node.children()[0]
    aggs = [n for n in chain if isinstance(n, HashAggregateExec)]
    assert isinstance(chain[0], SortExec)
    assert [a.mode for a in aggs] == ["final", "partial"]
    assert isinstance(aggs[0].child, MergeExec)
    assert aggs[0].child.child is aggs[1]


def test_recollect_reuses_plan_and_gives_same_result(tpch):
    _, port, _ = tpch
    df = port.sql(_sql("q1"))
    a = df.to_pydict()
    phys = df.physical_plan()
    b = df.to_pydict()
    assert df.physical_plan() is phys
    for c in a:
        np.testing.assert_array_equal(a[c], b[c])
    assert "output_rows=4" in phys.pretty_metrics()


def test_dataframe_api_and_memtable():
    ctx = BallistaContext.standalone(device="cpu")
    ctx.register_memtable(
        "t", bt.schema(("k", bt.Utf8), ("v", bt.Decimal(2)), ("n", bt.Int64)),
        {"k": ["b", "a", "b", "c", "a"], "v": [1.5, -2.25, 3.0, 0.5, 1.0],
         "n": [1, 2, 3, 4, 5]}, num_partitions=2)
    out = ctx.sql("select k, sum(v) as s, count(*) as c, min(n) as lo, "
                  "avg(v) as a from t where n > 1 group by k order by k"
                  ).to_pydict()
    assert list(out["k"]) == ["a", "b", "c"]
    np.testing.assert_array_equal(out["s"], [-1.25, 3.0, 0.5])
    assert list(out["c"]) == [2, 1, 1] and list(out["lo"]) == [2, 3, 4]
    np.testing.assert_array_equal(out["a"], [-0.625, 3.0, 0.5])
    df = ctx.table("t").filter(bt.col("n") >= bt.lit(3)).aggregate(
        [], [bt.sum_(bt.col("n")).alias("total")])
    assert int(df.to_pydict()["total"][0]) == 12
    assert ctx.table("t").count() == 5


def test_standalone_defaults_to_cuda_and_never_falls_back():
    import torch

    if torch.cuda.is_available():
        assert BallistaContext.standalone().device.type == "cuda"
    else:
        with pytest.raises(ExecutionError, match="device='cpu'"):
            BallistaContext.standalone()


def _assert_equals_reference(got, want):
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        if w.dtype.kind == "M":  # pandas holds dates at second precision
            w = w.astype("datetime64[D]")
        np.testing.assert_array_equal(got[c], w, err_msg=c)


def test_unported_operators_raise_and_name_the_queue(tpch):
    """Joins and grouping by a key without a small known cardinality raised
    here until queue 1 item 6 was ported; both now run and equal the JAX
    package."""
    ref, port, _ = tpch
    sql = ("select l_orderkey, sum(l_quantity) as q from lineitem "
           "group by l_orderkey order by l_orderkey")
    for query in (_sql("q3"), sql):
        _assert_equals_reference(port.sql(query).to_pydict(),
                                 ref.sql(query).collect())


def test_settings_asking_for_unported_operators_raise(tpch):
    """``agg.partitions`` (the hash-shuffled aggregation) raised until it
    was ported; it now plans a hash repartition and equals the JAX
    package under the same setting."""
    from ballista_tpu_torch.physical.operators import RepartitionExec

    ctx = BallistaContext.standalone(device="cpu", **{"agg.partitions": "4"})
    ref_ctx = ReferenceContext.standalone(**{"agg.partitions": "4"})
    sql = "select k, count(*) as n from t group by k order by k"
    data = {"k": ["a", "c", "b", "a", "c", "a"]}
    ctx.register_memtable("t", bt.schema(("k", "utf8")), data)
    ref_ctx.register_memtable("t", ref_pkg.schema(("k", "utf8")), data)
    df = ctx.sql(sql)
    _assert_equals_reference(df.to_pydict(), ref_ctx.sql(sql).collect())
    node = df.physical_plan()
    while not isinstance(node, RepartitionExec):
        node = node.children()[0]
    assert node.num_partitions == 4


def test_explain_renders_the_plan_as_the_reference():
    """EXPLAIN returns the JAX package's two rows, text for text."""
    ctx = BallistaContext.standalone(device="cpu")
    ref_ctx = ReferenceContext.standalone()
    ctx.register_memtable("t", bt.schema(("k", "utf8")), {"k": ["a"]})
    ref_ctx.register_memtable("t", ref_pkg.schema(("k", "utf8")),
                              {"k": ["a"]})
    got = ctx.sql("explain select k from t").to_pydict()
    want = ref_ctx.sql("explain select k from t").collect()
    assert list(got["plan_type"]) == ["logical_plan", "physical_plan"]
    assert list(got["plan_type"]) == list(want["plan_type"])
    assert list(got["plan"]) == list(want["plan"])


def test_produce_diagram_links_stages():
    from types import SimpleNamespace

    from ballista_tpu_torch.physical.operators import EmptyExec
    from ballista_tpu_torch.utils import produce_diagram

    producer = SimpleNamespace(stage_id=1, child=EmptyExec("cpu"))
    reader = EmptyExec("cpu")
    reader.query_stage_ids = [1]
    consumer = SimpleNamespace(stage_id=2, child=MergeExec(reader))
    dot = produce_diagram([producer, consumer])
    assert "subgraph cluster_1" in dot and "subgraph cluster_2" in dot
    assert "s1_n0 -> s2_n2 [style=dashed];" in dot


def test_csv_source_with_header_matches_reference(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("k,v,d\nb,1.25,1995-01-02\na,-2.50,1994-12-31\n"
                    "b,3.00,1996-02-29\n")
    sql = ("select k, sum(v) as s, max(d) as d from t group by k "
           "order by k")
    ref_ctx = ReferenceContext.standalone()
    ref_ctx.register_csv("t", str(path), ref_pkg.schema(
        ("k", "utf8"), ("v", "decimal(10,2)"), ("d", "date")))
    port_ctx = BallistaContext.standalone(device="cpu")
    port_ctx.register_csv("t", str(path), bt.schema(
        ("k", "utf8"), ("v", "decimal(10,2)"), ("d", "date")))
    want = ref_ctx.sql(sql).collect()
    got = port_ctx.sql(sql).to_pydict()
    for c in want.columns:
        np.testing.assert_array_equal(got[c], want[c].to_numpy(), err_msg=c)
