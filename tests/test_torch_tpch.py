"""All 22 TPC-H queries through the port's standalone collect on the CPU.

Each query at SF0.002 equals the JAX package (integer, decimal, date and
string columns exactly, float columns within rtol 1e-6) and the pandas
oracle of ``benchmarks/tpch/oracle.py`` (within the tolerance
``tests/test_tpch.py`` uses: the oracle computes in float64). q3, q5, q10
and q18 also run with the co-partitioned join and the hash-shuffled
aggregation forced on at this size, against the JAX package under the
same settings. Then joins outside TPC-H's shapes: composite keys beyond
the packing range, a utf8 key across dictionaries, duplicates under a
left join, a full outer join and NOT IN with a NULL."""

import os

import numpy as np
import pandas as pd
import pytest

from benchmarks.tpch import datagen, oracle
from benchmarks.tpch.schema_def import register_tpch as register_reference
import ballista_tpu as ref_pkg
from ballista_tpu.client import BallistaContext as ReferenceContext
from ballista_tpu.io import MemTableSource as RefMemTable

import ballista_tpu_torch as bt
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.io import MemTableSource
from ballista_tpu_torch.physical.join import JoinExec
from ballista_tpu_torch.physical.operators import RepartitionExec
from ballista_tpu_torch.testing.tpch_schema import register_tpch

from torch_warm_path import pinned_threads


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """Two torch, ingest and scanner threads for this file's queries
    (``torch_warm_path.pinned_threads``)."""
    with pinned_threads():
        yield


QUERIES = [f"q{i}" for i in range(1, 23)]
QDIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "tpch",
                    "queries")
# the adaptive pass would demote or coalesce these operators away at this
# size (tests/test_torch_adaptive.py runs them with it on)
SHUFFLED = {"join.partitioned.threshold": "100", "agg.partitions": "4",
            "adaptive.enabled": "off"}


def _sql(q):
    return open(os.path.join(QDIR, f"{q}.sql")).read()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_port"))
    datagen.generate(d, scale=0.002, num_parts=2)
    return d


def _contexts(data_dir, settings):
    ref = ReferenceContext.standalone(**settings)
    register_reference(ref, data_dir, "tbl")
    port = BallistaContext.standalone(device="cpu", **settings)
    register_tpch(port, data_dir)
    return ref, port


@pytest.fixture(scope="module")
def plain(data_dir):
    return _contexts(data_dir, {})


@pytest.fixture(scope="module")
def shuffled(data_dir):
    return _contexts(data_dir, SHUFFLED)


def _assert_equals_reference(got, want: pd.DataFrame):
    """``got`` (the port's to_pydict) against the JAX package's frame."""
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        g = got[c]
        assert g.shape == w.shape, c
        if w.dtype.kind == "f":
            assert g.dtype.kind == "f", c
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=c)
        elif w.dtype.kind == "M":  # pandas holds dates at second precision
            assert g.dtype == np.dtype("datetime64[D]"), c
            np.testing.assert_array_equal(g, w.astype("datetime64[D]"),
                                          err_msg=c)
        else:
            assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=c)


@pytest.mark.parametrize("q", QUERIES)
def test_query_equals_reference(plain, q):
    ref, port = plain
    _assert_equals_reference(port.sql(_sql(q)).to_pydict(),
                             ref.sql(_sql(q)).collect())


def _normalize(df: pd.DataFrame) -> pd.DataFrame:
    out = df.copy()
    for c in out.columns:
        if out[c].dtype.kind == "M":
            out[c] = out[c].values.astype("datetime64[D]")
    return out.reset_index(drop=True)


@pytest.fixture(scope="module")
def oracle_tables(data_dir):
    return oracle.load_tables(data_dir)


@pytest.mark.parametrize("q", QUERIES)
def test_query_equals_oracle(plain, oracle_tables, q):
    _, port = plain
    got = _normalize(port.sql(_sql(q)).collect())
    exp = _normalize(oracle.ORACLES[q](oracle_tables))
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


@pytest.mark.parametrize("q", ["q3", "q5", "q10", "q18"])
def test_copartitioned_join_and_shuffled_aggregate(shuffled, q):
    ref, port = shuffled
    df = port.sql(_sql(q))
    _assert_equals_reference(df.to_pydict(), ref.sql(_sql(q)).collect())
    plan = df.physical_plan()
    nodes, stack = [], [plan]
    while stack:
        n = stack.pop()
        nodes.append(n)
        stack.extend(n.children())
    assert any(isinstance(n, JoinExec) and n.partitioned
               and isinstance(n.build, RepartitionExec)
               and isinstance(n.probe, RepartitionExec) for n in nodes)
    hashed = [n for n in nodes if isinstance(n, RepartitionExec)]
    assert any(n.num_partitions == 4 for n in hashed)  # the shuffled agg


# ---------------------------------------------------------------------------
# joins outside TPC-H's shapes (the cases of tests/test_composite_join.py,
# tests/test_full_outer.py and tests/test_sql.py)
# ---------------------------------------------------------------------------


def _both(tables, sql):
    """Run ``sql`` over memtables (two partitions each) in both packages;
    the port's result must equal the JAX package's."""
    ref = ReferenceContext.standalone()
    port = BallistaContext.standalone(device="cpu")
    for name, (cols, data) in tables.items():
        ref.register_source(name, RefMemTable.from_pydict(
            ref_pkg.schema(*cols), data, num_partitions=2))
        port.register_source(name, MemTableSource.from_pydict(
            bt.schema(*cols), data, num_partitions=2, device="cpu"))
    got = port.sql(sql).to_pydict()
    _assert_equals_reference(got, ref.sql(sql).collect())
    return got


def test_three_key_inner_join():
    rng = np.random.default_rng(3)
    n, m = 400, 60
    left = {k: rng.integers(0, hi, n) for k, hi in
            (("a", 5), ("b", 7), ("c", 3), ("v", 100))}
    right = {k: rng.integers(0, hi, m) for k, hi in
             (("x", 5), ("y", 7), ("z", 3), ("w", 100))}
    got = _both({"l": ([(c, "int64") for c in left], left),
                 "r": ([(c, "int64") for c in right], right)},
                "select sum(v + w) as s, count(*) as n from l, r "
                "where a = x and b = y and c = z")
    j = pd.DataFrame(left).merge(pd.DataFrame(right),
                                 left_on=["a", "b", "c"],
                                 right_on=["x", "y", "z"])
    assert int(got["n"][0]) == len(j) > 0


def test_two_key_join_beyond_packing_range():
    big = 1 << 40
    got = _both(
        {"l": ([("a", "int64"), ("b", "int64"), ("v", "int64")],
               {"a": [big, big + 1, big + 2, 5], "b": [-7, -7, 9, 9],
                "v": [0, 1, 2, 3]}),
         "r": ([("x", "int64"), ("y", "int64"), ("w", "int64")],
               {"x": [big, big + 2, big + 9], "y": [-7, 9, 9],
                "w": [10, 20, 30]})},
        "select v, w from l, r where a = x and b = y order by v")
    assert list(got["v"]) == [0, 2] and list(got["w"]) == [10, 20]


@pytest.mark.parametrize("how", ["inner", "left"])
def test_utf8_join_key_across_dictionaries(how):
    got = _both(
        {"l": ([("name", "utf8"), ("v", "int64")],
               {"name": ["delta", "alpha", "echo", "bravo"],
                "v": [0, 1, 2, 3]}),
         "r": ([("label", "utf8"), ("w", "int64")],
               {"label": ["bravo", "alpha", "zulu"], "w": [10, 20, 30]})},
        f"select v, w from l {how} join r on name = label order by v")
    assert list(got["v"]) == ([1, 3] if how == "inner" else [0, 1, 2, 3])


def test_three_key_left_join_with_duplicates():
    got = _both(
        {"l": ([(c, "int64") for c in "abcv"],
               {"a": [1, 1, 2, 3], "b": [1, 1, 2, 2], "c": [0, 0, 0, 0],
                "v": [0, 1, 2, 3]}),
         "r": ([(c, "int64") for c in "xyzw"],
               {"x": [1, 1, 2], "y": [1, 1, 2], "z": [0, 0, 0],
                "w": [5, 6, 7]})},
        "select v, w from l left join r on a = x and b = y and c = z "
        "order by v, w")
    assert list(got["v"]) == [0, 0, 1, 1, 2, 3]
    assert np.isnan(got["w"][-1])


def test_full_outer_join_with_duplicates():
    rng = np.random.default_rng(11)
    got = _both(
        {"l": ([("k", "int64"), ("v", "int64")],
               {"k": rng.integers(0, 6, 40), "v": np.arange(40)}),
         "r": ([("j", "int64"), ("w", "int64")],
               {"j": rng.integers(3, 10, 25), "w": np.arange(100, 125)})},
        "select v, w from l full outer join r on k = j order by v, w")
    assert np.isnan(got["v"]).any() and np.isnan(got["w"]).any()


def test_not_in_with_a_null(tmp_path):
    """One NULL in the subquery empties NOT IN; without it, NOT IN is an
    anti join."""
    path = tmp_path / "nv.tbl"
    path.write_text("1|x|\n|y|\n3|z|\n")  # the second key is NULL
    ref = ReferenceContext.standalone()
    port = BallistaContext.standalone(device="cpu")
    for ctx, pkg in ((ref, ref_pkg), (port, bt)):
        ctx.register_tbl("nullvals", str(path),
                         pkg.schema(("k", "int64"), ("s", "utf8")))
        ctx.register_memtable("cust", pkg.schema(("ckey", "int64")),
                              {"ckey": [1, 2, 3, 4]})
    for sql, want in (
            ("select ckey from cust where ckey not in "
             "(select k from nullvals) order by ckey", []),
            ("select ckey from cust where ckey not in "
             "(select k from nullvals where s <> 'y') order by ckey", [2, 4])):
        got = port.sql(sql).to_pydict()
        _assert_equals_reference(got, ref.sql(sql).collect())
        assert list(got["ckey"]) == want
