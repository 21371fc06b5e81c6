"""EXPLAIN and EXPLAIN ANALYZE in the port (``physical/explain.py``,
``execution.plan_logical``, ``physical/planner.py``, ``serde.py``,
``DataFrame.explain_analyze``) against the JAX package, on the CPU at
TPC-H SF0.002 (the counterpart of ``tests/test_explain.py``):

- ``EXPLAIN`` and ``EXPLAIN VERBOSE`` of the 22 queries return the JAX
  package's rows, text for text (no line differs);
- ``EXPLAIN ANALYZE`` of the 22 queries: the same row kinds, and the
  same operators with the same ``output_rows`` in ``plan_with_metrics``.
  Times, compile counts and memory gauges are measurements and are not
  compared, nor is a scan's ``[cache: ...]`` mark, which tells how the
  process's table cache served it (a hit, a miss or a fill depends on
  what ran before and on which of two scans of one table filled first);
- the logical and physical serde of EXPLAIN and EXPLAIN ANALYZE plans
  are byte-identical to the JAX package's, and deserialize onto the
  device asked for;
- ``df.explain_analyze()`` returns the analyzed plan text;
- EXPLAIN through a port ``LocalCluster`` (``plan.server=on``, the
  scheduler plans it) equals the standalone rows, and EXPLAIN ANALYZE
  of q1 ships as one task whose operators and row counts equal the
  standalone ANALYZE's; a server-planned EXPLAIN of q11, whose scalar
  subquery the scheduler resolves, equals the standalone rows too.
"""

import re

import pytest

from ballista_tpu_torch import serde
from ballista_tpu_torch.distributed.executor import LocalCluster
from ballista_tpu_torch.execution import plan_logical
from ballista_tpu_torch.logical import Explain
from ballista_tpu_torch.physical.explain import (ExplainAnalyzeExec,
                                                 ExplainExec)
from ballista_tpu_torch.testing.tpch_schema import register_tpch

from torch_warm_path import generate_tpch, pinned_threads, port_ctx, sql

QUERIES = [f"q{i}" for i in range(1, 23)]


@pytest.fixture(scope="module", autouse=True)
def _pinned():
    # one thread: this file runs a cluster's task threads
    with pinned_threads(1):
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("tpch_explain")))


@pytest.fixture(scope="module")
def port(tpch_dir):
    return port_ctx(tpch_dir)


@pytest.fixture(scope="module")
def reference(tpch_dir):
    from ballista_tpu.client import BallistaContext as ReferenceContext
    from benchmarks.tpch.schema_def import register_tpch as register_ref

    ref = ReferenceContext.standalone()
    register_ref(ref, tpch_dir, "tbl")
    return ref


def _rows(out):
    return list(zip(list(out["plan_type"]), list(out["plan"])))


def _operators(text: str):
    """(operator line without its metrics and cache mark, output_rows)
    for every line of a ``plan_with_metrics`` text."""
    out = []
    for line in text.splitlines():
        head, _, metrics = line.partition(", metrics=[")
        head = re.sub(r" \[cache: [a-z|]+\]", "", head)
        rows = re.search(r"output_rows=(\d+)", metrics)
        out.append((head, int(rows.group(1)) if rows else None))
    return out


@pytest.mark.parametrize("verbose", [False, True],
                         ids=["explain", "verbose"])
@pytest.mark.parametrize("q", QUERIES)
def test_explain_rows_equal_reference(port, reference, q, verbose):
    text = ("EXPLAIN VERBOSE " if verbose else "EXPLAIN ") + sql(q)
    got = _rows(port.sql(text).to_pydict())
    want = _rows(reference.sql(text).collect())
    kinds = ["logical_plan", "physical_plan"]
    if verbose:
        kinds = ["initial_logical_plan"] + kinds
    assert [k for k, _ in got] == kinds
    assert got == want


@pytest.mark.parametrize("q", QUERIES)
def test_explain_analyze_operators_equal_reference(port, reference, q):
    text = "EXPLAIN ANALYZE " + sql(q)
    got = dict(_rows(port.sql(text).to_pydict()))
    want = dict(_rows(reference.sql(text).collect()))
    assert list(got) == list(want) == ["plan_with_metrics",
                                       "total_elapsed", "memory"]
    mine, theirs = (_operators(got["plan_with_metrics"]),
                    _operators(want["plan_with_metrics"]))
    assert mine == theirs
    assert mine[0][1] is not None  # the root reported its rows
    assert re.fullmatch(r"\d+\.\d{6}s", got["total_elapsed"])
    assert got["memory"].startswith("peak_host_bytes=")


@pytest.mark.parametrize("analyze", [False, True],
                         ids=["explain", "analyze"])
@pytest.mark.parametrize("q", ["q1", "q5", "q13"])
def test_explain_serde_bytes_equal_reference(port, reference, q, analyze):
    from ballista_tpu import serde as ref_serde
    from ballista_tpu.execution import plan_logical as reference_plan

    text = ("EXPLAIN ANALYZE VERBOSE " if analyze else "EXPLAIN VERBOSE ")
    text += sql(q)
    plan = port.sql(text).plan
    ref_plan = reference.sql(text).plan
    assert isinstance(plan, Explain) and plan.verbose
    wire = serde.plan_to_proto(plan).SerializeToString()
    assert wire == ref_serde.plan_to_proto(ref_plan).SerializeToString()
    back = serde.plan_from_proto(serde.plan_to_proto(plan), device="cpu")
    assert isinstance(back, Explain) and back.analyze == analyze
    assert serde.plan_to_proto(back).SerializeToString() == wire
    phys = plan_logical(plan, port._planner_options())
    node = serde.physical_to_proto(phys)
    assert node.SerializeToString() == ref_serde.physical_to_proto(
        reference_plan(ref_plan)).SerializeToString()
    rt = serde.physical_from_proto(node, device="cpu")
    assert isinstance(rt, ExplainAnalyzeExec if analyze else ExplainExec)
    assert rt.device.type == "cpu"
    assert serde.physical_to_proto(rt).SerializeToString() == \
        node.SerializeToString()


def test_df_explain_analyze_returns_the_analyzed_plan(port):
    text = port.sql(sql("q1")).explain_analyze()
    ops = _operators(text)
    assert ops[0][0].startswith("SortExec")
    assert ops[0][1] == 4  # q1's four (returnflag, linestatus) groups
    assert any(h.lstrip().startswith("ScanExec: lineitem")
               for h, _ in ops)


@pytest.fixture(scope="module")
def cluster():
    c = LocalCluster(num_executors=2, concurrent_tasks=2, device="cpu")
    yield c
    c.shutdown()


def test_explain_through_the_cluster(cluster, port, tpch_dir):
    from ballista_tpu_torch.client import BallistaContext

    ctx = BallistaContext.remote("localhost", cluster.port, device="cpu",
                                 **{"plan.server": "on"})
    register_tpch(ctx, tpch_dir)
    text = "EXPLAIN " + sql("q5")
    got = _rows(ctx.sql(text).collect())
    assert got == _rows(port.sql(text).to_pydict())
    # an EXPLAIN ANALYZE is a leaf: the whole analyzed q1 is one task
    analyzed = dict(_rows(ctx.sql("EXPLAIN ANALYZE " + sql("q1"))
                          .collect()))
    stages = ctx.last_query_metrics().stages
    assert len(stages) == 1
    assert [st["num_tasks"] for st in stages.values()] == [1]
    standalone = dict(_rows(port.sql("EXPLAIN ANALYZE " + sql("q1"))
                            .to_pydict()))
    assert _operators(analyzed["plan_with_metrics"]) == \
        _operators(standalone["plan_with_metrics"])
    # the scheduler resolves q11's scalar subquery on its device before
    # rendering, as the standalone EXPLAIN does
    text = "EXPLAIN " + sql("q11")
    assert _rows(ctx.sql(text).collect()) == \
        _rows(port.sql(text).to_pydict())
