"""Scalar subqueries of server-planned queries on the port's cluster
(``distributed/scheduler.py::SchedulerService._resolve_subqueries``)
against the JAX package's, on the CPU at SF0.002 (two files a table):

- TPC-H q11, q15 and q22 (one uncorrelated scalar subquery each) with
  ``plan.server=on`` through ``LocalCluster(device="cpu")`` and
  ``BallistaContext.remote`` equal the JAX package's ``LocalCluster``
  with the same setting and the pandas oracle. At SF0.002 no supplier is
  German, so q11's subquery is NULL and its result empty; q11 over
  INDONESIA (the nation with the most suppliers there) is run as well,
  so the float literal and the rows it filters are held too;
- the literal each subquery becomes on the port's scheduler equals the
  one the JAX scheduler inlines (read as the literals the resolution
  adds to the plan);
- a job cancelled while its subquery runs on the scheduler stops there,
  stays cancelled and commits nothing to the table cache.

Tolerances: int, decimal, date and string columns and the literals
exactly; float columns within rtol 1e-6 (``assert_equals_reference``;
against the oracle with atol 1e-6 as ``tests/test_torch_tpch.py``).
"""

import numpy as np
import pytest

from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.distributed.executor import LocalCluster
from ballista_tpu_torch.testing.subqueries import SubqueryRecorder
from ballista_tpu_torch.testing.tpch_schema import register_tpch

from torch_warm_path import (assert_equals_reference, fresh_registries,
                             generate_tpch, pinned_threads,
                             reset_port_caches, sql)

QUERIES = ["q11", "q15", "q22", "q11_indonesia"]
SERVER = {"plan.server": "on"}


def _sql(q: str) -> str:
    if q == "q11_indonesia":
        return sql("q11").replace("'GERMANY'", "'INDONESIA'")
    return sql(q)


def _oracle(q: str, tables):
    from benchmarks.tpch import oracle

    if q != "q11_indonesia":
        return oracle.ORACLES[q](tables).reset_index(drop=True)
    j = tables["partsupp"].merge(
        tables["supplier"], left_on="ps_suppkey", right_on="s_suppkey"
    ).merge(tables["nation"], left_on="s_nationkey",
            right_on="n_nationkey")
    j = j[j.n_name == "INDONESIA"]
    j["value"] = j.ps_supplycost * j.ps_availqty
    total = j.value.sum() * 0.0001
    out = j.groupby("ps_partkey")["value"].sum().reset_index()
    out = out[out.value > total]
    return out.sort_values("value", ascending=False).reset_index(drop=True)


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    # one thread: this file runs a cluster's task threads
    with pinned_threads(1):
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("subquery_tpch")))


@pytest.fixture(scope="module")
def clusters():
    from ballista_tpu import execution as ref_execution
    from ballista_tpu import expr as ref_ex
    from ballista_tpu.distributed.executor import LocalCluster as RefCluster
    from ballista_tpu_torch import expr as port_ex
    from ballista_tpu_torch.distributed import scheduler as port_scheduler

    with SubqueryRecorder(port_scheduler, port_ex) as mine, \
            SubqueryRecorder(ref_execution, ref_ex) as theirs, \
            fresh_registries():
        port = LocalCluster(num_executors=2, concurrent_tasks=2,
                            device="cpu")
        ref = RefCluster(num_executors=2, concurrent_tasks=2)
        try:
            yield port, ref, {"port": mine.records, "ref": theirs.records}
        finally:
            port.shutdown()
            ref.shutdown()


@pytest.fixture(scope="module")
def runs(clusters, tpch_dir):
    """q -> (port result, JAX result, port literals, JAX literals)."""
    from ballista_tpu.client import BallistaContext as RefContext
    from benchmarks.tpch.schema_def import \
        register_tpch as register_reference

    port, ref, literals = clusters
    mine = BallistaContext.remote("localhost", port.port, device="cpu",
                                  **SERVER)
    register_tpch(mine, tpch_dir)
    theirs = RefContext.remote("localhost", ref.port, **SERVER)
    register_reference(theirs, tpch_dir, "tbl")
    cache = {}

    def get(q):
        if q not in cache:
            n_port, n_ref = len(literals["port"]), len(literals["ref"])
            got = mine.sql(_sql(q)).to_pydict()
            want = theirs.sql(_sql(q)).collect()
            cache[q] = (got, want,
                        [r["literals"] for r in literals["port"][n_port:]],
                        [r["literals"] for r in literals["ref"][n_ref:]])
        return cache[q]

    return get


def _assert_equals_oracle(got, exp):
    assert list(got) == list(exp.columns)
    for c in exp.columns:
        e = exp[c]
        if e.dtype.kind == "M":
            e = e.values.astype("datetime64[D]")
        g = got[c]
        if np.asarray(e).dtype.kind in "fc":
            np.testing.assert_allclose(np.asarray(g, dtype=float),
                                       np.asarray(e, dtype=float),
                                       rtol=1e-6, atol=1e-6, err_msg=c)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(e),
                                          err_msg=c)


@pytest.mark.parametrize("q", QUERIES)
def test_server_planned_subquery_equals_reference_and_oracle(
        runs, tpch_dir, q):
    from benchmarks.tpch import oracle

    got, want, _, _ = runs(q)
    assert_equals_reference(got, want)
    _assert_equals_oracle(got, _oracle(q, oracle.load_tables(tpch_dir)))
    if q == "q11_indonesia":
        assert len(got["ps_partkey"]) > 0


@pytest.mark.parametrize("q", QUERIES)
def test_subquery_literal_equals_the_reference_schedulers(runs, q):
    """The scheduler resolved exactly one subquery for the query, into
    the literal the JAX scheduler inlines."""
    _, _, mine, theirs = runs(q)
    assert len(mine) == 1 and len(theirs) == 1, (mine, theirs)
    assert len(mine[0]) == 1, mine
    (value, kind), = mine[0]
    (ref_value, ref_kind), = theirs[0]
    assert kind == ref_kind
    assert type(value) is type(ref_value)
    assert value == ref_value, (q, value, ref_value)


def test_cancelled_subquery_commits_nothing(clusters, tpch_dir,
                                            monkeypatch):
    """The job is cancelled as its subquery starts to run on the
    scheduler: the subquery stops at its first batch boundary, the job
    stays cancelled (not failed) and the table cache holds nothing."""
    from ballista_tpu_torch import execution
    from ballista_tpu_torch.cache import residency
    from ballista_tpu_torch.lifecycle import current_token

    port, _, _ = clusters
    real = execution.collect_physical
    cancelled = []

    def cancel_then_collect(phys):
        token = current_token()
        if token is not None and token.job_id and not cancelled:
            cancelled.append(token.job_id)
            port.state.cancel_job(token.job_id, "test")
        return real(phys)

    monkeypatch.setattr(execution, "collect_physical", cancel_then_collect)
    reset_port_caches()
    ctx = BallistaContext.remote("localhost", port.port, device="cpu",
                                 **SERVER)
    register_tpch(ctx, tpch_dir)
    with pytest.raises(Exception, match="cancel"):
        ctx.sql(sql("q22")).to_pydict()
    assert len(cancelled) == 1, cancelled
    assert port.state.get_job_status(cancelled[0]).state == "cancelled"
    stats = residency.process_table_cache().stats()
    assert stats["entries"] == 0 and stats["resident_bytes"] == 0, stats
