"""The port's SQL front end (copied lexer/parser/planner/optimizer) plans
every TPC-H query exactly as the JAX package does: the optimized logical
plans render identically."""

import os

import pytest

from benchmarks.tpch import datagen
from benchmarks.tpch.schema_def import register_tpch as register_reference
from ballista_tpu.client import BallistaContext as ReferenceContext
from ballista_tpu.optimizer import optimize as reference_optimize

from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.optimizer import optimize
from ballista_tpu_torch.testing.tpch_schema import TPCH_PKS, TPCH_SCHEMAS, register_tpch

from torch_warm_path import pinned_threads


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """Two torch, ingest and scanner threads for this file's queries
    (``torch_warm_path.pinned_threads``)."""
    with pinned_threads():
        yield


QDIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "tpch",
                    "queries")
QUERIES = [f"q{i}" for i in range(1, 23)]


@pytest.fixture(scope="module")
def contexts(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_frontend"))
    datagen.generate(d, scale=0.002, num_parts=2)
    ref = ReferenceContext.standalone()
    register_reference(ref, d, "tbl")
    port = BallistaContext.standalone(device="cpu")
    register_tpch(port, d)
    return ref, port


@pytest.mark.parametrize("qname", QUERIES)
def test_optimized_plan_matches_reference(contexts, qname):
    ref, port = contexts
    sql = open(os.path.join(QDIR, f"{qname}.sql")).read()
    want = reference_optimize(ref.sql(sql).plan).pretty()
    got = optimize(port.sql(sql).plan).pretty()
    assert got == want


def test_schema_mapping_matches_reference():
    from benchmarks.tpch.schema_def import TPCH_PKS as REF_PKS
    from benchmarks.tpch.schema_def import TPCH_SCHEMAS as REF_SCHEMAS

    assert TPCH_PKS == REF_PKS
    assert set(TPCH_SCHEMAS) == set(REF_SCHEMAS)
    for name, sch in TPCH_SCHEMAS.items():
        ref = REF_SCHEMAS[name]
        assert [(f.name, f.dtype.kind, f.dtype.scale, f.nullable)
                for f in sch.fields] == [
            (f.name, f.dtype.kind, f.dtype.scale, f.nullable)
            for f in ref.fields]
