"""TPC-H at SF=0.2 (~1.2M lineitem rows) through the port's fused
standalone collect on the CPU, against the pandas oracles of
``benchmarks/tpch/oracle.py`` — the port's tier of
``tests/test_tpch_sf02.py`` (marker ``sf02``, part of the default gate).
At this size the aggregates overflow their first group capacity and
retry, filters compact their batches and the joins build past their
first windows, which SF0.002 never reaches. Float columns are held to
rtol 1e-6 (atol 1e-6), as the reference tier holds them (the oracle
computes in float64, the engine in float32); every other column exactly.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from benchmarks.tpch import datagen, oracle

from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.testing.tpch_schema import register_tpch

QUERIES = [f"q{i}" for i in range(1, 23)]
QDIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "tpch",
                    "queries")

pytestmark = pytest.mark.sf02


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The tier runs its files in parallel worker processes on one
    machine: this file's torch ops take two threads, not every core, so
    they do not starve the workers beside them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sf02(tmp_path_factory):
    # reuse the bench dataset when present (same generator + seed)
    prebuilt = os.path.join(os.path.dirname(__file__), "..", "bench_data",
                            "sf02")
    if os.path.exists(os.path.join(prebuilt, "lineitem")):
        data_dir = prebuilt
    else:
        data_dir = str(tmp_path_factory.mktemp("tpch_sf02_port"))
        datagen.generate(data_dir, scale=0.2, num_parts=2)
    ctx = BallistaContext.standalone(device="cpu")
    register_tpch(ctx, data_dir)
    return ctx, oracle.load_tables(data_dir)


def _normalize(df: pd.DataFrame) -> pd.DataFrame:
    out = df.copy()
    for c in out.columns:
        if out[c].dtype.kind == "M":
            out[c] = out[c].values.astype("datetime64[D]")
    return out.reset_index(drop=True)


@pytest.mark.parametrize("q", QUERIES)
def test_sf02_query_matches_oracle(sf02, q):
    ctx, tables = sf02
    sql = open(os.path.join(QDIR, f"{q}.sql")).read()
    got = _normalize(pd.DataFrame(ctx.sql(sql).to_pydict()))
    exp = _normalize(oracle.ORACLES[q](tables))
    assert list(got.columns) == list(exp.columns)
    assert len(got) == len(exp), f"{q}: {len(got)} rows vs {len(exp)}"
    for c in exp.columns:
        g, e = got[c], exp[c]
        if e.dtype.kind in "fc":
            np.testing.assert_allclose(g.astype(float), e.astype(float),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{q}.{c}")
        else:
            np.testing.assert_array_equal(g.to_numpy(), e.to_numpy(),
                                          err_msg=f"{q}.{c}")
