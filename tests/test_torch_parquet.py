"""The port's Parquet source (``ballista_tpu_torch/io/parquet.py``) against
the JAX package's (``ballista_tpu/io/parquet.py``).

- NULLs (the cases of ``tests/test_scan_nulls.py``): non-string columns
  carry validity, utf8 NULLs store "", an int64 above 2^53 survives a
  NULL beside it, and aggregation skips NULLs; each batch equals the JAX
  package's scan of the same file;
- TPC-H q1, q3 and q5 at SF0.002 over Parquet written by
  ``testing/parquet_convert.py`` equal the JAX package's
  ``register_parquet`` results over the JAX package's own converter's
  files, and the port's ``.tbl`` results; the two converters write equal
  tables;
- sources over the same files share one dictionary per column (the
  registry), and the table cache serves a repeated scan; a Parquet table
  registered through ``CREATE EXTERNAL TABLE ... STORED AS PARQUET``.

Tolerances: exact for int, decimal, date and dictionary columns; float
columns within rtol 1e-6 (``assert_equals_reference``); the port against
itself byte for byte (``assert_identical``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ballista_tpu.client import BallistaContext as ReferenceContext
from ballista_tpu.io import ParquetSource as RefParquetSource
from benchmarks.tpch.schema_def import register_tpch as register_reference

from ballista_tpu_torch import Date32, Decimal, Int64, Utf8, col, count, sum_
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.execution import collect
from ballista_tpu_torch.io import ParquetSource
from ballista_tpu_torch.logical import LogicalPlanBuilder
from ballista_tpu_torch.testing.parquet_convert import (convert_tpch,
                                                        register_tpch_parquet)

from torch_warm_path import (assert_equals_reference, assert_identical,
                             generate_tpch, pinned_threads, port_ctx,
                             reset_port_caches, sql)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    with pinned_threads():
        yield


def _write_parquet(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    from decimal import Decimal as DEC

    t = pa.table({
        "k": pa.array(["x", "y", None, "z"], pa.string()),
        "a": pa.array([1, None, 3, 4], pa.int64()),
        "d": pa.array([DEC("1.50"), DEC("2.25"), None, DEC("4.00")],
                      pa.decimal128(12, 2)),
        "dt": pa.array([8766, 8767, 8768, None], pa.int32()).cast(
            pa.date32()),
    })
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path)
    return path


def test_parquet_nulls_surface_validity(tmp_path):
    path = _write_parquet(tmp_path)
    b = list(ParquetSource(path, device="cpu").scan(0))
    assert len(b) == 1
    b = b[0]
    assert int(b.num_rows) == 4
    theirs = list(RefParquetSource(path).scan(0))[0]
    for name, valid in (("a", [True, False, True, True]),
                        ("d", [True, True, False, True]),
                        ("dt", [True, True, True, False])):
        c = b.column(name)
        np.testing.assert_array_equal(c.validity.numpy()[:4], valid)
        np.testing.assert_array_equal(
            c.values.numpy()[:4], np.asarray(theirs.column(name).values)[:4])
    assert b.column("k").validity is None  # utf8: "" is a value
    out = b.to_pydict()
    assert list(out["k"]) == ["x", "y", "", "z"]
    np.testing.assert_array_equal(out["d"][[0, 1, 3]], [1.50, 2.25, 4.00])
    assert np.isnan(out["d"][2])
    assert np.isnat(out["dt"][3])


def test_parquet_big_int64_survives_null_column(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    big = 9007199254740993  # 2^53 + 1
    path = str(tmp_path / "big.parquet")
    pq.write_table(pa.table({"a": pa.array([big, None], pa.int64())}), path)
    a = list(ParquetSource(path, device="cpu").scan(0))[0].column("a")
    assert int(a.values[0]) == big
    np.testing.assert_array_equal(a.validity.numpy()[:2], [True, False])


def test_parquet_null_aware_aggregation(tmp_path):
    src = ParquetSource(_write_parquet(tmp_path), device="cpu")
    plan = LogicalPlanBuilder.scan("t", src).aggregate(
        [], [sum_(col("a")).alias("s"), count(col("a")).alias("n"),
             count().alias("all")]).build()
    out = collect(plan)
    assert int(out["s"][0]) == 8  # 1+3+4
    assert int(out["n"][0]) == 3
    assert int(out["all"][0]) == 4


def test_parquet_source_needs_a_device(tmp_path):
    with pytest.raises(TypeError):
        ParquetSource(_write_parquet(tmp_path))


def test_sources_share_dictionaries_and_the_table_cache(tmp_path):
    path = _write_parquet(tmp_path)
    reset_port_caches()
    one = ParquetSource(path, device="cpu")
    two = ParquetSource(path, device="cpu")
    b1 = list(one.scan(0))[0]
    b2 = list(two.scan(0))[0]
    assert b1.column("k").dictionary is b2.column("k").dictionary
    assert two.scan_cache_outcome(0) == "hit"
    assert one.residency_key(0) != ParquetSource(
        path, device="meta").residency_key(0)


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("pq_tpch")))


@pytest.fixture(scope="module")
def port_parquet(tpch_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pq_port"))
    convert_tpch(tpch_dir, out)
    return out


@pytest.fixture(scope="module")
def reference_parquet(tpch_dir, tmp_path_factory):
    """The JAX package's converter (``benchmarks/tpch/main.py convert``)."""
    out = str(tmp_path_factory.mktemp("pq_ref"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.tpch.main", "convert", "--input",
         tpch_dir, "--output", out, "--format", "parquet",
         "--partitions", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return out


@pytest.mark.parametrize("table", ["lineitem", "orders", "nation"])
def test_converters_write_equal_tables(port_parquet, reference_parquet,
                                       table):
    import pyarrow.parquet as pq

    mine = pq.read_table(os.path.join(port_parquet, table, "part-0.parquet"))
    theirs = pq.read_table(os.path.join(reference_parquet, table,
                                        "part-0.parquet"))
    theirs = theirs.replace_schema_metadata(None)
    assert mine.schema == theirs.schema
    assert mine.equals(theirs)


@pytest.mark.parametrize("q", ["q1", "q3", "q5"])
def test_tpch_over_parquet_equals_reference_and_tbl(tpch_dir, port_parquet,
                                                    reference_parquet, q):
    ctx = BallistaContext.standalone(device="cpu")
    register_tpch_parquet(ctx, port_parquet)
    got = ctx.sql(sql(q)).to_pydict()
    ref = ReferenceContext.standalone()
    register_reference(ref, reference_parquet, "parquet")
    assert_equals_reference(got, ref.sql(sql(q)).collect())
    assert_identical(got, port_ctx(tpch_dir).sql(sql(q)).to_pydict(), q)


def test_create_external_table_stored_as_parquet(tmp_path):
    ctx = BallistaContext.standalone(device="cpu")
    path = _write_parquet(tmp_path)
    # (no DECIMAL(p,s) column: the DDL's type parser, the JAX package's
    # too, splits "DECIMAL(12,2)" wrongly)
    ctx.sql(f"CREATE EXTERNAL TABLE t (k VARCHAR, a BIGINT, dt DATE) "
            f"STORED AS PARQUET LOCATION '{path}'")
    out = ctx.sql("select count(a) as n, sum(a) as s from t").to_pydict()
    assert int(out["n"][0]) == 3
    assert int(out["s"][0]) == 8
    df = ctx.read_parquet(path)
    assert list(df.schema().names()) == ["k", "a", "d", "dt"]
    assert [f.dtype for f in df.schema().fields] == [
        Utf8, Int64, Decimal(2), Date32]
