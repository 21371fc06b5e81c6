"""Columnar substrate and expression evaluation of the port against the
JAX package: the same host arrays go into both ``from_numpy`` and come
back out of ``to_pydict`` identically (NULLs, dictionaries, decimals,
fixed-size lists), and the same batch evaluates every expression to the
same values and validity."""

import datetime as dt

import numpy as np
import jax.numpy as jnp
import pytest

import ballista_tpu as ref
from ballista_tpu.columnar import ColumnBatch as RefBatch
from ballista_tpu.columnar import Dictionary as RefDictionary
from ballista_tpu.kernels.expr_eval import Evaluator as RefEvaluator

import ballista_tpu_torch as port
from ballista_tpu_torch.columnar import ColumnBatch, Dictionary, empty_batch
from ballista_tpu_torch.interop import batch_from_numpy
from ballista_tpu_torch.kernels.expr_eval import Evaluator

EPOCH = dt.date(1970, 1, 1)


def _days(*isos):
    return [(dt.date.fromisoformat(x) - EPOCH).days for x in isos]


def _schemas(pkg, fields):
    return pkg.schema(*[(n, getattr(pkg, t) if isinstance(t, str) else t(pkg))
                        for n, t in fields])


# (fields, arrays, utf8 dictionaries, validity, capacity); types by name so
# each package builds its own DataType
CASES = {
    "basic": (
        [("a", "Int64"), ("b", lambda p: p.Decimal(2)), ("flag", "Utf8"),
         ("d", "Date32")],
        {"a": np.array([1, 2, 3, 4, 5], np.int64),
         "b": np.array([125, 250, 375, 500, 625], np.int64),
         "flag": np.array([0, 1, 0, 2, 1], np.int32),
         "d": np.array(_days("1994-01-01", "1994-06-01", "1995-01-01",
                             "1995-06-01", "1996-01-01"), np.int32)},
        {"flag": ["A", "B", "C"]}, None, 8),
    "nulls": (
        [("i", "Int32"), ("x", "Int64"), ("s", "Utf8"), ("d", "Date32"),
         ("f", "Float64")],
        {"i": np.array([7, -1, 3, 0], np.int32),
         "x": np.array([1 << 60, 5, -(1 << 61), 9], np.int64),
         "s": np.array([1, 0, 1, 1], np.int32),
         "d": np.array(_days("2000-02-29", "1970-01-01", "1969-12-31",
                             "1992-01-01"), np.int32),
         "f": np.array([1.5, -2.25, 3.0, 0.1], np.float32)},
        {"s": ["", "zz"]},
        {"i": np.array([True, False, True, True]),
         "x": np.array([True, True, False, True]),
         "s": np.array([False, True, True, True]),
         "d": np.array([True, False, True, True]),
         "f": np.array([True, True, True, False])}, None),
    "decimals": (
        [("m", lambda p: p.Decimal(2)), ("r", lambda p: p.Decimal(6)),
         ("z", lambda p: p.Decimal(0))],
        {"m": np.array([-101, 0, 99999999999, -5], np.int64),
         "r": np.array([1, -1, 123456789, (1 << 62)], np.int64),
         "z": np.array([0, -7, 7, 1 << 40], np.int64)},
        {}, {"m": np.array([True, True, True, False])}, 16),
    "booleans": (
        [("t", "Boolean"), ("k", "Int32")],
        {"t": np.array([True, False, True]), "k": np.array([1, 2, 3], np.int32)},
        {}, None, 8),
    "fixed_size_list": (
        [("v", lambda p: p.datatypes.FixedSizeList(p.Int64, 3))],
        {"v": np.arange(12, dtype=np.int64).reshape(4, 3)},
        {}, {"v": np.array([True, False, True, True])}, 8),
}


def _both(case):
    fields, arrays, dicts, validity, cap = CASES[case]
    rs, ps = _schemas(ref, fields), _schemas(port, fields)
    rb = RefBatch.from_numpy(
        rs, arrays, {k: RefDictionary(v) for k, v in dicts.items()}, cap,
        validity)
    pb = ColumnBatch.from_numpy(
        ps, arrays, {k: Dictionary(v) for k, v in dicts.items()}, cap,
        validity, device="cpu")
    return rb, pb


def _assert_pydict_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype, k
        if w.dtype == object and len(w) and isinstance(w[0], np.ndarray):
            for gi, wi in zip(g, w):
                np.testing.assert_array_equal(gi, wi, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_numpy_to_pydict_matches_reference(case):
    rb, pb = _both(case)
    assert pb.capacity == rb.capacity
    assert pb.num_rows_host() == rb.num_rows_host()
    _assert_pydict_equal(pb.to_pydict(), rb.to_pydict())


@pytest.mark.parametrize("case", sorted(CASES))
def test_interop_rebuilds_reference_batch(case):
    rb, _ = _both(case)
    cols = [np.asarray(c.values) for c in rb.columns]
    vals = [None if c.validity is None else np.asarray(c.validity)
            for c in rb.columns]
    dicts = {f.name: list(c.dictionary.values)
             for f, c in zip(rb.schema.fields, rb.columns)
             if c.dictionary is not None}
    fields = CASES[case][0]
    pb = batch_from_numpy(_schemas(port, fields), cols, vals,
                          np.asarray(rb.selection), dicts, "cpu")
    assert pb.num_rows_host() == rb.num_rows_host()
    _assert_pydict_equal(pb.to_pydict(), rb.to_pydict())


def test_from_pydict_and_empty_batch_match_reference():
    data = {"a": [3, 1, 2], "b": [1.25, -2.5, 0.005], "s": ["x", "y", "x"]}
    fields = [("a", "Int64"), ("b", lambda p: p.Decimal(2)), ("s", "Utf8")]
    rb = RefBatch.from_pydict(_schemas(ref, fields), data)
    pb = ColumnBatch.from_pydict(_schemas(port, fields), data, device="cpu")
    assert pb.capacity == rb.capacity == 1024  # the bucket ladder's floor
    _assert_pydict_equal(pb.to_pydict(), rb.to_pydict())
    from ballista_tpu.columnar import empty_batch as ref_empty

    pe, re_ = empty_batch(_schemas(port, fields), "cpu"), ref_empty(
        _schemas(ref, fields))
    assert pe.capacity == re_.capacity and pe.num_rows_host() == 0
    _assert_pydict_equal(pe.to_pydict(), re_.to_pydict())


def test_batch_lives_on_the_requested_device():
    _, pb = _both("basic")
    assert pb.device.type == "cpu"
    assert all(c.values.device.type == "cpu" for c in pb.columns)
    assert pb.num_rows.device.type == "cpu"


# ---------------------------------------------------------------------------
# expression evaluation on identical batches
# ---------------------------------------------------------------------------


def _exprs(p):
    col, lit, date_lit = p.col, p.lit, p.date_lit
    e = p.expr
    fn = e.ScalarFunction
    return {
        "decimal_mul": col("b") * col("b"),
        "decimal_sub_literal": (lit(1) - col("b")) * col("b"),
        "decimal_div_float": col("b") / col("a"),
        "int_div_truncates": (lit(0) - col("a")) / lit(2),
        "int_mod_floors": (lit(0) - col("a")) % lit(3),
        "date_lt_and_decimal_ge": (col("d") < date_lit("1995-01-01"))
        & (col("b") >= lit(2.0)),
        "decimal_vs_fraction": col("b") > lit(3.7),
        "decimal_between": (col("b") >= lit(2.49)) & (col("b") <= lit(5.0)),
        "date_minus_interval": col("d") <= date_lit("1995-06-01") - lit(30),
        "utf8_eq": col("flag") == lit("A"),
        "utf8_ge": col("flag") >= lit("B"),
        "utf8_in": e.InList(col("flag"), [lit("A"), lit("C")]),
        "utf8_like": e.Like(col("flag"), "%A%"),
        "utf8_not_like": e.Like(col("flag"), "B%", negated=True),
        "extract_year": fn("extract_year", [col("d")]),
        "extract_month": fn("extract_month", [col("d")]),
        "extract_day": fn("extract_day", [col("d")]),
        "date_trunc_quarter": fn("date_trunc", [lit("quarter"), col("d")]),
        "date_trunc_week": fn("date_trunc", [lit("week"), col("d")]),
        "upper": fn("upper", [col("flag")]),
        "substr": fn("substr", [col("flag"), lit(1), lit(1)]),
        "length": fn("length", [col("flag")]),
        "case": p.case().when(col("a") > lit(2), col("b")).otherwise(lit(0.5)),
        "case_no_else": p.case().when(col("flag") == lit("B"), col("a")).end(),
        "cast_decimal_to_int": e.Cast(col("b"), p.Int64),
        "cast_int_to_decimal": e.Cast(col("a"), p.Decimal(3)),
        "cast_decimal_to_float": e.Cast(col("b"), p.Float64),
        "float_sqrt": fn("sqrt", [col("b")]),
        "abs": fn("abs", [lit(0) - col("a")]),
        "coalesce": fn("coalesce", [col("a"), lit(0)]),
        "nullif": fn("nullif", [col("a"), lit(3)]),
        "is_not_null": e.IsNotNull(col("a")),
        "not": e.Not(col("a") > lit(2)),
    }


EXPR_NAMES = sorted(_exprs(ref))


@pytest.mark.parametrize("name", EXPR_NAMES)
def test_evaluator_matches_reference(name):
    rb, pb = _both("basic")
    r = RefEvaluator(rb.schema).evaluate(_exprs(ref)[name], rb)
    g = Evaluator(pb.schema).evaluate(_exprs(port)[name], pb)
    assert (g.dtype.kind, g.dtype.scale) == (r.dtype.kind, r.dtype.scale)
    want = np.broadcast_to(np.asarray(r.values), (rb.capacity,))
    got = np.broadcast_to(g.values.numpy(), (pb.capacity,))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (g.validity is None) == (r.validity is None)
    if r.validity is not None:
        np.testing.assert_array_equal(
            np.broadcast_to(g.validity.numpy(), (pb.capacity,)),
            np.broadcast_to(np.asarray(r.validity), (rb.capacity,)))
    if r.dictionary is not None:
        assert list(g.dictionary.values) == list(r.dictionary.values)


@pytest.mark.parametrize("name", ["extract_year", "extract_month",
                                  "extract_day", "date_trunc_quarter",
                                  "date_trunc_week"])
def test_date_kernels_floor_before_epoch(name):
    """Dates before 1970 divide negative day counts: the port must floor
    like the JAX package (truncation would be off by one)."""
    fields = [("a", "Int64"), ("b", lambda p: p.Decimal(2)), ("flag", "Utf8"),
              ("d", "Date32")]
    arrays = dict(CASES["basic"][1])
    arrays["d"] = np.array(_days("1969-12-31", "1900-03-01", "1600-02-29",
                                 "1969-01-01", "0001-01-01"), np.int32)
    dicts = CASES["basic"][2]
    rb = RefBatch.from_numpy(_schemas(ref, fields), arrays,
                             {k: RefDictionary(v) for k, v in dicts.items()}, 8)
    pb = ColumnBatch.from_numpy(_schemas(port, fields), arrays,
                                {k: Dictionary(v) for k, v in dicts.items()},
                                8, device="cpu")
    r = RefEvaluator(rb.schema).evaluate(_exprs(ref)[name], rb)
    g = Evaluator(pb.schema).evaluate(_exprs(port)[name], pb)
    np.testing.assert_array_equal(g.values.numpy(), np.asarray(r.values))
