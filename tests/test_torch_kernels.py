"""Kernels and physical operators of the port against the JAX package on
identical inputs: the multi-key sort permutation, the batch utilities of
``physical/base.py`` (concat with dictionary unification, compaction,
padding, gathers), and the scan -> filter -> projection -> partial/final
aggregate -> sort operators over the same in-memory table."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ballista_tpu as ref
from ballista_tpu.columnar import ColumnBatch as RefBatch
from ballista_tpu.columnar import Dictionary as RefDictionary
from ballista_tpu.io.memory import MemTableSource as RefMemTable
from ballista_tpu.kernels.sort import sort_permutation as ref_sort
from ballista_tpu.physical import base as ref_base
from ballista_tpu.physical import operators as ref_ops
from ballista_tpu.physical.aggregate import HashAggregateExec as RefAgg

import ballista_tpu_torch as port
from ballista_tpu_torch.columnar import ColumnBatch, Dictionary
from ballista_tpu_torch.io.memory import MemTableSource
from ballista_tpu_torch.kernels.sort import sort_permutation
from ballista_tpu_torch.physical import base
from ballista_tpu_torch.physical import operators as ops
from ballista_tpu_torch.physical.aggregate import HashAggregateExec


SORT_CASES = {
    # (keys as (values, ascending), live)
    "multikey_asc_desc": ([(np.array([1, 0, 1, 0, 2]), True),
                           (np.array([5, 9, 3, 7, 1]), False)],
                          np.array([True, True, True, True, False])),
    "ties_are_stable": ([(np.array([2, 1, 2, 1, 2, 1, 0, 0]), True)],
                        np.array([True] * 6 + [False] * 2)),
    "int64_extremes_desc": ([(np.array([np.iinfo(np.int64).min, 0, -1,
                                        np.iinfo(np.int64).max, 5]), False)],
                            np.ones(5, bool)),
    "float_desc_and_bool": ([(np.array([0.5, -1.0, 0.5, 2.0, -1.0],
                                       np.float32), False),
                             (np.array([True, False, False, True, True]),
                              True)],
                            np.array([True, True, True, False, True])),
    "int32_three_keys_random": (
        [(np.random.default_rng(0).integers(0, 3, 200).astype(np.int32),
          True),
         (np.random.default_rng(1).integers(0, 4, 200).astype(np.int32),
          False),
         (np.random.default_rng(2).integers(-5, 5, 200), True)],
        np.random.default_rng(3).random(200) < 0.8),
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_sort_permutation_matches_reference(case):
    keys, live = SORT_CASES[case]
    want = np.asarray(ref_sort([(jnp.asarray(v), a) for v, a in keys],
                               jnp.asarray(live)))
    got = sort_permutation([(torch.from_numpy(v), a) for v, a in keys],
                           torch.from_numpy(live))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# batch utilities
# ---------------------------------------------------------------------------


def _pair(values, flags, live, validity=None, flag_dict=("x", "y"), cap=16):
    """The same physical batch in both packages."""
    arrays = {"v": np.asarray(values, np.int64),
              "f": np.asarray(flags, np.int32)}
    rs = ref.schema(("v", ref.Decimal(2)), ("f", ref.Utf8))
    ps = port.schema(("v", port.Decimal(2)), ("f", port.Utf8))
    va = None if validity is None else {"v": np.asarray(validity)}
    rb = RefBatch.from_numpy(rs, arrays, {"f": RefDictionary(flag_dict)}, cap,
                             va)
    pb = ColumnBatch.from_numpy(ps, arrays, {"f": Dictionary(flag_dict)}, cap,
                                va, device="cpu")
    sel = np.zeros(cap, bool)
    sel[: len(live)] = live
    rb = rb.with_selection(jnp.asarray(sel))
    pb = pb.with_selection(torch.from_numpy(sel))
    return rb, pb


def _same(pb, rb):
    assert pb.capacity == rb.capacity
    assert pb.num_rows_host() == rb.num_rows_host()
    got, want = pb.to_pydict(), rb.to_pydict()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_concat_batches_unifies_dictionaries_like_reference():
    r1, p1 = _pair([1, 2, 3], [0, 1, 1], [True, False, True],
                   flag_dict=("b", "d"), cap=8)
    r2, p2 = _pair([4, 5], [1, 0], [True, True], validity=[False, True],
                   flag_dict=("a", "b", "c"), cap=8)
    want = ref_base.concat_batches(r1.schema, [r1, r2])
    got = base.concat_batches(p1.schema, [p1, p2])
    assert list(got.column("f").dictionary.values) == ["a", "b", "c", "d"]
    _same(got, want)


@pytest.mark.parametrize("live_rows", [0, 1, 3, 10])
def test_maybe_compact_matches_reference(live_rows):
    n = 40
    rng = np.random.default_rng(live_rows)
    live = np.zeros(n, bool)
    live[rng.choice(n, live_rows, replace=False)] = True
    rb, pb = _pair(rng.integers(-99, 99, n), rng.integers(0, 2, n), live,
                   validity=rng.random(n) < 0.7, cap=64)
    want = ref_base.maybe_compact(rb, known_rows=live_rows)
    got = base.maybe_compact(pb)
    assert (got is pb) == (want is rb)
    _same(got, want)
    np.testing.assert_array_equal(got.selection.numpy(),
                                  np.asarray(want.selection))


def test_pad_and_take_batch_match_reference():
    rb, pb = _pair([7, 8, 9, 10], [0, 1, 0, 1], [True, True, False, True],
                   validity=[True, False, True, True], cap=8)
    _same(base.pad_batch(pb, 32), ref_base.pad_batch(rb, 32))
    perm = np.array([3, 1, 0, 2, 7, 6, 5, 4], np.int32)
    live = np.array([1, 1, 1, 0, 0, 0, 0, 0], bool)
    want = ref_base.take_batch(rb, jnp.asarray(perm), jnp.asarray(live))
    got = base.take_batch(pb, torch.from_numpy(perm), torch.from_numpy(live))
    _same(got, want)
    sel = np.array([0, 1, 1, 0, 1, 0, 0, 0], bool)
    np.testing.assert_array_equal(
        base.compact_perm(torch.from_numpy(sel), 4).numpy(),
        np.asarray(ref_base.compact_perm(jnp.asarray(sel), 4)))


# ---------------------------------------------------------------------------
# operators over the same in-memory table
# ---------------------------------------------------------------------------


def _tables():
    rng = np.random.default_rng(11)
    n = 3000
    data = {
        "flag": [("A", "N", "R")[i] for i in rng.integers(0, 3, n)],
        "status": [("F", "O")[i] for i in rng.integers(0, 2, n)],
        "qty": list(rng.integers(1, 5000, n) / 100.0),
        "price": list(rng.integers(-10 ** 7, 10 ** 7, n) / 100.0),
        "day": list(rng.integers(8000, 10000, n)),
    }
    rs = ref.schema(("flag", ref.Utf8), ("status", ref.Utf8),
                    ("qty", ref.Decimal(2)), ("price", ref.Decimal(2)),
                    ("day", ref.Date32))
    ps = port.schema(("flag", port.Utf8), ("status", port.Utf8),
                     ("qty", port.Decimal(2)), ("price", port.Decimal(2)),
                     ("day", port.Date32))
    return (RefMemTable.from_pydict(rs, data, num_partitions=3, capacity=1024),
            MemTableSource.from_pydict(ps, data, num_partitions=3,
                                       capacity=1024, device="cpu"))


def _plan(pkg, m, src, agg_cls, group: bool):
    col, lit = pkg.col, pkg.lit
    scan = m.ScanExec("t", src)
    filt = m.FilterExec((col("day") <= lit(9500)) & (col("qty") > lit(2.5)),
                        scan)
    proj = m.ProjectionExec([col("flag"), col("status"), col("qty"),
                             (col("price") * (lit(1) - col("qty")))
                             .alias("disc")], filt)
    groups = [col("flag"), col("status")] if group else []
    aggs = [pkg.sum_(col("qty")).alias("sq"),
            pkg.sum_(col("disc")).alias("sd"),
            pkg.avg(col("disc")).alias("ad"),
            pkg.min_(col("qty")).alias("mq"),
            pkg.count().alias("c")]
    partial = agg_cls("partial", groups, aggs, proj)
    final = agg_cls("final", groups, aggs, m.MergeExec(partial))
    if not group:
        return final
    return m.SortExec([pkg.expr.SortExpr(col("flag"), False),
                       pkg.expr.SortExpr(col("status"), True)], final)


@pytest.mark.parametrize("group", [True, False], ids=["grouped", "scalar"])
def test_operator_pipeline_matches_reference(group):
    rsrc, psrc = _tables()
    rplan = _plan(ref, ref_ops, rsrc, RefAgg, group)
    pplan = _plan(port, ops, psrc, HashAggregateExec, group)
    assert pplan.pretty() == rplan.pretty()
    want = [b.to_pydict() for b in rplan.execute(0)]
    got = [b.to_pydict() for b in pplan.execute(0)]
    assert len(got) == len(want) == 1
    assert list(got[0]) == list(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
