"""Sort-based and ranged grouping of the port against the JAX package.

``grouped_aggregate`` and ``dense_grouped_scatter`` run on the same seeded
numpy arrays as their JAX counterparts: group order, representatives,
counts and validities must be equal exactly, integer results exactly,
float32 sums within rtol 1e-6 (the order of the adds may differ). Then
the operator: ``HashAggregateExec``'s overflow retry from a small group
capacity, and its mixed/ranged path against its sort path on one input,
each against the JAX operator on the same table."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ballista_tpu as ref_pkg
from ballista_tpu.io.memory import MemTableSource as RefMemTable
from ballista_tpu.kernels import aggregate as ref_agg
from ballista_tpu.physical.aggregate import HashAggregateExec as RefAgg
from ballista_tpu.physical.operators import ScanExec as RefScan

import ballista_tpu_torch as bt
from ballista_tpu_torch.io.memory import MemTableSource
from ballista_tpu_torch.kernels import aggregate as agg
from ballista_tpu_torch.physical import aggregate as phys_agg
from ballista_tpu_torch.physical.aggregate import HashAggregateExec
from ballista_tpu_torch.physical.operators import ScanExec


def _inputs(mod, array, specs):
    return [mod.AggInput(op, None if v is None else array(v),
                         None if m is None else array(m))
            for op, v, m in specs]


def _specs(rng, n):
    """sum, masked sum, f32 sum, count, masked count, min/max with and
    without validity."""
    mask = rng.random(n) < 0.6
    ints = rng.integers(-(1 << 40), 1 << 40, n)
    return [("sum", ints, None), ("sum", ints, mask),
            ("sum", rng.random(n).astype(np.float32) * 100, None),
            ("count", None, None), ("count", None, mask),
            ("min", ints, mask), ("max", ints, None),
            ("min", rng.integers(-9, 9, n).astype(np.int32), None),
            ("max", rng.random(n).astype(np.float32), mask)]


def _compare(got, want):
    gv = np.asarray(want.group_valid)
    np.testing.assert_array_equal(got.group_valid.numpy(), gv)
    assert int(got.num_groups) == int(want.num_groups)
    np.testing.assert_array_equal(got.rep_indices.numpy(),
                                  np.asarray(want.rep_indices))
    for i, (r, rv, a, av) in enumerate(zip(want.aggregates, want.agg_valid,
                                           got.aggregates, got.agg_valid)):
        r, a = np.asarray(r), a.numpy()
        np.testing.assert_array_equal(av.numpy(), np.asarray(rv), err_msg=i)
        assert a.dtype == r.dtype, i
        if r.dtype.kind == "f":
            np.testing.assert_allclose(a, r, rtol=1e-6, err_msg=i)
        else:
            np.testing.assert_array_equal(a, r, err_msg=i)


SORT_CASES = ["one_key_presorted", "one_key_unsorted", "three_keys",
              "nullable_keys", "overflow", "all_dead"]


def _sort_case(name):
    """([keys], [key validities or None], live, group_capacity)."""
    rng = np.random.default_rng(SORT_CASES.index(name) + 20)
    n = 1000 + 37
    live = rng.random(n) < 0.85
    if name == "one_key_presorted":
        k = np.sort(rng.integers(-500, 500, n))
        live = np.arange(n) < 900  # a contiguous live prefix
        return [k], [None], live, 2048
    if name == "one_key_unsorted":
        return [rng.integers(-(1 << 40), 1 << 40, n) // (1 << 33)], [None], \
            live, 1024
    if name == "three_keys":
        return [rng.integers(0, 5, n), rng.integers(0, 3, n).astype(np.int32),
                rng.integers(-2, 2, n)], [None] * 3, live, 256
    if name == "nullable_keys":
        return [rng.integers(0, 6, n), rng.integers(0, 4, n)], \
            [rng.random(n) < 0.7, None], live, 64
    if name == "overflow":  # more groups than capacity: true count returned
        return [rng.integers(0, 400, n)], [None], live, 32
    return [rng.integers(0, 9, n)], [None], np.zeros(n, bool), 16


@pytest.mark.parametrize("name", SORT_CASES)
def test_grouped_aggregate_matches_reference(name):
    keys, kvs, live, cap = _sort_case(name)
    specs = _specs(np.random.default_rng(len(name)), len(live))
    want = ref_agg.grouped_aggregate(
        [jnp.asarray(k) for k in keys], jnp.asarray(live),
        _inputs(ref_agg, jnp.asarray, specs), cap,
        [None if v is None else jnp.asarray(v) for v in kvs])
    got = agg.grouped_aggregate(
        [torch.from_numpy(k) for k in keys], torch.from_numpy(live),
        _inputs(agg, torch.from_numpy, specs), cap,
        [None if v is None else torch.from_numpy(v) for v in kvs])
    _compare(got, want)
    if name == "overflow":
        assert int(got.num_groups) > cap


def test_presorted_fast_path_skips_the_sort(monkeypatch):
    keys, _, live, cap = _sort_case("one_key_presorted")
    monkeypatch.setattr(agg, "_lexsort", None)  # any sort would fail
    got = agg.grouped_aggregate([torch.from_numpy(keys[0])],
                                torch.from_numpy(live), [], cap)
    assert int(got.num_groups) == len(np.unique(keys[0][live]))


@pytest.mark.parametrize("g", [7, 300])
def test_dense_grouped_scatter_matches_reference(g):
    rng = np.random.default_rng(g)
    n = 1500 + 3
    gids = rng.integers(0, g, n).astype(np.int32)
    gids[gids == 2] = 3  # group 2 stays empty
    live = rng.random(n) < 0.8
    specs = _specs(rng, n)
    want = ref_agg.dense_grouped_scatter(
        jnp.asarray(gids), jnp.asarray(live),
        _inputs(ref_agg, jnp.asarray, specs), g)
    got = agg.dense_grouped_scatter(
        torch.from_numpy(gids), torch.from_numpy(live),
        _inputs(agg, torch.from_numpy, specs), g)
    assert not bool(got.group_valid[2])
    _compare(got, want)


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------


def _tables(keys, vals, num_partitions=1):
    data = {"k": keys, "v": vals}
    ref_src = RefMemTable.from_pydict(
        ref_pkg.schema(("k", "int64"), ("v", "decimal(10,2)")), data,
        num_partitions)
    src = MemTableSource.from_pydict(
        bt.schema(("k", "int64"), ("v", "decimal(10,2)")), data,
        num_partitions, device="cpu")
    return RefScan("t", ref_src), ScanExec("t", src)


def _partial(mod_agg, pkg, scan, cap):
    return mod_agg("partial", [pkg.col("k")],
                   [pkg.sum_(pkg.col("v")).alias("s"),
                    pkg.count(pkg.col("v")).alias("c"),
                    pkg.max_(pkg.col("v")).alias("m")], scan,
                   group_capacity=cap)


def _run(op):
    """Every partition's batches of either package's operator, on host."""
    out = {}
    for p in range(op.output_partitioning().num_partitions):
        for b in op.execute(p):
            for k, v in b.to_pydict().items():
                out.setdefault(k, []).append(np.asarray(v))
    return {k: np.concatenate(v) for k, v in out.items()}


def _assert_same(got, want):
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


def test_overflow_retry_learns_the_capacity():
    """Sparse keys take the sort path; 300 groups overflow a capacity of
    8, the pass re-runs at 512 and the operator keeps that capacity."""
    rng = np.random.default_rng(5)
    keys = (rng.integers(0, 300, 2000) * 10_000_000_007).tolist()
    vals = np.round(rng.random(2000) * 100, 2).tolist()
    ref_scan, scan = _tables(keys, vals)
    ref_op = _partial(RefAgg, ref_pkg, ref_scan, 8)
    op = _partial(HashAggregateExec, bt, scan, 8)
    _assert_same(_run(op), _run(ref_op))
    assert op.group_capacity == ref_op.group_capacity == 512
    assert op._ranged_rejected and ref_op._ranged_rejected


@pytest.mark.parametrize("num_partitions", [1, 3])
def test_ranged_path_equals_sort_path(monkeypatch, num_partitions):
    """A narrow integer key takes the mixed/ranged scatter (no sort); the
    same operator forced onto the sort path gives the same batch, and
    both equal the JAX operator."""
    rng = np.random.default_rng(num_partitions)
    keys = rng.integers(-40, 60, 3000).tolist()
    vals = np.round(rng.random(3000) * 50 - 10, 2).tolist()
    ref_scan, scan = _tables(keys, vals, num_partitions)
    calls = []
    real = phys_agg.dense_grouped_scatter

    def spy(*a):
        calls.append(a[-1])
        return real(*a)

    monkeypatch.setattr(phys_agg, "dense_grouped_scatter", spy)
    ranged = _run(_partial(HashAggregateExec, bt, scan, 4096))
    assert calls and all(g == 128 for g in calls)  # span 101 + NULL -> 128
    forced = _partial(HashAggregateExec, bt, scan, 4096)
    forced._ranged_rejected = True
    calls.clear()
    sorted_ = _run(forced)
    assert not calls
    _assert_same(ranged, sorted_)
    _assert_same(ranged, _run(_partial(RefAgg, ref_pkg, ref_scan, 4096)))
