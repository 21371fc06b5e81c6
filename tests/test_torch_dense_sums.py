"""The dense grouped sums of the port against the JAX package.

``dense_grouped_sums`` on CPU tensors is the plain torch version; it must
equal the Pallas kernel ``ballista_tpu.kernels.pallas_agg`` run in
interpret mode BIT FOR BIT (int64 sums wrap mod 2^64 in both). The
aggregate layer above it (``dense_grouped_aggregate``, ``avg_fixed``,
``scalar_aggregate``) is held against the JAX package on the same arrays.
The CUDA kernel itself runs only on a card: its test skips here."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ballista_tpu.kernels import aggregate as ref_agg
from ballista_tpu.kernels.pallas_agg import dense_grouped_sums as ref_sums

from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.kernels import aggregate as agg
from ballista_tpu_torch.kernels import dense_sums as ds

I64 = np.iinfo(np.int64)


def _case(name):
    """(gids, live, [values], G) as numpy arrays."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "signed_2_45":  # tests/test_pallas_agg.py's first case
        n, g = 4096 + 77, 6
        return (rng.integers(0, g, n).astype(np.int32), rng.random(n) < 0.7,
                [rng.integers(-(1 << 45), 1 << 45, n),
                 rng.integers(0, 10 ** 7, n)], g)
    if name == "signed_2_49_g256_masked":  # masked values pre-zeroed
        n, g = 2048 + 33, 256
        v1 = rng.integers(-(1 << 49), 1 << 49, n)
        valid = rng.random(n) < 0.6
        return (rng.integers(0, g, n).astype(np.int32), rng.random(n) < 0.8,
                [np.where(valid, v1, 0), rng.integers(0, 10 ** 9, n),
                 valid.astype(np.int64)], g)
    if name == "empty_groups":
        return (np.array([0, 0, 2], np.int32), np.array([True, False, True]),
                [np.array([5, 7, 11], np.int64)], 4)
    if name == "all_dead":
        n = 1500
        return (rng.integers(0, 3, n).astype(np.int32), np.zeros(n, bool),
                [rng.integers(-100, 100, n)], 3)
    if name == "wrapping_2_62":  # sums leave int64 and wrap
        n, g = 3000 + 5, 5
        return (rng.integers(0, g, n).astype(np.int32), rng.random(n) < 0.9,
                [rng.integers(1 << 61, 1 << 62, n),
                 rng.integers(-(1 << 62), -(1 << 61), n),
                 rng.integers(-(1 << 62), 1 << 62, n)], g)
    if name == "full_range":
        n, g = 1024 * 2 + 1, 7
        return (rng.integers(0, g, n).astype(np.int32), rng.random(n) < 0.5,
                [rng.integers(I64.min, I64.max, n, endpoint=True)], g)
    if name == "no_values":  # counts only
        return (np.array([1, 1, 0, 2], np.int32), np.ones(4, bool), [], 3)
    raise KeyError(name)


CASES = ["signed_2_45", "signed_2_49_g256_masked", "empty_groups", "all_dead",
         "wrapping_2_62", "full_range", "no_values"]


@pytest.mark.parametrize("case", CASES)
def test_plain_sums_equal_pallas_interpret(case):
    gids, live, values, g = _case(case)
    want_s, want_c = ref_sums(jnp.asarray(gids), jnp.asarray(live),
                              [jnp.asarray(v) for v in values], g,
                              interpret=True)
    got_s, got_c = ds.dense_grouped_sums(
        torch.from_numpy(gids), torch.from_numpy(live),
        [torch.from_numpy(v) for v in values], g)
    assert len(got_s) == len(want_s)
    for got, want in zip(got_s, want_s):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_plain_sums_match_python_integers_mod_2_64():
    gids, live, values, g = _case("wrapping_2_62")
    got_s, got_c = ds.dense_grouped_sums(
        torch.from_numpy(gids), torch.from_numpy(live),
        [torch.from_numpy(v) for v in values], g)
    for j, v in enumerate(values):
        for grp in range(g):
            m = live & (gids == grp)
            exact = sum(int(x) for x in v[m]) % (1 << 64)
            assert int(got_s[j][grp]) % (1 << 64) == exact
            assert int(got_c[grp]) == int(m.sum())


def test_out_of_range_group_ids_are_dropped():
    gids = np.array([0, -1, 3, 2, 7, 1], np.int32)
    live = np.ones(6, bool)
    vals = [np.array([1, 10, 100, 1000, 10000, 100000], np.int64)]
    want_s, want_c = ref_sums(jnp.asarray(gids), jnp.asarray(live),
                              [jnp.asarray(vals[0])], 3, interpret=True)
    got_s, got_c = ds.dense_grouped_sums(torch.from_numpy(gids),
                                         torch.from_numpy(live),
                                         [torch.from_numpy(vals[0])], 3)
    np.testing.assert_array_equal(got_s[0].numpy(), np.asarray(want_s[0]))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert list(got_s[0].numpy()) == [1, 100000, 1000]


def test_cuda_kernel_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(python3 chip_smoke.py runs it on the card)")
    dev = torch.device("cuda")
    for case in CASES:
        gids, live, values, g = _case(case)
        args = (torch.from_numpy(gids).to(dev), torch.from_numpy(live).to(dev),
                [torch.from_numpy(v).to(dev) for v in values], g)
        before = ds.launch_count
        got_s, got_c = ds.dense_grouped_sums(*args)
        assert ds.launch_count == before + 1
        want_s, want_c = ds.dense_grouped_sums_reference(*args)
        for got, want in zip(got_s, want_s):
            assert torch.equal(got, want), case
        assert torch.equal(got_c, want_c), case


class _FakeLib:
    """The kernel library's limits as an H100 reports them."""

    @staticmethod
    def dense_grouped_sums_max_cols():
        return 64

    @staticmethod
    def dense_grouped_sums_max_shared_bytes(device):
        return 232448  # 227 KB opt-in shared memory per block


@pytest.mark.parametrize("k,groups,per", [
    (7, 6, 64),  # q1's partial aggregate: one launch
    (100, 256, 64),  # wider than one launch: two launches
    (100, 1024, 27),  # accumulators cap the columns per launch
    (0, 20000, 1),  # counts only
])
def test_columns_per_launch(k, groups, per):
    assert ds._columns_per_launch(_FakeLib, torch.device("cuda", 0), k,
                                  groups) == per
    # every launch's [G, cols+1] int64 accumulators fit the shared memory
    assert groups * (min(per, k) + 1) * 8 <= 232448 or k == 0


def test_columns_per_launch_rejects_groups_that_do_not_fit():
    with pytest.raises(ExecutionError, match="shared memory"):
        ds._columns_per_launch(_FakeLib, torch.device("cuda", 0), 1, 20000)


def test_wrapper_counts_no_launch_on_cpu_and_rejects_other_devices():
    before = ds.launch_count
    ds.dense_grouped_sums(torch.zeros(4, dtype=torch.int32),
                          torch.ones(4, dtype=torch.bool),
                          [torch.arange(4)], 2)
    assert ds.launch_count == before
    with pytest.raises(ExecutionError):
        ds.dense_grouped_sums(torch.zeros(4, dtype=torch.int32,
                                          device="meta"),
                              torch.ones(4, dtype=torch.bool, device="meta"),
                              [torch.arange(4, device="meta")], 2)


# ---------------------------------------------------------------------------
# the aggregate layer
# ---------------------------------------------------------------------------


def _agg_inputs(mod, array, specs):
    return [mod.AggInput(op, None if v is None else array(v),
                         None if m is None else array(m))
            for op, v, m in specs]


def _specs(rng, n, kinds):
    out = []
    for kind in kinds:
        mask = rng.random(n) < 0.6 if kind.endswith("_masked") else None
        op = kind.split("_")[0]
        if op == "count":
            out.append(("count", None, mask))
        elif op == "fsum":
            out.append(("sum", rng.integers(-50, 50, n).astype(np.float32),
                        mask))
        else:
            out.append((op, rng.integers(-(1 << 40), 1 << 40, n), mask))
    return out


AGG_CASES = {
    "q1_like": (6, ["sum", "sum", "sum_masked", "count", "count_masked"]),
    "with_min_max": (256, ["sum_masked", "sum", "count_masked", "count",
                           "min", "max_masked"]),
    "float_sum_stays_plain": (5, ["sum", "fsum", "count"]),
    "no_sum": (4, ["count", "min", "max"]),
}


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_dense_grouped_aggregate_matches_reference(case, monkeypatch):
    monkeypatch.setenv("BALLISTA_PALLAS", "interpret")
    g, kinds = AGG_CASES[case]
    rng = np.random.default_rng(len(case))
    n = 2048 + 33
    gids = rng.integers(0, g, n).astype(np.int32)
    gids[gids == 1] = 2  # group 1 stays empty
    live = rng.random(n) < 0.8
    specs = _specs(rng, n, kinds)
    want = ref_agg.dense_grouped_aggregate(
        jnp.asarray(gids), jnp.asarray(live),
        _agg_inputs(ref_agg, jnp.asarray, specs), g)
    got = agg.dense_grouped_aggregate(
        torch.from_numpy(gids), torch.from_numpy(live),
        _agg_inputs(agg, torch.from_numpy, specs), g)
    gv = np.asarray(want.group_valid)
    np.testing.assert_array_equal(got.group_valid.numpy(), gv)
    assert not gv[1]
    assert int(got.num_groups) == int(want.num_groups)
    # representatives agree where a group exists; an empty group's is
    # n-1 on the kernel path and 0 on the plain path in BOTH packages
    np.testing.assert_array_equal(got.rep_indices.numpy(),
                                  np.asarray(want.rep_indices))
    for i, (r, rv, a, av) in enumerate(zip(want.aggregates, want.agg_valid,
                                           got.aggregates, got.agg_valid)):
        np.testing.assert_array_equal(av.numpy(), np.asarray(rv), err_msg=i)
        assert a.numpy().dtype == np.asarray(r).dtype, i
        np.testing.assert_array_equal(a.numpy(), np.asarray(r), err_msg=i)


AVG_CASES = [
    # (sums, counts, in_scale): negative sums are the truncation trap
    ([707, -707, -1, 1, 0, -5, 123456789], [2, 2, 3, 3, 4, 0, 7], 2),
    ([-10, -11, 10, 11, -(1 << 50)], [3, 3, 3, 3, 7], 0),
    ([-123456789012, 98765432109], [11, 13], 8),
    ([8 * 1_700_000_000_000, -999999], [8, 1000], 4),
]


@pytest.mark.parametrize("sums,counts,scale", AVG_CASES)
def test_avg_fixed_truncates_like_reference(sums, counts, scale):
    s, c = np.array(sums, np.int64), np.array(counts, np.int64)
    want = np.asarray(ref_agg.avg_fixed(jnp.asarray(s), jnp.asarray(c),
                                        scale))
    got = agg.avg_fixed(torch.from_numpy(s), torch.from_numpy(c), scale)
    np.testing.assert_array_equal(got.numpy(), want)


def test_avg_fixed_negative_sum_is_not_floored():
    got = agg.avg_fixed(torch.tensor([-707]), torch.tensor([2]), 2)
    assert int(got) == -3_535_000
    got = agg.avg_fixed(torch.tensor([-1]), torch.tensor([3]), 0)
    assert int(got) == -333_333  # floor would give -333_334


@pytest.mark.parametrize("masked", [False, True])
def test_scalar_aggregate_matches_reference(masked):
    rng = np.random.default_rng(3)
    n = 1000
    live = rng.random(n) < 0.7
    specs = [("sum", rng.integers(-(1 << 50), 1 << 50, n),
              rng.random(n) < 0.5 if masked else None),
             ("count", None, rng.random(n) < 0.5 if masked else None),
             ("min", rng.integers(-99, 99, n), None),
             ("max", rng.integers(-99, 99, n), None),
             ("sum", np.zeros(n, np.int64), np.zeros(n, bool))]
    want_v, want_ok = ref_agg.scalar_aggregate(
        jnp.asarray(live), _agg_inputs(ref_agg, jnp.asarray, specs))
    got_v, got_ok = agg.scalar_aggregate(
        torch.from_numpy(live), _agg_inputs(agg, torch.from_numpy, specs))
    assert [int(x) for x in got_v] == [int(x) for x in want_v]
    assert [bool(x) for x in got_ok] == [bool(x) for x in want_ok]
