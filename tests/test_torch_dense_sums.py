"""The dense grouped sums of the port against the JAX package.

``dense_grouped_sums`` on CPU tensors is the plain torch version; its sums
and counts must equal the Pallas kernel ``ballista_tpu.kernels.pallas_agg``
run in interpret mode BIT FOR BIT (int64 sums wrap mod 2^64 in both), and
its first rows the ``segment_min`` that ``_dense_grouped_pallas`` puts
beside that kernel. The launch plan of the CUDA kernel is plain Python and
is tested here against an H100's limits. The aggregate layer above it (``dense_grouped_aggregate``, ``avg_fixed``,
``scalar_aggregate``) is held against the JAX package on the same arrays.
The CUDA kernel itself runs only on a card: its test skips here."""

import numpy as np
import jax
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
    if name == "group_all_dead":  # group 2 has rows, none of them live
        n, g = 2000 + 3, 4
        gids = rng.integers(0, g, n).astype(np.int32)
        live = (rng.random(n) < 0.8) & (gids != 2)
        return gids, live, [rng.integers(-(1 << 40), 1 << 40, n)], g
    if name == "first_live_after_dead":  # each group starts with dead rows
        n, g = 3000 + 1, 3
        gids = rng.integers(0, g, n).astype(np.int32)
        live = rng.random(n) < 0.9
        live[:1500] = False
        live[[1700, 2100]] = True
        return gids, live, [rng.integers(0, 10 ** 6, n)], g
    if name == "out_of_range_gids":  # dropped, also before any valid row
        n, g = 1000 + 6, 5
        gids = rng.integers(-4, g + 4, n).astype(np.int32)
        gids[:10] = [-1, 5, 7, -9, 6, 0, 1, 2, 3, 4]
        return (gids, rng.random(n) < 0.9,
                [rng.integers(-(1 << 50), 1 << 50, n),
                 rng.integers(0, 100, n)], g)
    raise KeyError(name)


CASES = ["signed_2_45", "signed_2_49_g256_masked", "empty_groups", "all_dead",
         "wrapping_2_62", "full_range", "no_values", "group_all_dead",
         "first_live_after_dead", "out_of_range_gids"]


def _segment_min_first(gids, live, g):
    """The first rows as ``_dense_grouped_pallas`` computes them, with N
    where ``segment_min`` gives its identity (a group without rows)."""
    n = gids.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    first = jax.ops.segment_min(jnp.where(jnp.asarray(live), pos, n),
                                jnp.asarray(gids), num_segments=g)
    return np.minimum(np.asarray(first).astype(np.int64), n)


def _torch_args(gids, live, values, g):
    return (torch.from_numpy(gids), torch.from_numpy(live),
            [torch.from_numpy(v) for v in values], g)


@pytest.mark.parametrize("case", CASES)
def test_plain_sums_equal_pallas_interpret(case):
    gids, live, values, g = _case(case)
    want_s, want_c = ref_sums(jnp.asarray(gids), jnp.asarray(live),
                              [jnp.asarray(v) for v in values], g,
                              interpret=True)
    got_s, got_c, _ = ds.dense_grouped_sums(
        *_torch_args(gids, live, values, g))
    assert len(got_s) == len(want_s)
    for got, want in zip(got_s, want_s):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("case", CASES)
def test_plain_first_rows_equal_segment_min(case):
    gids, live, values, g = _case(case)
    _, _, first = ds.dense_grouped_sums(*_torch_args(gids, live, values, g))
    assert first.dtype == torch.int64 and first.shape == (g,)
    np.testing.assert_array_equal(first.numpy(),
                                  _segment_min_first(gids, live, g))


def test_plain_sums_match_python_integers_mod_2_64():
    gids, live, values, g = _case("wrapping_2_62")
    got_s, got_c, _ = ds.dense_grouped_sums(
        *_torch_args(gids, live, values, g))
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
    got_s, got_c, got_f = ds.dense_grouped_sums(
        *_torch_args(gids, live, vals, 3))
    np.testing.assert_array_equal(got_s[0].numpy(), np.asarray(want_s[0]))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert list(got_s[0].numpy()) == [1, 100000, 1000]
    assert list(got_f.numpy()) == [0, 5, 3]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(python3 chip_smoke.py runs it on the card)")


def _misaligned(a, dev):
    """``a`` on the card as ``base[1:]`` of a one-longer copy: off the
    16-byte (gids, values) and 4-byte (live) alignment of an allocation."""
    base = torch.from_numpy(np.concatenate([a[:1], a])).to(dev)
    return base[1:]


def _assert_kernel_equals_plain(args, case, vec):
    before = ds.launch_count
    plan = ds.launch_plan(*args)
    assert plan.vec == vec, case
    got = ds.dense_grouped_sums(*args)
    assert ds.launch_count == before + len(plan.launches), case
    want = ds.dense_grouped_sums_reference(*args)
    for g, w in zip(got[0] + [got[1], got[2]], want[0] + [want[1], want[2]]):
        assert torch.equal(g, w), case


def test_cuda_kernel_equals_plain_version():
    _needs_card()
    dev = torch.device("cuda")
    for case in CASES:
        gids, live, values, g = _case(case)
        args = (torch.from_numpy(gids).to(dev), torch.from_numpy(live).to(dev),
                [torch.from_numpy(v).to(dev) for v in values], g)
        _assert_kernel_equals_plain(args, case, vec=4)
        # the same rows off the vector alignment: the VEC = 1 instantiation
        args = (_misaligned(gids, dev), _misaligned(live, dev),
                [_misaligned(v, dev) for v in values], g)
        _assert_kernel_equals_plain(args, case + " misaligned", vec=1)


def test_cuda_aggregate_takes_first_rows_from_the_kernel(monkeypatch):
    _needs_card()
    rng = np.random.default_rng(5)
    n, g = 5000 + 3, 6
    dev = torch.device("cuda")
    gids = torch.from_numpy(rng.integers(0, g, n).astype(np.int32)).to(dev)
    live = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    aggs = [agg.AggInput("sum", torch.from_numpy(rng.integers(0, 99, n))
                         .to(dev), None), agg.AggInput("count", None, None)]
    want = agg.dense_grouped_aggregate(gids.cpu(), live.cpu(),
                                       [agg.AggInput(a.op, None if a.values
                                                     is None else
                                                     a.values.cpu(), None)
                                        for a in aggs], g)

    def no_scatter(*args, **kwargs):
        raise AssertionError("scatter_reduce_ on the kernel path")

    monkeypatch.setattr(torch.Tensor, "scatter_reduce_", no_scatter)
    got = agg.dense_grouped_aggregate(gids, live, aggs, g)
    assert torch.equal(got.rep_indices.cpu(), want.rep_indices)
    for a, b in zip(got.aggregates, want.aggregates):
        assert torch.equal(a.cpu(), b)


class _FakeLib:
    """The kernel library's limits as an H100 reports them."""

    SM_SHARED = 233472  # 228 KB of shared memory per SM
    BLOCK_RESERVED = 1024  # the runtime's own share of each block's

    @staticmethod
    def dense_grouped_sums_max_cols():
        return 64

    @staticmethod
    def dense_grouped_sums_max_shared_bytes(device):
        return 232448  # 227 KB opt-in shared memory per block

    @classmethod
    def dense_grouped_sums_blocks_per_sm(cls, vec, threads, shared_bytes):
        assert vec in (1, 4) and threads == ds.THREADS
        if shared_bytes > cls.dense_grouped_sums_max_shared_bytes(0):
            return 0
        return min(2048 // threads,
                   cls.SM_SHARED // (shared_bytes + cls.BLOCK_RESERVED))


@pytest.mark.parametrize("k,groups,per", [
    (7, 6, 64),  # q1's partial aggregate: one launch
    (100, 256, 64),  # wider than one launch: two launches
    (100, 1024, 26),  # accumulators cap the columns per launch
    (0, 10000, 1),  # counts (and first rows) only
])
def test_columns_per_launch(k, groups, per):
    assert ds._columns_per_launch(_FakeLib, 0, k, groups) == per
    # every launch's [G, cols+2] int64 accumulators (sums, count, first
    # row) fit the shared memory at one replica
    assert groups * (min(per, k) + 2) * 8 <= 232448


def test_columns_per_launch_rejects_groups_that_do_not_fit():
    with pytest.raises(ExecutionError, match="shared memory"):
        ds._columns_per_launch(_FakeLib, 0, 1, 20000)
    with pytest.raises(ExecutionError, match="shared memory"):
        ds._columns_per_launch(_FakeLib, 0, 0, 20000)


SMS = 132
ALIGNED = (1 << 20, 1 << 22, [(1 << 24) + 512 * j for j in range(100)])


@pytest.mark.parametrize("name,n,groups,k,ptrs,vec,want", [
    # q1's partial aggregate: 13,824 B at R = 32, 8 blocks an SM
    ("q1_partial", 6291456, 6, 7, ALIGNED, 4, [(0, 7, True, 32, 1056)]),
    # gids 4 B off: one row a step, the same replicas
    ("gids_misaligned", 6291456, 6, 7,
     (ALIGNED[0] + 4, ALIGNED[1], ALIGNED[2]), 1, [(0, 7, True, 32, 1056)]),
    ("live_misaligned", 6291456, 6, 7,
     (ALIGNED[0], ALIGNED[1] + 1, ALIGNED[2]), 1, [(0, 7, True, 32, 1056)]),
    # a value column 8 B off
    ("value_misaligned", 6291456, 6, 7,
     (ALIGNED[0], ALIGNED[1], ALIGNED[2][:6] + [ALIGNED[2][6] + 8]), 1,
     [(0, 7, True, 32, 1056)]),
    # live only 4-byte aligned is enough
    ("live_4_aligned", 6291456, 6, 7,
     (ALIGNED[0], ALIGNED[1] + 4, ALIGNED[2]), 4, [(0, 7, True, 32, 1056)]),
    # q1's final aggregate: six rows, one block
    ("q1_final", 6, 6, 12, ALIGNED, 4, [(0, 12, True, 32, 1)]),
    # G = 256: R = 8 fits one block an SM, R = 4 three
    ("g256", 3000017, 256, 6, ALIGNED, 4, [(0, 6, True, 4, 396)]),
    # 100 columns: two launches, only the first finds the first rows
    ("k100", 200003, 256, 100, ALIGNED, 4,
     [(0, 64, True, 1, 132), (64, 100, False, 1, 196)]),
    ("counts_only", 1000, 3, 0, ALIGNED, 4, [(0, 0, True, 32, 1)]),
])
def test_launch_plan(name, n, groups, k, ptrs, vec, want):
    gids_ptr, live_ptr, value_ptrs = ptrs
    plan = ds.plan_launches(_FakeLib, 0, SMS, n, groups, gids_ptr, live_ptr,
                            value_ptrs[:k])
    assert plan.vec == vec, name
    got = [(s.lo, s.hi, s.first, s.replicas, s.blocks)
           for s in plan.launches]
    assert got == want, name
    for s in plan.launches:
        # the kernel's [G, cols+1 (+1 with first rows), R] accumulators fit
        nbytes = groups * (s.hi - s.lo + 1 + int(s.first)) * s.replicas * 8
        assert nbytes <= _FakeLib.dense_grouped_sums_max_shared_bytes(0)
        # a persistent grid: never more blocks than fit the card at once,
        # nor more than the rows need
        occ = _FakeLib.dense_grouped_sums_blocks_per_sm(vec, ds.THREADS,
                                                        nbytes)
        assert 1 <= s.blocks <= SMS * occ
        assert s.blocks <= max(1, -(-n // (ds.THREADS * vec)))


def test_launch_plan_gives_up_replicas_for_occupancy():
    # R = 2 fits only one block an SM; R = 1 fits three
    plan = ds.plan_launches(_FakeLib, 0, SMS, 10 ** 6, 256, *ALIGNED[:2],
                            ALIGNED[2][:35])
    assert [(s.replicas, s.blocks) for s in plan.launches] == [(1, 396)]


def test_launch_plan_is_cached_per_shape():
    class Counting(_FakeLib):
        queries = 0

        @classmethod
        def dense_grouped_sums_blocks_per_sm(cls, vec, threads, shared_bytes):
            cls.queries += 1
            return super().dense_grouped_sums_blocks_per_sm(vec, threads,
                                                            shared_bytes)

    args = (Counting, 0, SMS, 6291456, 6, *ALIGNED[:2], ALIGNED[2][:7])
    plan = ds.plan_launches(*args)
    queried = Counting.queries
    assert queried >= 1
    assert ds.plan_launches(*args) is plan
    # another N plans anew but asks the card nothing more
    other = ds.plan_launches(Counting, 0, SMS, 1000, 6, *ALIGNED[:2],
                             ALIGNED[2][:7])
    assert Counting.queries == queried
    assert [(s.replicas, s.blocks) for s in other.launches] == [(32, 1)]


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
