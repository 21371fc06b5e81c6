"""The port's mesh device functions against the JAX package's, on the
same seeded numpy inputs (``ballista_tpu_torch/kernels/mesh_shuffle.py``,
``parallel/mesh.py`` and the helpers of ``physical/mesh_input.py``):

- ``destination_ids``: the destination slot of every row, dead rows 0;
- the row exchange (``all_to_all_rows``) over 8 slots against the JAX
  one under ``shard_map`` over the 8 virtual CPU devices: every output
  column, the rebuilt live mask and the send counts, with dead rows and
  with counts above ``dest_capacity`` (overflow: the same rows dropped);
- ``_compact_impl`` (shrinking and growing), ``_window_slot`` and
  ``_apply_remaps`` with codes outside the remap table (clamped, as
  JAX's ``take(mode="clip")``);
- the twins of ``tests/test_parallel.py``: a two-phase aggregate through
  ``MeshQueryRunner.run_spmd`` and the exchange through ``shuffle_fn``,
  both against a numpy oracle.

All integer and boolean outputs must be exactly equal.
"""

import numpy as np
import pytest
import torch

from ballista_tpu_torch import datatypes as pdt
from ballista_tpu_torch.columnar import Column, ColumnBatch, Dictionary
from ballista_tpu_torch.kernels import mesh_shuffle
from ballista_tpu_torch.parallel.mesh import (MeshQueryRunner, SlotAxis,
                                              make_mesh)
from ballista_tpu_torch.physical import mesh_input

from torch_warm_path import pinned_threads

N_DEV = 8


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    with pinned_threads():
        yield


def _eq(port_t, jax_a, what=""):
    np.testing.assert_array_equal(port_t.numpy(), np.asarray(jax_a),
                                  err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_destination_ids_equal_reference(seed):
    from ballista_tpu.kernels import mesh_shuffle as ref

    rng = np.random.default_rng(seed)
    keys = rng.integers(-2**62, 2**62, 4096, dtype=np.int64)
    live = rng.random(4096) < 0.7
    for n in (2, 3, 8):
        _eq(mesh_shuffle.destination_ids(torch.from_numpy(keys),
                                         torch.from_numpy(live), n),
            ref.destination_ids(keys, live, n), f"n={n}")


def _jax_exchange(cols, live, dest, cap):
    """The JAX package's all_to_all_rows under shard_map over 8 devices
    on stacked [8, N] inputs; stacked outputs."""
    from functools import partial

    import jax
    from jax.sharding import PartitionSpec as P

    from ballista_tpu.kernels import mesh_shuffle as ref
    from ballista_tpu.parallel.mesh import make_mesh as ref_mesh, shard_map

    mesh = ref_mesh(N_DEV)

    @partial(shard_map, mesh=mesh, in_specs=(P("data"),) * 3,
             out_specs=P("data"), check_vma=False)
    def run(cs, lv, ds):
        out, olive, counts = ref.all_to_all_rows(
            [c[0] for c in cs], lv[0], ds[0], "data", N_DEV, cap)
        return [o[None] for o in out], olive[None], counts[None]

    return jax.jit(run)(cols, live, dest)


@pytest.mark.parametrize("cap,dead", [(64, 0.0), (64, 0.4), (5, 0.2)],
                         ids=["whole", "dead_rows", "overflow"])
def test_exchange_equals_reference(cap, dead, eight_devices):
    rng = np.random.default_rng(7)
    n = 48
    keys = rng.integers(0, 1000, (N_DEV, n), dtype=np.int64)
    vals = rng.integers(-10**12, 10**12, (N_DEV, n), dtype=np.int64)
    flags = rng.random((N_DEV, n)) < 0.5
    live = rng.random((N_DEV, n)) >= dead
    from ballista_tpu.kernels import mesh_shuffle as ref

    dest = np.stack([np.asarray(ref.destination_ids(keys[q], live[q], N_DEV))
                     for q in range(N_DEV)])
    want_cols, want_live, want_counts = _jax_exchange(
        [keys, vals, flags], live, dest, cap)
    axis = SlotAxis(make_mesh(N_DEV, "cpu"))
    got_cols, got_live, got_counts = mesh_shuffle.all_to_all_rows(
        [torch.from_numpy(keys), torch.from_numpy(vals),
         torch.from_numpy(flags)], torch.from_numpy(live),
        torch.from_numpy(dest), axis, N_DEV, cap)
    for g, w, name in zip(got_cols, want_cols, ["keys", "vals", "flags"]):
        _eq(g, w, name)
    _eq(got_live, want_live, "live")
    _eq(got_counts, want_counts, "counts")
    if cap < n:
        assert int(got_counts.max()) > cap  # the overflow case overflowed


def _batches(rng, cap, with_validity, dictionary=None):
    """Twin batches (port, JAX) over the same numpy columns."""
    import jax.numpy as jnp

    from ballista_tpu import datatypes as rdt
    from ballista_tpu.columnar import Column as RCol, ColumnBatch as RBatch
    from ballista_tpu.columnar import Dictionary as RDict

    v = rng.integers(-1000, 1000, cap, dtype=np.int64)
    c = rng.integers(0, 7, cap).astype(np.int32)
    sel = rng.random(cap) < 0.45
    va = rng.random(cap) < 0.8 if with_validity else None
    n = np.int32(sel.sum())
    ps = pdt.Schema([pdt.Field("v", pdt.Int64), pdt.Field("c", pdt.Utf8)])
    rs = rdt.Schema([rdt.Field("v", rdt.Int64), rdt.Field("c", rdt.Utf8)])
    d = dictionary or [f"s{i}" for i in range(7)]
    pd_, rd_ = Dictionary(d), RDict(d)
    port = ColumnBatch(ps, [
        Column(torch.from_numpy(v), pdt.Int64,
               None if va is None else torch.from_numpy(va)),
        Column(torch.from_numpy(c), pdt.Utf8, None, pd_)],
        torch.from_numpy(sel), torch.tensor(n))
    ref = RBatch(rs, [
        RCol(jnp.asarray(v), rdt.Int64, None if va is None else
             jnp.asarray(va)),
        RCol(jnp.asarray(c), rdt.Utf8, None, rd_)],
        jnp.asarray(sel), jnp.asarray(n))
    return port, ref


def _assert_batches_equal(got, want):
    for gc, wc in zip(got.columns, want.columns):
        _eq(gc.values, wc.values, "values")
        assert (gc.validity is None) == (wc.validity is None)
        if gc.validity is not None:
            _eq(gc.validity, wc.validity, "validity")
    _eq(got.selection, want.selection, "selection")
    _eq(got.num_rows, want.num_rows, "num_rows")


@pytest.mark.parametrize("cap", [64, 256, 512], ids=["shrink", "same",
                                                     "grow"])
@pytest.mark.parametrize("with_validity", [False, True])
def test_compact_impl_equals_reference(cap, with_validity):
    from ballista_tpu.physical import mesh_input as ref

    rng = np.random.default_rng(cap + with_validity)
    port, jref = _batches(rng, 256, with_validity)
    _assert_batches_equal(mesh_input._compact_impl(port, cap),
                          ref._compact_impl(jref, cap))


@pytest.mark.parametrize("start,count", [(0, 16), (32, 5), (96, 0)])
def test_window_slot_equals_reference(start, count):
    from ballista_tpu.physical import mesh_input as ref

    rng = np.random.default_rng(start)
    port, jref = _batches(rng, 128, True)
    packed = mesh_input._compact_impl(port, 128)
    rpacked = ref._compact_impl(jref, 128)
    _assert_batches_equal(mesh_input._window_slot(packed, start, 32, count),
                          ref._window_slot(rpacked, start, 32, count))


def test_apply_remaps_clamps_out_of_range_codes():
    """Codes past the remap table read its last entry, as JAX's clip
    gather does; the shared dictionary replaces the batch's."""
    from ballista_tpu import columnar as rcol
    from ballista_tpu.physical import mesh_input as ref

    rng = np.random.default_rng(3)
    port, jref = _batches(rng, 64, False)
    remap = np.array([4, 2, 0, 1], dtype=np.int32)  # codes 4..6 clamp
    shared = [f"u{i}" for i in range(5)]
    pd_, rd_ = Dictionary(shared), rcol.Dictionary(shared)
    got = mesh_input._apply_remaps(port.schema, port, [None, remap],
                                   [None, pd_])
    want = ref._apply_remaps(jref.schema, jref, [None, remap], [None, rd_])
    _assert_batches_equal(got, want)
    assert got.columns[1].dictionary is pd_
    codes = port.columns[1].values.numpy()
    assert (codes > 3).any()  # the table was too short for some rows


# ---------------------------------------------------------------------------
# twins of tests/test_parallel.py
# ---------------------------------------------------------------------------

CAP = 256


def _device_batches(seed):
    """test_parallel.make_device_batches' data, as port batches."""
    s = pdt.Schema([pdt.Field("k", pdt.Int64), pdt.Field("v", pdt.Int64)])
    rng = np.random.default_rng(seed)
    batches, all_k, all_v = [], [], []
    for _ in range(N_DEV):
        n = int(rng.integers(CAP // 2, CAP))
        k = rng.integers(0, 5, n)
        v = rng.integers(0, 100, n)
        all_k.append(k)
        all_v.append(v)
        batches.append(ColumnBatch.from_numpy(s, {"k": k, "v": v},
                                              capacity=CAP, device="cpu"))
    return s, batches, np.concatenate(all_k), np.concatenate(all_v)


def test_mesh_two_phase_aggregate():
    from ballista_tpu_torch.kernels.aggregate import (AggInput,
                                                      grouped_aggregate)

    s, batches, gk, gv = _device_batches(0)
    runner = MeshQueryRunner(make_mesh(N_DEV, "cpu"))
    G = 8

    def device_fn(cols, live, axis):
        def partial_agg(k, v, lv):
            res = grouped_aggregate(
                [k], lv, [AggInput("sum", v, None),
                          AggInput("count", None, None)], G)
            keys = torch.where(res.group_valid, k[res.rep_indices.long()],
                               -1)
            return keys, res.aggregates[0], res.aggregates[1]

        keys, sums, cnts = axis.map(partial_agg, cols["k"], cols["v"], live)
        # merge: all-gather the partial tables, re-aggregate (replicated)
        keys_g = axis.all_gather(keys).reshape(-1)
        sums_g = axis.all_gather(sums).reshape(-1)
        cnts_g = axis.all_gather(cnts).reshape(-1)
        final = grouped_aggregate(
            [keys_g], keys_g >= 0,
            [AggInput("sum", sums_g, None), AggInput("sum", cnts_g, None)],
            G)
        fk = torch.where(final.group_valid,
                         keys_g[final.rep_indices.long()], -1)
        return fk, final.aggregates[0], final.aggregates[1]

    (fk, fs, fc), _ = runner.run_spmd(s, batches, device_fn)
    got = {int(k): (int(a), int(c))
           for k, a, c in zip(fk.tolist(), fs.tolist(), fc.tolist())
           if k >= 0}
    exp = {int(k): (int(gv[gk == k].sum()), int((gk == k).sum()))
           for k in np.unique(gk)}
    assert got == exp


def test_mesh_all_to_all_shuffle():
    s, batches, gk, gv = _device_batches(1)
    runner = MeshQueryRunner(make_mesh(N_DEV, "cpu"))
    shuffle = runner.shuffle_fn("k", dest_capacity=CAP)

    def device_fn(cols, live, axis):
        cols2, live2, overflowed = shuffle(cols, live, axis)
        # after the exchange every live row of a slot must hash there
        dest2 = axis.map(
            lambda k, lv: mesh_shuffle.destination_ids(k, lv, N_DEV),
            cols2["k"], live2)
        me = axis.axis_index()[:, None]
        misplaced = (live2 & (dest2 != me)).sum(dim=1)
        local_sum = torch.where(live2, cols2["v"], 0).sum(dim=1)
        local_rows = live2.sum(dim=1)
        return (axis.all_gather(misplaced), axis.all_gather(local_sum),
                axis.all_gather(local_rows), overflowed)

    (mis, sums, rows, overflowed), _ = runner.run_spmd(s, batches, device_fn)
    assert int(mis.sum()) == 0, "rows landed on the wrong slot"
    assert int(rows.sum()) == len(gk), "rows lost in the exchange"
    assert int(sums.sum()) == int(gv.sum()), "values corrupted"
    assert not bool(overflowed)
