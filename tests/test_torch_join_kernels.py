"""The port's join and hash kernels against the JAX package.

Each function of ``ballista_tpu_torch/kernels/join.py`` and
``kernels/hashing.py`` runs on the same seeded numpy arrays as its JAX
counterpart, and every output must be equal exactly. The one exception is
written down by both packages: which of several rows with one key
``build_dense`` keeps is unspecified, so there the duplicate flag must
match and each kept row must carry its slot's key. Also here: the FNV-1a
hashes of dictionary values, the probe-code -> build-code remap between
two dictionaries, and the partition ids of a batch."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ballista_tpu as ref_pkg
from ballista_tpu import columnar as ref_columnar
from ballista_tpu.columnar_registry import _searchsorted_remap
from ballista_tpu.kernels import hashing as ref_hash
from ballista_tpu.kernels import join as ref_join
from ballista_tpu.kernels.expr_eval import Evaluator as RefEvaluator
from ballista_tpu.physical.operators import compute_partition_ids as ref_ids

import ballista_tpu_torch as bt
from ballista_tpu_torch import columnar
from ballista_tpu_torch.kernels import hashing, join
from ballista_tpu_torch.kernels.expr_eval import Evaluator
from ballista_tpu_torch.physical.operators import compute_partition_ids

I64 = np.iinfo(np.int64)
CASES = ["unique", "duplicates", "dead_rows", "negative", "near_sentinel",
         "empty_build"]


def _case(name):
    """(build keys, build live, probe keys, probe live) as numpy arrays."""
    rng = np.random.default_rng(CASES.index(name))
    nb, npr = 64, 200
    if name == "unique":
        bk = rng.permutation(1000)[:nb].astype(np.int64)
        bl = np.ones(nb, bool)
    elif name == "duplicates":
        bk = rng.integers(0, 20, nb)
        bl = np.ones(nb, bool)
    elif name == "dead_rows":
        bk = rng.integers(0, 40, nb)
        bl = rng.random(nb) < 0.6
    elif name == "negative":
        bk = rng.integers(-50, 50, nb)
        bl = rng.random(nb) < 0.9
    elif name == "near_sentinel":
        bk = rng.choice(np.array([I64.max, I64.max - 1, I64.max - 2, I64.min,
                                  I64.min + 1, 0, -1]), nb)
        bl = rng.random(nb) < 0.8
    else:  # every build row dead
        bk = rng.integers(0, 40, nb)
        bl = np.zeros(nb, bool)
    live_keys = bk[bl] if bl.any() else bk
    pk = np.where(rng.random(npr) < 0.6, rng.choice(live_keys, npr),
                  rng.integers(-60, 1200, npr))
    if name == "near_sentinel":
        pk[:7] = [I64.max, I64.max - 1, I64.max - 2, I64.min, I64.min + 1, 0,
                  -1]
    pl = rng.random(npr) < 0.85
    return bk.astype(np.int64), bl, pk.astype(np.int64), pl


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(name):
    bk, bl, pk, pl = _case(name)
    ref = ref_join.build_lookup(jnp.asarray(bk), jnp.asarray(bl))
    got = join.build_lookup(_t(bk), _t(bl))
    return (ref, got), (pk, pl)


def _eq(got: torch.Tensor, want, what: str):
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("name", CASES)
def test_build_lookup(name):
    (ref, got), _ = _tables(name)
    _eq(got.sorted_keys, ref.sorted_keys, "sorted_keys")
    _eq(got.order, ref.order, "order")
    _eq(got.num_live, ref.num_live, "num_live")


@pytest.mark.parametrize("name", CASES)
def test_build_sorted_with_unique(name):
    bk, bl, _, _ = _case(name)
    ref, ref_u = ref_join.build_sorted_with_unique(jnp.asarray(bk),
                                                   jnp.asarray(bl))
    got, got_u = join.build_sorted_with_unique(_t(bk), _t(bl))
    _eq(got.sorted_keys, ref.sorted_keys, "sorted_keys")
    _eq(got.order, ref.order, "order")
    assert bool(got_u) == bool(ref_u)


@pytest.mark.parametrize("name", CASES)
def test_probe_unique_sorted(name):
    (ref, got), (pk, pl) = _tables(name)
    rr, rm = ref_join.probe_unique(ref, jnp.asarray(pk), jnp.asarray(pl))
    gr, gm = join.probe_unique(got, _t(pk), _t(pl))
    _eq(gm, rm, "matched")
    _eq(gr, rr, "build rows")
    _eq(join.probe_semi(got, _t(pk), _t(pl)),
        ref_join.probe_semi(ref, jnp.asarray(pk), jnp.asarray(pl)), "semi")


@pytest.mark.parametrize("name", CASES)
def test_probe_counts(name):
    (ref, got), (pk, _) = _tables(name)
    _eq(join.probe_counts(got, _t(pk)),
        ref_join.probe_counts(ref, jnp.asarray(pk)), "counts")


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("capacity", [8, 64, 4096])
def test_probe_expand(name, capacity):
    """Past its capacity the expansion is truncated and still reports the
    true total, from which the caller re-runs larger."""
    (ref, got), (pk, pl) = _tables(name)
    want = ref_join.probe_expand(ref, jnp.asarray(pk), jnp.asarray(pl),
                                 capacity)
    have = join.probe_expand(got, _t(pk), _t(pl), capacity)
    for g, w, what in zip(have, want, ("probe rows", "build rows",
                                       "out live", "total")):
        _eq(g, w, what)


def test_probe_expand_reports_totals_past_capacity():
    (ref, got), (pk, pl) = _tables("duplicates")
    total = int(join.probe_expand(got, _t(pk), _t(pl), 8)[3])
    assert total > 8
    assert total == int(ref_join.probe_expand(
        ref, jnp.asarray(pk), jnp.asarray(pl), 8)[3])
    _, _, live, again = join.probe_expand(got, _t(pk), _t(pl), total)
    assert int(again) == total and int(live.sum()) == total


DENSE_CASES = ["dense_unique", "dense_dead_rows", "dense_duplicates"]


def _dense_case(name):
    rng = np.random.default_rng(DENSE_CASES.index(name) + 10)
    base, size = -7, 64
    if name == "dense_duplicates":
        bk = rng.integers(base, base + 40, 100)
        bl = np.ones(100, bool)
    else:
        bk = rng.permutation(np.arange(base, base + 50))
        bl = (rng.random(50) < 0.7) if name == "dense_dead_rows" \
            else np.ones(50, bool)
    pk = rng.integers(base - 10, base + size + 10, 300)
    pl = rng.random(300) < 0.9
    return bk.astype(np.int64), bl, base, size, pk.astype(np.int64), pl


@pytest.mark.parametrize("name", DENSE_CASES)
def test_build_dense_and_probe(name):
    bk, bl, base, size, pk, pl = _dense_case(name)
    rrows, rdup = ref_join.build_dense(jnp.asarray(bk), jnp.asarray(bl),
                                       jnp.int64(base), size)
    grows, gdup = join.build_dense(_t(bk), _t(bl), base, size)
    assert bool(gdup) == bool(rdup) == (name == "dense_duplicates")
    if bool(gdup):
        # which duplicate lands is unspecified in both packages: every
        # filled slot must hold a live row with the slot's key, and the
        # filled slots must be the same
        g = grows.numpy()
        filled = g >= 0
        np.testing.assert_array_equal(filled, np.asarray(rrows) >= 0)
        assert (bk[g[filled]] - base == np.flatnonzero(filled)).all()
        assert bl[g[filled]].all()
        return
    _eq(grows, rrows, "dense rows")
    ref = ref_join.BuildTable(None, None, jnp.int32(int(bl.sum())), rrows,
                              jnp.int64(base))
    got = join.BuildTable(None, None, torch.tensor(int(bl.sum())), grows,
                          base)
    rr, rm = ref_join.probe_unique(ref, jnp.asarray(pk), jnp.asarray(pl))
    gr, gm = join.probe_unique(got, _t(pk), _t(pl))
    _eq(gm, rm, "matched")
    _eq(gr, rr, "build rows")


def _full_range(n=4096):
    rng = np.random.default_rng(99)
    x = rng.integers(I64.min, I64.max, n, endpoint=True)
    x[:6] = [I64.min, I64.max, 0, -1, 1, I64.min + 1]
    return x


def test_splitmix64_full_int64_range():
    x = _full_range()
    want = np.asarray(ref_hash.splitmix64(jnp.asarray(x))).view(np.int64)
    np.testing.assert_array_equal(hashing.splitmix64(_t(x)).numpy(), want)


@pytest.mark.parametrize("p", [1, 7, 8, 13])
def test_hash_partition_ids_full_int64_range(p):
    x = _full_range()
    _eq(hashing.hash_partition_ids(_t(x), p),
        ref_hash.hash_partition_ids(jnp.asarray(x), p), f"P={p}")


VALUES = ["", "a", "BUILDING", "zz top", "été", "日本",
          "trailing nul\x00", "x" * 80]


def test_stable_hashes_equal_the_reference():
    want = ref_columnar.Dictionary(sorted(VALUES)).stable_hashes()
    got = columnar.Dictionary(sorted(VALUES)).stable_hashes()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(columnar.Dictionary([]).stable_hashes()) == 0


def test_remap_between_dictionaries():
    src = columnar.Dictionary(sorted(["AIR", "MAIL", "RAIL", "SHIP", "ZEP"]))
    dst = columnar.Dictionary(sorted(["AIR", "FOB", "RAIL", "SHIP", "TRUCK"]))
    got = columnar.remap_between(src, dst)
    want = _searchsorted_remap(src.values_str(), dst.values_str())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert columnar.remap_between(src, src) is None
    np.testing.assert_array_equal(
        columnar.remap_between(src, columnar.Dictionary([])),
        _searchsorted_remap(src.values_str(), np.zeros(0, str)))


@pytest.mark.parametrize("keys", [["k"], ["s"], ["k", "s"], []],
                         ids=["int", "utf8", "both", "round_robin"])
@pytest.mark.parametrize("p", [7, 8])
def test_compute_partition_ids(keys, p):
    """Partition ids of a batch, hashed on int64 and utf8 columns (the
    string's value, not its code) or dealt round-robin from a row offset,
    equal the JAX package's."""
    rng = np.random.default_rng(p)
    data = {"k": rng.integers(I64.min, I64.max, 300, endpoint=True).tolist(),
            "s": [VALUES[i] for i in rng.integers(0, 7, 300)]}
    ref_schema = ref_pkg.schema(("k", "int64"), ("s", "utf8"))
    schema = bt.schema(("k", "int64"), ("s", "utf8"))
    ref_batch = ref_columnar.ColumnBatch.from_pydict(ref_schema, data)
    batch = columnar.ColumnBatch.from_pydict(schema, data, device="cpu")
    want = ref_ids(ref_batch, [ref_pkg.col(k) for k in keys], p, 5,
                   RefEvaluator(ref_schema))
    got = compute_partition_ids(batch, [bt.col(k) for k in keys], p, 5,
                                Evaluator(schema))
    _eq(got, want, f"{keys} P={p}")
