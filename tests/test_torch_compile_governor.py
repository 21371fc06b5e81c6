"""The port's compile governor (``ballista_tpu_torch/compile/governor.py``)
on the CPU, after the cases of ``tests/test_compile_governor.py`` that
apply to it: entries shared and counted, namespace eviction, builds that
request entries, first-call attribution to metrics, programs bounded by
the ladder, re-plans that build nothing new, entries that pin no plan,
and bucket padding on and off. Beside them, the parts with no JAX
counterpart: the call signature (one program per dictionary), the
sync-free ``compact_perm`` against the nonzero-based one it replaced and
``jnp.nonzero(size=)``, and the card's graph path driven on the CPU
through ``testing/capture_check.py`` (captures, replays, replay hooks,
constants, a failed capture raising). Results are exact: every query
here sums integers. The ``test_cuda_*`` tests need a card and skip here
(``python3 -m ballista_tpu_torch.testing.card_checks`` runs them)."""

import gc
import importlib
import threading
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ballista_tpu_torch import Int64, Utf8, schema
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.compile import (bucket_capacity, compile_stats,
                                        governed, governor, reconfigure)
from ballista_tpu_torch.observability.metrics import MetricsSet
from ballista_tpu_torch.physical.base import compact_perm
from ballista_tpu_torch.testing.capture_check import (emulated_graphs,
                                                      simulated_capture)

from torch_warm_path import pinned_threads


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """Two torch, ingest and scanner threads for this file's queries
    (``torch_warm_path.pinned_threads``)."""
    with pinned_threads():
        yield


gov = importlib.import_module("ballista_tpu_torch.compile.governor")


@pytest.fixture
def bucket_env(monkeypatch):
    """Set BALLISTA_SHAPE_BUCKETS* env for a test and re-read it,
    restoring the default config afterwards."""

    def set_env(**kv):
        for k, v in kv.items():
            name = "BALLISTA_SHAPE_BUCKETS" + (f"_{k.upper()}" if k else "")
            monkeypatch.setenv(name, str(v))
        reconfigure()

    yield set_env
    monkeypatch.undo()
    reconfigure()


@pytest.fixture
def graphs(monkeypatch):
    """The card's graph path, on the CPU."""
    with emulated_graphs(monkeypatch):
        yield


# ---------------------------------------------------------------------------
# governor units
# ---------------------------------------------------------------------------


def test_governed_entry_shared_and_counted():
    built = []

    def build():
        built.append(1)
        return lambda x: x + 1

    key = ("test.unit", "shared")
    f1 = governed(key, build)
    f2 = governed(key, build)
    assert f1 is f2
    assert built == [1]  # second lookup did not rebuild
    assert int(f1(torch.tensor(1))) == 2
    assert f1.calls >= 1


def test_governed_namespace_eviction():
    g = governor()
    g.clear("test.evict")
    for i in range(5):
        governed(("test.evict", i), lambda: (lambda x: x), cap=3)
    assert g.namespace_sizes().get("test.evict") == 3
    g.clear("test.evict")


def test_governed_build_may_request_governed_entries():
    """A build() that itself asks the governor for another entry must not
    self-deadlock: entries build outside the lock."""
    g = governor()
    g.clear("test.nested")

    def outer_build():
        inner = governed(("test.nested", "inner"), lambda: (lambda x: x * 2))
        return lambda x: inner(x) + 1

    out = governed(("test.nested", "outer"), outer_build)(torch.tensor(3))
    assert int(out) == 7
    g.clear("test.nested")


def test_governed_compile_attribution_to_metrics():
    m = MetricsSet()
    fn = governed(("test.unit", "attrib"), lambda: (lambda x: x * 3 + 17),
                  metrics=m)
    before = compile_stats()["programs_built"]
    fn(torch.arange(1024))
    fn(torch.arange(1024))  # same signature: no second first call
    vals = m.values()
    assert vals.get("compile_count") == 1
    assert vals.get("elapsed_compile", 0.0) > 0.0
    st = compile_stats()
    assert st["programs_built"] == before + 1
    assert st["entries"] >= 1
    for k in ("graph_captures", "capture_seconds", "graph_replays",
              "entries_built", "entry_hits", "governed_calls"):
        assert k in st


# ---------------------------------------------------------------------------
# programs bounded by the ladder; re-plans build nothing new
# ---------------------------------------------------------------------------


def _jitter_ctx(n: int) -> BallistaContext:
    s = schema(("k", Int64), ("v", Int64))
    ctx = BallistaContext.standalone(device="cpu")
    ctx.register_memtable("t", s, {
        "k": (np.arange(n) % 7).astype(np.int64),
        "v": np.arange(n, dtype=np.int64),
    })
    return ctx


_JITTER_SQL = ("SELECT k, SUM(v) AS sv, COUNT(*) AS c FROM t "
               "GROUP BY k ORDER BY k")


def _expected(n: int):
    k = (np.arange(n) % 7).astype(np.int64)
    v = np.arange(n, dtype=np.int64)
    return {int(g): (int(v[k == g].sum()), int((k == g).sum()))
            for g in range(7)}


def test_partition_size_jitter_bounded_by_ladder():
    """N distinct row counts -> programs are built only when a NEW ladder
    rung is first seen (fresh context and operators every time)."""
    counts_rung1 = [100, 300, 600, 1000]
    counts_rung2 = [1500, 1800, 2048]
    assert {bucket_capacity(n) for n in counts_rung1} == {1024}
    assert {bucket_capacity(n) for n in counts_rung2} == {2048}

    def run(n):
        out = _jitter_ctx(n).sql(_JITTER_SQL).to_pydict()
        got = {int(k): (int(s), int(c))
               for k, s, c in zip(out["k"], out["sv"], out["c"])}
        assert got == _expected(n)

    run(counts_rung1[0])
    base = compile_stats()["programs_built"]
    for n in counts_rung1[1:]:
        run(n)
    assert compile_stats()["programs_built"] == base, \
        "distinct row counts on one ladder rung must not build programs"
    run(counts_rung2[0])
    base2 = compile_stats()["programs_built"]
    for n in counts_rung2[1:]:
        run(n)
    assert compile_stats()["programs_built"] == base2


def _replan_ctx() -> BallistaContext:
    ctx = BallistaContext.standalone(device="cpu")
    n = 1200
    rng = np.random.RandomState(7)
    ctx.register_memtable("orders_r", schema(
        ("okey", Int64), ("ckey", Int64), ("amount", Int64)), {
        "okey": np.arange(n, dtype=np.int64),
        "ckey": rng.randint(0, 40, n).astype(np.int64),
        "amount": rng.randint(0, 1000, n).astype(np.int64),
    })
    ctx.register_memtable("cust_r", schema(
        ("ckey", Int64), ("name", Utf8)), {
        "ckey": np.arange(40, dtype=np.int64),
        "name": [f"c{i % 5}" for i in range(40)],
    })
    return ctx


_REPLAN_SQL = (
    "SELECT name, COUNT(*) AS n, SUM(amount) AS amt "
    "FROM orders_r JOIN cust_r ON orders_r.ckey = cust_r.ckey "
    "WHERE amount > 100 GROUP BY name ORDER BY name"
)


def _same(a, b):
    assert list(a) == list(b)
    for c in a:
        assert list(a[c]) == list(b[c]), c


def test_replan_builds_no_new_programs():
    """Re-planning (fresh physical operators over the same logical plan)
    hits the governor for every program."""
    ctx = _replan_ctx()
    first = ctx.sql(_REPLAN_SQL).to_pydict()
    ctx._plan_cache.clear()
    before = compile_stats()["programs_built"]
    second = ctx.sql(_REPLAN_SQL).to_pydict()
    assert compile_stats()["programs_built"] == before
    _same(first, second)


def test_governed_entries_do_not_pin_plans():
    """Governed closures capture config-only trace twins, never the live
    operators — else the process-wide cache would pin plan subtrees."""
    ctx = _replan_ctx()
    df = ctx.sql(_REPLAN_SQL)
    df.to_pydict()
    refs = []

    def walk(n):
        refs.append(weakref.ref(n))
        for c in n.children():
            walk(c)

    walk(df.physical_plan())
    assert refs
    del df, ctx
    gc.collect()
    alive = [r() for r in refs if r() is not None]
    assert not alive, [type(a).__name__ for a in alive]


# ---------------------------------------------------------------------------
# masked correctness: bucket padding is row-identical to exact shapes
# ---------------------------------------------------------------------------


def _sweep_ctx() -> BallistaContext:
    ctx = BallistaContext.standalone(device="cpu")
    n = 1337  # deliberately off-rung
    rng = np.random.RandomState(3)
    ctx.register_memtable("fact_s", schema(
        ("id", Int64), ("grp", Utf8), ("dkey", Int64),
        ("amount", Int64)), {
        "id": np.arange(n, dtype=np.int64),
        "grp": [f"g{i % 11}" for i in range(n)],
        "dkey": rng.randint(0, 23, n).astype(np.int64),
        "amount": rng.randint(-50, 1000, n).astype(np.int64),
    })
    ctx.register_memtable("dim_s", schema(
        ("dkey", Int64), ("label", Utf8)), {
        "dkey": np.arange(23, dtype=np.int64),
        "label": [f"l{i % 4}" for i in range(23)],
    })
    return ctx


_SWEEP_SQLS = [
    "SELECT grp, COUNT(*) AS n, SUM(amount) AS s, MIN(amount) AS mn, "
    "MAX(amount) AS mx FROM fact_s GROUP BY grp ORDER BY grp",
    "SELECT COUNT(*) AS n, SUM(amount) AS s FROM fact_s",
    "SELECT label, COUNT(*) AS n, SUM(amount) AS s FROM fact_s "
    "JOIN dim_s ON fact_s.dkey = dim_s.dkey GROUP BY label ORDER BY label",
    "SELECT id, amount FROM fact_s WHERE amount > 500 "
    "ORDER BY amount DESC, id LIMIT 17",
    "SELECT COUNT(*) AS n FROM fact_s WHERE dkey IN "
    "(SELECT dkey FROM dim_s WHERE label = 'l1')",
]


def test_masked_correctness_bucket_on_vs_off(bucket_env):
    got_on = [_sweep_ctx().sql(q).to_pydict() for q in _SWEEP_SQLS]
    bucket_env(**{"": "off"})
    for q, on in zip(_SWEEP_SQLS, got_on):
        _same(on, _sweep_ctx().sql(q).to_pydict())


def test_buckets_off_is_exact_pow2(bucket_env):
    bucket_env(**{"": "off"})
    assert bucket_capacity(10) == 16
    assert bucket_capacity(600) == 1024
    assert bucket_capacity(3) == 8


def test_bucketed_batch_padding_is_dead():
    from ballista_tpu_torch.columnar import ColumnBatch

    s = schema(("a", Int64))
    b = ColumnBatch.from_numpy(s, {"a": np.arange(37, dtype=np.int64)},
                               device="cpu")
    assert b.capacity == bucket_capacity(37)
    assert int(b.num_rows) == 37
    assert list(b.to_pydict()["a"]) == list(range(37))


# ---------------------------------------------------------------------------
# the call signature: one program per dictionary
# ---------------------------------------------------------------------------


def _two_dictionary_ctx():
    """Two tables of one schema whose dictionaries code 'b' differently."""
    ctx = BallistaContext.standalone(device="cpu")
    s = schema(("name", Utf8), ("v", Int64))
    ctx.register_memtable("ta", s, {"name": ["a", "b", "c", "b"],
                                    "v": np.array([1, 2, 3, 4])})
    ctx.register_memtable("tb", s, {"name": ["b", "z", "b", "y"],
                                    "v": np.array([10, 20, 30, 40])})
    return ctx


def _two_dictionary_runs(ctx):
    sql = "SELECT v FROM {} WHERE name = 'b'"
    return [sorted(ctx.sql(sql.format(t)).to_pydict()["v"].tolist())
            for t in ("ta", "tb", "ta")]


def test_two_dictionaries_give_two_programs_and_the_right_codes():
    """'b' is code 1 in ta and code 0 in tb: one filter signature, two
    call signatures, so two programs under one entry."""
    governor().clear("pipeline.fused")
    ctx = _two_dictionary_ctx()
    assert _two_dictionary_runs(ctx) == [[2, 4], [10, 30], [2, 4]]
    space = governor()._spaces["pipeline.fused"]
    assert len(space) == 1  # one entry: the two filters are one signature
    (entry,) = space.values()
    assert len(entry.programs) == 2


def test_two_dictionaries_replay_the_right_codes(graphs):
    """The same on the graph path: a graph replayed for the other table's
    dictionary would select the wrong rows."""
    ctx = _two_dictionary_ctx()
    replays = compile_stats()["graph_replays"]
    assert _two_dictionary_runs(ctx) == [[2, 4], [10, 30], [2, 4]]
    assert compile_stats()["graph_replays"] > replays


# ---------------------------------------------------------------------------
# compact_perm: sync-free, equal to the nonzero-based version and to JAX
# ---------------------------------------------------------------------------


def _old_compact_perm(selection, size):
    """The nonzero-based version it replaced (reads the count back)."""
    idx = torch.nonzero(selection, as_tuple=True)[0][:size]
    out = torch.zeros((size,), dtype=torch.int64)
    out[: idx.shape[0]] = idx
    return out.to(torch.int32)


@pytest.mark.parametrize("mask,sizes", [
    ("seeded", (8, 100, 300, 1024, 4096)),
    ("all_dead", (8, 1024)),
    ("all_live", (8, 512, 1024, 2048)),
])
def test_compact_perm_equals_nonzero(mask, sizes):
    n = 1024
    if mask == "seeded":
        sel = np.random.default_rng(11).random(n) < 0.3  # ~300 live
    else:
        sel = np.full(n, mask == "all_live")
    t = torch.from_numpy(sel)
    for size in sizes:  # below, at and above the live count
        got = compact_perm(t, size)
        assert got.dtype == torch.int32
        assert torch.equal(got, _old_compact_perm(t, size)), size
        want = np.asarray(jnp.nonzero(jnp.asarray(sel), size=size,
                                      fill_value=0)[0])
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


# ---------------------------------------------------------------------------
# the graph path, on the CPU
# ---------------------------------------------------------------------------


def test_graph_path_captures_once_and_replays(graphs):
    fn = governed(("sort.run", "test.graph"),
                  lambda: (lambda b, k: (b * 2 + k, b.sum())))
    st = compile_stats()
    first = fn(torch.arange(8), torch.tensor(1))
    second = fn(torch.arange(8) + 10, torch.tensor(2))
    st2 = compile_stats()
    assert st2["graph_captures"] == st["graph_captures"] + 1
    assert st2["graph_replays"] == st["graph_replays"] + 1
    # the first result is the warm-up's and survives the replay
    assert first[0].tolist() == [2 * i + 1 for i in range(8)]
    assert second[0].tolist() == [2 * (i + 10) + 2 for i in range(8)]
    assert int(first[1]) == 28 and int(second[1]) == 108


def test_graph_outputs_survive_later_replays(graphs):
    """Several outputs of one entry alive at once (q5's partial
    aggregates, q3's partitioned probes): each is the caller's copy."""
    fn = governed(("sort.run", "test.keep"), lambda: (lambda b: b + 1))
    outs = [fn(torch.full((4,), i)) for i in range(5)]
    assert [o.tolist() for o in outs] == [[i + 1] * 4 for i in range(5)]


def test_graph_passes_an_input_through_as_the_callers_tensor(graphs):
    fn = governed(("sort.run", "test.alias"), lambda: (lambda a, b: (a, b + 1)))
    fn(torch.arange(4), torch.arange(4))
    x = torch.arange(4) * 5
    a, b = fn(x, torch.arange(4))
    assert a is x and b.tolist() == [1, 2, 3, 4]


def test_replay_hooks_run_once_per_replay(graphs):
    seen = []

    def build():
        def run(x):
            if gov.capturing():
                gov.on_replay(lambda: seen.append(1))
            return x + 1
        return run

    fn = governed(("sort.run", "test.hooks"), build)
    for i in range(4):
        fn(torch.arange(3))
    assert len(seen) == 3  # the first call warms up and captures


def test_constants_reach_the_graph_through_the_arena(graphs):
    table = np.array([5, 6, 7], np.int64)

    def build():
        return lambda x: gov.device_constant(table, x.device)[x]

    fn = governed(("sort.run", "test.const"), build)
    assert fn(torch.tensor([2, 0])).tolist() == [7, 5]
    assert fn(torch.tensor([1, 1])).tolist() == [6, 6]


def test_a_failed_capture_raises(graphs):
    fn = governed(("sort.run", "test.fail"),
                  lambda: (lambda x: x[: int(x.sum())]))
    with pytest.raises(gov.CaptureError):
        fn(torch.arange(3))


def test_namespaces_outside_the_table_stay_eager(graphs):
    fn = governed(("test.eager", "x"), lambda: (lambda x: x + int(x.sum())))
    st = compile_stats()["graph_captures"]
    assert fn(torch.arange(3)).tolist() == [3, 4, 5]
    assert compile_stats()["graph_captures"] == st


def test_sweep_queries_are_capturable_and_replay_right():
    """Every program of the sweep queries holds no host read or upload,
    and on the graph path their warm (replayed) results equal eager."""
    eager = [_sweep_ctx().sql(q).to_pydict() for q in _SWEEP_SQLS]
    with simulated_capture():
        for q, want in zip(_SWEEP_SQLS, eager):
            _same(_sweep_ctx().sql(q).to_pydict(), want)


def test_sweep_queries_on_the_graph_path(graphs):
    eager_ctx = _sweep_ctx()
    for q in _SWEEP_SQLS:
        df = _sweep_ctx().sql(q)
        cold, warm = df.to_pydict(), df.to_pydict()
        want = eager_ctx.sql(q).to_pydict()
        _same(cold, want)
        _same(warm, want)


# ---------------------------------------------------------------------------
# warm(): the prewarm pass's first call
# ---------------------------------------------------------------------------


def _warm_then_call(device):
    """warm() builds the signature's program (counted as a prewarm, not a
    first call); the real call of the same signature replays it, a
    second warm() is a no-op."""
    fn = governed(("sort.run", f"test.warm.{device}"),
                  lambda: (lambda x: (x * 7 - 3, x.sum())))
    x = torch.arange(1 << 12, device=device)
    before = compile_stats()
    assert fn.warm(torch.zeros_like(x)) is True
    mid = compile_stats()
    assert mid["prewarm_compiles"] == before["prewarm_compiles"] + 1
    for k in ("graph_captures", "programs_built", "first_call_seconds"):
        assert mid[k] == before[k], k
    out, total = fn(x)
    assert torch.equal(out, x * 7 - 3) and int(total) == int(x.sum())
    assert fn.warm(torch.zeros_like(x)) is False
    end = compile_stats()
    assert end["graph_captures"] == before["graph_captures"]
    assert end["graph_replays"] == mid["graph_replays"] + 1
    assert end["prewarm_compiles"] == mid["prewarm_compiles"]


def test_warm_then_call_replays_on_the_graph_path(monkeypatch):
    with emulated_graphs(monkeypatch):
        _warm_then_call("cpu")


def test_warm_without_keep_runs_the_warm_up_only(monkeypatch):
    """warm(keep=False) runs the program once (its warm-up) and keeps no
    program: it counts as a prewarm, the real call of the same signature
    then warms up and captures it itself."""
    ran = []

    def build():
        def f(x):
            ran.append(int(x.shape[0]))
            return x - 1
        return f

    with emulated_graphs(monkeypatch):
        fn = governed(("sort.run", "test.warm.nokeep"), build)
        x = torch.arange(256)
        before = compile_stats()
        assert fn.warm(torch.zeros_like(x), keep=False) is True
        mid = compile_stats()
        assert ran == [256] and not fn.programs
        assert mid["prewarm_compiles"] == before["prewarm_compiles"] + 1
        for k in ("graph_captures", "programs_built", "first_call_seconds"):
            assert mid[k] == before[k], k
        assert torch.equal(fn(x), x - 1)
        end = compile_stats()
        assert len(fn.programs) == 1
        assert end["graph_captures"] == mid["graph_captures"] + 1


def test_first_call_waits_for_a_warm_of_its_signature(monkeypatch):
    """A real first call that arrives while the prewarm thread captures
    its signature waits on the capture lock (the wait is counted) and
    replays that capture instead of capturing again."""
    started, release = threading.Event(), threading.Event()

    def build():
        def f(x):
            if not release.is_set():
                started.set()
                release.wait(10)
            return x + 1
        return f

    with emulated_graphs(monkeypatch):
        fn = governed(("sort.run", "test.warm.race"), build)
        x = torch.arange(64)
        before = compile_stats()
        warm = threading.Thread(target=fn.warm, args=(torch.zeros_like(x),))
        warm.start()
        assert started.wait(10)
        box = {}
        call = threading.Thread(target=lambda: box.update(out=fn(x)))
        call.start()
        call.join(0.2)
        assert call.is_alive()  # waiting on the warm's capture
        release.set()
        warm.join(10)
        call.join(10)
        assert torch.equal(box["out"], x + 1)
        st = compile_stats()
        assert st["prewarm_compiles"] == before["prewarm_compiles"] + 1
        assert st["graph_captures"] == before["graph_captures"]
        assert st["graph_replays"] == before["graph_replays"] + 1
        assert st["capture_lock_wait_seconds"] > \
            before["capture_lock_wait_seconds"]


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode "
                    "(python3 -m ballista_tpu_torch.testing.card_checks)")


def test_cuda_graph_outputs_survive_later_replays():
    _needs_card()
    fn = governed(("sort.run", "test.cuda.keep"),
                  lambda: (lambda b: (b * 3 + 1, b.sum())))
    before = compile_stats()
    outs = [fn(torch.full((1 << 16,), i, device="cuda")) for i in range(6)]
    torch.cuda.synchronize()
    st = compile_stats()
    assert st["graph_captures"] == before["graph_captures"] + 1
    assert st["graph_replays"] == before["graph_replays"] + 5
    for i, (v, s) in enumerate(outs):
        assert torch.equal(v.cpu(), torch.full((1 << 16,), 3 * i + 1))
        assert int(s) == i * (1 << 16)


def test_cuda_dense_sums_inside_a_graph_counts_and_observes_replays():
    _needs_card()
    from ballista_tpu_torch.kernels import dense_sums as ds

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    n, g = 100_003, 6

    def inputs(seed):
        r = np.random.default_rng(seed)
        return (torch.from_numpy(r.integers(0, g, n, dtype=np.int32)).to(dev),
                torch.from_numpy(r.random(n) < 0.9).to(dev),
                torch.from_numpy(r.integers(0, 1000, n)).to(dev))

    fn = governed(("agg.grouped", "test.cuda.kernel"),
                  lambda: (lambda gids, live, v: ds.dense_grouped_sums(
                      gids, live, [v], g)))
    seen = []

    def observer(gids, live, values, num_groups, sums, counts, first):
        seen.append((gids.clone(), live.clone(), [values[0].clone()],
                     num_groups, sums[0].clone(), counts.clone(),
                     first.clone()))

    with ds.observe(observer):
        before = ds.launch_count
        results = [fn(*inputs(s)) for s in range(4)]
        torch.cuda.synchronize()
        # the warm-up launches, the capture launches nothing, each of the
        # three replays launches once
        assert ds.launch_count == before + 4
    assert len(seen) == 4
    for (gids, live, values, ng, sums, counts, first), res in zip(seen,
                                                                  results):
        want = ds.dense_grouped_sums_reference(gids, live, values, ng)
        assert torch.equal(sums, want[0][0]) and torch.equal(res[0][0],
                                                             want[0][0])
        assert torch.equal(counts, want[1]) and torch.equal(first, want[2])
    del rng


def test_cuda_kernel_first_call_inside_a_capture():
    """The kernel's first call of a shape may come inside a capture: its
    launch plan (occupancy queries) and SM count are computed there."""
    _needs_card()
    from ballista_tpu_torch.kernels import dense_sums as ds

    dev = torch.device("cuda")
    r = np.random.default_rng(4)
    n, g = 77_777, 26
    gids = torch.from_numpy(r.integers(0, g, n, dtype=np.int32)).to(dev)
    live = torch.from_numpy(r.random(n) < 0.8).to(dev)
    vals = [torch.from_numpy(r.integers(-50, 50, n)).to(dev)]
    ds.build()
    for cached in (ds._plan, ds._replicas, ds._sm_count):
        cached.cache_clear()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    hooks = []
    before = ds.launch_count
    with gov._CaptureScope({}, hooks), torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            sums, counts, first = ds.dense_grouped_sums(gids, live, vals, g)
        finally:
            graph.capture_end()
    assert ds.launch_count == before and len(hooks) == 1
    graph.replay()
    for hook in hooks:
        hook()
    torch.cuda.synchronize()
    assert ds.launch_count == before + 1
    want = ds.dense_grouped_sums_reference(gids, live, vals, g)
    assert torch.equal(sums[0], want[0][0])
    assert torch.equal(counts, want[1]) and torch.equal(first, want[2])


def test_cuda_concurrent_replays_keep_their_outputs():
    """Partitions replay programs from ingest-pool threads at once.
    Graphs share their card's pool, so one graph's internals may lie
    where another's static outputs are: each replay's outputs must be
    copied out before another thread's replay is queued."""
    _needs_card()

    def f_p(x):
        return ((x * 3 + 1) * 5 - 7) * 2

    def f_q(y):
        return (y + 11) * 13

    p = governed(("sort.run", "test.cuda.concurrent_p"), lambda: f_p)
    q = governed(("sort.run", "test.cuda.concurrent_q"), lambda: f_q)
    xs = [torch.arange(1 << 20, device="cuda") + i for i in range(8)]
    for fn in (p, q):  # warm-up and capture, one thread
        fn(xs[0])
        fn(xs[0])
    bad = []

    def hammer(fn, want):
        for i in range(300):
            x = xs[i % len(xs)]
            if not torch.equal(fn(x), want(x)):
                bad.append((fn, i))

    threads = [threading.Thread(target=hammer, args=(p, f_p)),
               threading.Thread(target=hammer, args=(q, f_q))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads), (
        "test_cuda_concurrent_replays_keep_their_outputs: a thread did not "
        "end within 120 s")
    assert not bad, f"{len(bad)} replays returned another graph's data"


def test_cuda_capture_after_every_program_was_dropped():
    """Clearing the governor drops every graph in the card's pool; a later
    capture into the same pool must still work (the pool's anchor graph
    keeps torch's allocator from marking it freeable)."""
    _needs_card()
    fn = governed(("sort.run", "test.cuda.before_clear"),
                  lambda: (lambda x: x * 2 + 1))
    x = torch.arange(1 << 12, device="cuda")
    for _ in range(2):
        assert torch.equal(fn(x), x * 2 + 1)
    governor().clear()
    del fn
    gc.collect()
    again = governed(("sort.run", "test.cuda.after_clear"),
                     lambda: (lambda x: x * 5 - 2))
    before = compile_stats()["graph_captures"]
    for _ in range(2):
        assert torch.equal(again(x), x * 5 - 2)
    assert compile_stats()["graph_captures"] == before + 1


def test_cuda_warm_then_call_replays():
    """The prewarm pass's warm() on the card: warm-up and capture off the
    query's first-call count, then the real call replays."""
    _needs_card()
    _warm_then_call("cuda")
