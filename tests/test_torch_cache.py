"""Warm-path caches of the port (ballista_tpu_torch/cache): the tests of
tests/test_cache.py on the port, on the CPU, and the port's own.

The three tiers share ONE invalidation signal — file signatures are
re-stat'd at lookup and plan fingerprints ride ``compile_signature`` —
so a changed file is never served stale, every tier is identical on vs
off (and equal to the JAX package), donation never changes results, and
a starved budget degrades to plain re-ingest. Torch tensors are mutable,
so the port adds: no query writes into a tensor the table cache pins, a
table whose directory gains a file misses, a hit served to a second
context is right, a donated batch raises on a second read, and a warm
collect served from the cache replays graphs without capturing.
"""


import numpy as np
import pytest
import torch

from ballista_tpu_torch import Float64, Int64, Utf8, schema
from ballista_tpu_torch.cache import (cache_counters, mark_transient,
                                      reset_cache_stats)
from ballista_tpu_torch.cache import residency
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.columnar import Column, ColumnBatch
from ballista_tpu_torch.compile import compile_stats, governed
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.physical.base import donating_call
from ballista_tpu_torch.testing.capture_check import emulated_graphs

from torch_warm_path import (WARM_QUERIES, assert_equals_reference,
                             assert_identical, generate_tpch,
                             pinned_fingerprints, pinned_threads, port_ctx,
                             reference_result, reset_port_caches,
                             scanned_partitions, sql)


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """Two torch, ingest and scanner threads for this file's queries
    (``torch_warm_path.pinned_threads``)."""
    with pinned_threads():
        yield


ALL_QUERIES = [f"q{i}" for i in range(1, 23)]


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("torch_cache_tpch")))


@pytest.fixture(autouse=True)
def _fresh_tiers():
    """Every test starts and ends with empty tiers and released budget."""
    reset_port_caches()
    yield
    reset_port_caches()


# -- invalidation: a changed file is never served stale ---------------------


def _write_kv(path, rows):
    with open(path, "w") as f:
        f.write("k,v\n")
        for k, v in rows:
            f.write(f"{k},{v}\n")


def _kv_ctx(path, **settings):
    ctx = BallistaContext.standalone(device="cpu", **settings)
    ctx.register_csv("kv", str(path), schema(("k", Int64), ("v", Float64)))
    return ctx


def test_table_cache_rewrite_mid_session_misses(tmp_path):
    """File rewrite between two collects of the SAME session: the second
    scan must re-read (the signature mints a new key)."""
    path = tmp_path / "kv.csv"
    _write_kv(path, [(1, 10.0), (2, 20.0)])
    df = _kv_ctx(path).sql("SELECT SUM(v) AS s FROM kv")
    assert float(df.to_pydict()["s"][0]) == 30.0
    assert residency.process_table_cache().stats()["fills"] >= 1

    _write_kv(path, [(1, 10.0), (2, 20.0), (3, 70.0)])
    assert float(df.to_pydict()["s"][0]) == 100.0  # append seen

    _write_kv(path, [(1, 1.5)])
    assert float(df.to_pydict()["s"][0]) == 1.5  # rewrite seen


def test_result_cache_file_change_mid_session_misses(tmp_path):
    """The result tier re-stats source files at lookup: a hit is only
    legal while every input file signature still matches."""
    path = tmp_path / "kv.csv"
    _write_kv(path, [(1, 2.0), (2, 3.0)])
    df = _kv_ctx(path, **{"result_cache.enabled": "on"}).sql(
        "SELECT SUM(v) AS s FROM kv")

    reset_cache_stats()
    first = df.to_pydict()
    again = df.to_pydict()
    assert cache_counters()["result_cache_hits"] == 1
    assert_identical(first, again)
    assert df.ctx.cache_hits["result"] == 1

    _write_kv(path, [(1, 2.0), (2, 3.0), (3, 5.0)])
    changed = df.to_pydict()
    assert cache_counters()["result_cache_hits"] == 1  # no stale hit
    assert float(changed["s"][0]) == 10.0


def test_result_cache_keys_the_whole_plan(tpch_dir):
    """Two plans whose roots are alike and whose filters differ below the
    root must not share a result."""
    ctx = port_ctx(tpch_dir, **{"result_cache.enabled": "on"})
    q = ("SELECT l_returnflag, count(*) AS n FROM lineitem "
         "WHERE l_quantity < {} GROUP BY l_returnflag ORDER BY l_returnflag")
    small = ctx.sql(q.format(10)).to_pydict()
    large = ctx.sql(q.format(40)).to_pydict()
    assert cache_counters()["result_cache_hits"] == 0
    assert large["n"].sum() > small["n"].sum()


# -- identity: every tier on vs off, == the JAX package ---------------------


def _caches(monkeypatch, setting):
    for knob in ("BALLISTA_TABLE_CACHE", "BALLISTA_DONATION",
                 "BALLISTA_RESULT_CACHE"):
        monkeypatch.setenv(knob, setting)


@pytest.mark.parametrize("q", WARM_QUERIES)
def test_identity_standalone_caches_on_vs_off(tpch_dir, monkeypatch, q):
    _caches(monkeypatch, "off")
    baseline = port_ctx(tpch_dir).sql(sql(q)).to_pydict()
    assert residency.process_table_cache().stats()["entries"] == 0

    _caches(monkeypatch, "on")
    reset_port_caches()
    df = port_ctx(tpch_dir).sql(sql(q))
    cold = df.to_pydict()   # fills the table (and result) tiers
    warm = df.to_pydict()   # result-cache hit path
    assert cache_counters()["result_cache_hits"] == 1
    monkeypatch.setenv("BALLISTA_RESULT_CACHE", "off")
    table_warm = df.to_pydict()  # table-cache hit path
    assert df.ctx.cache_hits["table"] == scanned_partitions(
        df.physical_plan())
    for got, tag in ((cold, "cold"), (warm, "warm"),
                     (table_warm, "table-cache warm")):
        assert_identical(baseline, got, f"{q} {tag}")
    assert_equals_reference(baseline, reference_result(tpch_dir, q))


def _donations(run) -> tuple:
    reset_cache_stats()
    out = run()
    return out, cache_counters()["donated_buffers"]


@pytest.mark.parametrize("table_cache", ["on", "off"])
@pytest.mark.parametrize("q", WARM_QUERIES)
def test_donation_on_off_identity_and_counter(tpch_dir, monkeypatch, q,
                                              table_cache):
    """Donation changes no result, and donates on the same collects as
    the JAX package, as often."""
    from ballista_tpu.cache import cache_counters as ref_counters
    from ballista_tpu.cache import reset_cache_stats as ref_reset
    from ballista_tpu.cache.residency import _reset_for_tests as ref_empty

    monkeypatch.setenv("BALLISTA_TABLE_CACHE", table_cache)
    monkeypatch.setenv("BALLISTA_DONATION", "off")
    base, n = _donations(lambda: port_ctx(tpch_dir).sql(sql(q)).to_pydict())
    assert n == 0

    monkeypatch.setenv("BALLISTA_DONATION", "on")
    reset_port_caches()
    donated, n_port = _donations(
        lambda: port_ctx(tpch_dir).sql(sql(q)).to_pydict())
    assert_identical(base, donated, q)

    ref_empty()
    ref_reset()
    want = reference_result(tpch_dir, q)
    n_ref = ref_counters()["donated_buffers"]
    ref_empty()
    assert_equals_reference(donated, want)
    assert n_port == n_ref, (n_port, n_ref)
    if table_cache == "off":  # every scan batch is transient then
        assert n_port > 0


# -- budget pressure degrades, never fails ----------------------------------


def _kb_batch(kb: int) -> ColumnBatch:
    """A CPU batch of about ``kb`` KiB of int64 values."""
    n = (kb << 10) // 8
    return ColumnBatch.from_numpy(schema(("a", Int64)),
                                  {"a": np.zeros(n, np.int64)}, capacity=n,
                                  device="cpu")


def test_governor_eviction_lru_and_dead_fill(monkeypatch):
    """Coldest-first eviction makes room, an entry that cannot fit even
    after evicting everything dies cleanly (refusal, zero residue), and
    accounting returns to zero."""
    monkeypatch.setenv("BALLISTA_TABLE_CACHE_BUDGET_MB", "1")
    monkeypatch.setenv("BALLISTA_TABLE_CACHE_WATERMARK", "1.0")
    cache = residency.DeviceTableCache()

    fa = cache.begin_fill(("t", "a"))
    assert fa.add(_kb_batch(500)) and fa.commit()
    fb = cache.begin_fill(("t", "b"))
    assert fb.add(_kb_batch(500)) and fb.commit()  # evicts a (coldest)
    assert cache.stats()["evictions"] == 1
    assert not cache.contains(("t", "a"))
    assert cache.contains(("t", "b"))

    fc = cache.begin_fill(("t", "c"))
    assert fc.add(_kb_batch(2048)) is False  # dead: larger than budget
    assert not fc.commit()
    assert cache.stats()["refusals"] >= 1
    assert not cache.contains(("t", "c"))

    cache.invalidate()
    assert cache.governor.resident_bytes == 0


def _meta_batch(kb: int) -> ColumnBatch:
    """A batch of about ``kb`` KiB of int64 values on the ``meta``
    device: a second device key on a machine without a card."""
    n = (kb << 10) // 8
    return ColumnBatch(
        schema(("a", Int64)),
        [Column(torch.empty(n, dtype=torch.int64, device="meta"), Int64)],
        torch.empty(n, dtype=torch.bool, device="meta"),
        torch.empty((), dtype=torch.int32, device="meta"))


def test_budget_per_device(monkeypatch):
    """Each device has its own budget: filling the cache past the budget
    on the CPU evicts only CPU entries, and an entry resident on another
    device stays; the stats break the bytes down per device."""
    monkeypatch.setenv("BALLISTA_TABLE_CACHE_BUDGET_MB", "1")
    monkeypatch.setenv("BALLISTA_TABLE_CACHE_WATERMARK", "1.0")
    cache = residency.DeviceTableCache()

    fm = cache.begin_fill(("meta", "m"))
    assert fm.add(_meta_batch(700)) and fm.commit()
    for i in range(4):  # two of these fit the CPU's 1 MiB budget
        f = cache.begin_fill(("cpu", i))
        assert f.add(_kb_batch(400)) and f.commit()
    stats = cache.stats()
    assert cache.contains(("meta", "m"))
    assert stats["evictions"] == 2  # CPU entries 0 and 1, coldest first
    assert not cache.contains(("cpu", 0)) and not cache.contains(("cpu", 1))
    assert cache.contains(("cpu", 2)) and cache.contains(("cpu", 3))
    meta, cpu = stats["per_device"]["meta"], stats["per_device"]["cpu"]
    assert meta["resident_bytes"] == residency.batch_device_bytes(
        _meta_batch(700))
    assert cpu["resident_bytes"] == 2 * residency.batch_device_bytes(
        _kb_batch(400))
    assert stats["resident_bytes"] == (meta["resident_bytes"]
                                       + cpu["resident_bytes"])
    # a CPU fill larger than the budget dies without touching the meta
    # entry
    f = cache.begin_fill(("cpu", "big"))
    assert f.add(_kb_batch(2048)) is False
    assert cache.contains(("meta", "m"))
    assert cache.stats()["per_device"]["cpu"]["resident_bytes"] == 0
    cache.invalidate()
    assert cache.governor.resident_bytes == 0


def test_starved_budget_degrades_to_reingest(tpch_dir, monkeypatch):
    """A watermark so low every fill is refused leaves queries correct
    and unpinned — re-ingest, never an error."""
    baseline = port_ctx(tpch_dir).sql(sql("q1")).to_pydict()

    monkeypatch.setenv("BALLISTA_TABLE_CACHE_BUDGET_MB", "1")
    monkeypatch.setenv("BALLISTA_TABLE_CACHE_WATERMARK", "0.01")
    reset_port_caches()
    df = port_ctx(tpch_dir).sql(sql("q1"))
    assert_identical(baseline, df.to_pydict(), "starved")
    assert_identical(baseline, df.to_pydict(), "starved again")
    stats = residency.process_table_cache().stats()
    assert stats["refusals"] > 0 or stats["evictions"] > 0
    assert stats["resident_bytes"] <= int(0.01 * (1 << 20))
    assert stats["hits"] == 0


# -- the port's own ------------------------------------------------------------


def test_cached_tensors_unchanged_by_the_22_queries(tpch_dir):
    """No query writes into a tensor the table cache pins: each pinned
    tensor's ``_version`` and checksum are the same after every later
    query, cold and warm, as when it was filled."""
    ctx = port_ctx(tpch_dir)
    seen = {}
    for rnd in ("cold", "warm"):
        for q in ALL_QUERIES:
            ctx.sql(sql(q)).to_pydict()
            now = pinned_fingerprints()
            for key, (t, fp) in seen.items():
                assert key in now, f"{q} {rnd}: a pinned tensor was evicted"
                assert now[key][1] == fp, f"{q} {rnd} modified a pinned tensor"
            for key, entry in now.items():
                seen.setdefault(key, entry)
    stats = residency.process_table_cache().stats()
    assert stats["evictions"] == 0 and stats["hits"] > 0, stats


def _write_part(path, rows):
    with open(path, "w") as f:
        f.writelines(f"{k}|{s}|\n" for k, s in rows)


def test_table_gaining_a_file_misses(tmp_path):
    """A table's dictionaries come from all its files: a file added to its
    directory must change every partition's key, or a new source would
    be served codes of the old dictionary."""
    sch = schema(("k", Int64), ("s", Utf8))
    d = tmp_path / "t"
    d.mkdir()
    _write_part(d / "part0.tbl", [(1, "b"), (2, "d")])
    _write_part(d / "part1.tbl", [(3, "f")])
    q = "SELECT s, sum(k) AS n FROM t GROUP BY s ORDER BY s"

    def run():
        ctx = BallistaContext.standalone(device="cpu")
        ctx.register_tbl("t", str(d), sch)
        return ctx.sql(q).to_pydict()

    first = run()
    assert list(first["s"]) == ["b", "d", "f"]
    fills = residency.process_table_cache().stats()["fills"]
    _write_part(d / "part2.tbl", [(4, "a"), (5, "e")])
    reset_cache_stats()
    grown = run()
    stats = residency.process_table_cache().stats()
    assert stats["hits"] == 0 and stats["fills"] == 3, (fills, stats)
    assert list(grown["s"]) == ["a", "b", "d", "e", "f"]
    assert list(grown["n"]) == [4, 1, 2, 5, 3]


@pytest.mark.parametrize("q", ["q5", "q16"])
def test_hit_served_to_a_second_context(tpch_dir, q):
    """A second context over the same files is served every scan from the
    first context's entries, with its own (equal) dictionaries, and
    returns the JAX package's result."""
    port_ctx(tpch_dir).sql(sql(q)).to_pydict()
    reset_cache_stats()
    df = port_ctx(tpch_dir).sql(sql(q))
    got = df.to_pydict()
    stats = residency.process_table_cache().stats()
    assert stats["fills"] == 0
    assert stats["hits"] == scanned_partitions(df.physical_plan())
    assert_equals_reference(got, reference_result(tpch_dir, q))


def _double(b):
    return b.columns[0].values[:3] * 2


def test_donated_batch_raises_on_a_second_read():
    sch = schema(("a", Int64))
    fn = governed(("sort.run", "test.donation.eager"), lambda: _double)
    kept = ColumnBatch.from_pydict(sch, {"a": [1, 2, 3]}, device="cpu")
    reset_cache_stats()
    assert torch.equal(donating_call(fn, kept), torch.tensor([2, 4, 6]))
    assert kept.columns[0].values[:3].tolist() == [1, 2, 3]  # kept
    assert cache_counters()["donated_buffers"] == 0

    b = ColumnBatch.from_pydict(sch, {"a": [1, 2, 3]}, device="cpu")
    mark_transient(b)
    nbytes = b.payload_nbytes()
    assert torch.equal(donating_call(fn, b), torch.tensor([2, 4, 6]))
    assert b.donated
    with pytest.raises(ExecutionError, match="donated"):
        b.columns
    with pytest.raises(ExecutionError, match="donated"):
        donating_call(fn, b)  # the claim is spent, the read raises
    cc = cache_counters()
    assert cc["donated_buffers"] == 1 and cc["donated_bytes"] == nbytes


def test_donation_on_the_graph_path(monkeypatch):
    """Under emulated CUDA graphs: a replay with a donated batch gives the
    same result as without, and the batch is empty after it."""
    sch = schema(("a", Int64))
    with emulated_graphs(monkeypatch):
        fn = governed(("sort.run", "test.donation.graph"), lambda: _double)
        outs = []
        for i in range(3):  # capture, then two replays
            b = ColumnBatch.from_pydict(sch, {"a": [i, i + 1, 0]},
                                        device="cpu")
            mark_transient(b)
            outs.append(donating_call(fn, b))
            assert b.donated
        assert [o.tolist() for o in outs] == [[0, 2, 0], [2, 4, 0],
                                              [4, 6, 0]]


@pytest.mark.parametrize("q", WARM_QUERIES)
def test_warm_collect_from_the_cache_replays_only(tpch_dir, monkeypatch, q):
    """Under emulated CUDA graphs a warm collect served from the table
    cache replays and captures nothing; so does a second context's first
    collect, whose scans all hit (it adopts the cached batches'
    dictionaries, which the graphs' signatures hold)."""
    with emulated_graphs(monkeypatch):
        df = port_ctx(tpch_dir).sql(sql(q))
        cold = df.to_pydict()
        runs = {}
        for tag, frame in (("warm", df),
                           ("second context", port_ctx(tpch_dir).sql(sql(q)))):
            reset_cache_stats()
            st0 = compile_stats()
            got = frame.to_pydict()
            st1 = compile_stats()
            stats = residency.process_table_cache().stats()
            runs[tag] = (st1["graph_captures"] - st0["graph_captures"],
                         st1["graph_replays"] - st0["graph_replays"])
            assert stats["fills"] == 0, (tag, stats)
            assert stats["hits"] == scanned_partitions(
                frame.physical_plan()), (tag, stats)
            assert_identical(cold, got, f"{q} {tag}")
        for tag, (captures, replays) in runs.items():
            assert captures == 0 and replays > 0, (tag, runs)
