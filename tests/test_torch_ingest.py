"""Pipelined parallel ingest of the port (ballista_tpu_torch/ingest): the
nine tests of tests/test_ingest.py on the port, on the CPU, and two
card-only tests of the asynchronous pinned uploads.

The pipeline reorders TIMING, never rows: TPC-H results must be
byte-identical with the pipeline ON vs OFF and at any thread count, and
equal to the JAX package on the same SF0.002 data (integer, decimal,
date and string columns exactly, floats within rtol 1e-6). The
``test_cuda_*`` tests need a card and skip here
(``python3 -m ballista_tpu_torch.testing.card_checks`` runs them).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from ballista_tpu_torch import Int64, Utf8, schema
from ballista_tpu_torch import ingest
from ballista_tpu_torch.cache import residency
from ballista_tpu_torch.columnar import ColumnBatch
from ballista_tpu_torch.logical import TableSource
from ballista_tpu_torch.physical.operators import ScanExec

from torch_warm_path import (WARM_QUERIES, assert_equals_reference,
                             assert_identical, generate_tpch, pinned_threads,
                             port_ctx, reference_result, reset_port_caches,
                             scan_nodes, sql)


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """Two torch, ingest and scanner threads for this file's queries
    (``torch_warm_path.pinned_threads``)."""
    with pinned_threads():
        yield


def _configure(monkeypatch, threads, prefetch):
    monkeypatch.setenv("BALLISTA_INGEST_THREADS", str(threads))
    monkeypatch.setenv("BALLISTA_PREFETCH_BATCHES", str(prefetch))
    ingest.reconfigure()


@pytest.fixture(autouse=True)
def _restore_ingest_config(monkeypatch):
    """Every test starts with empty port caches and leaves the process
    with env-default ingest config."""
    reset_port_caches()
    yield
    monkeypatch.undo()
    ingest.reconfigure()
    reset_port_caches()


# ---------------------------------------------------------------------------
# determinism sweep: pipeline ON vs OFF, 1 vs 4 threads, == the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("torch_ingest_tpch")))


def _run(data_dir, q):
    """(result, prefetched batches) of one cold collect."""
    reset_port_caches()  # every run parses: the pipeline has work
    df = port_ctx(data_dir).sql(sql(q))
    out = df.to_pydict()
    prefetched = sum(s.metrics().values().get("prefetched_batches", 0)
                     for s in scan_nodes(df.physical_plan()))
    return out, prefetched


@pytest.mark.parametrize("q", WARM_QUERIES)
def test_determinism_pipeline_on_off(tpch_dir, monkeypatch, q):
    _configure(monkeypatch, 1, 0)  # serial baseline (pipeline OFF)
    base, prefetched = _run(tpch_dir, q)
    assert prefetched == 0
    for threads in (1, 4):
        _configure(monkeypatch, threads, 2)
        got, prefetched = _run(tpch_dir, q)
        assert prefetched > 0, "the pipeline did not run"
        assert_identical(base, got, f"{q}[threads={threads}]")
    assert_equals_reference(base, reference_result(tpch_dir, q))


# ---------------------------------------------------------------------------
# bounded memory: the prefetch queue never exceeds its configured depth
# ---------------------------------------------------------------------------


def _write_tbl(tmp_path, rows=1024):
    p = tmp_path / "t.tbl"
    p.write_text("".join(f"{i}|k{i % 13}|\n" for i in range(rows)))
    return str(p)


SCHEMA = schema(("a", Int64), ("c", Utf8))


def _tbl(path, **kw):
    from ballista_tpu_torch.io import TblSource

    return TblSource(path, SCHEMA, device="cpu", **kw)


def test_prefetch_queue_bounded(tmp_path, monkeypatch):
    """A slow consumer must cap the producer at the configured depth."""
    _configure(monkeypatch, 2, 2)
    from ballista_tpu_torch.ingest import PrefetchHandle, prefetch_batches

    assert prefetch_batches() == 2
    src = _tbl(_write_tbl(tmp_path), batch_capacity=128)
    handle = PrefetchHandle(lambda: src.scan(0), depth=2, label="t[0]")
    got = 0
    for batch in handle:
        time.sleep(0.02)  # consumer slower than the parser
        got += 1
    assert got == 8  # 1024 rows / 128-capacity chunks
    assert handle.max_occupancy <= 2, handle.max_occupancy


def test_prefetch_cancel_stops_producer(tmp_path, monkeypatch):
    """A consumer abandoning the stream early must not leave the producer
    blocked on a full queue, nor a partial table-cache entry."""
    _configure(monkeypatch, 2, 1)
    src = _tbl(_write_tbl(tmp_path), batch_capacity=128)
    scan = ScanExec("t", src)
    it = scan.execute(0)
    next(it)
    it.close()  # abandon: GeneratorExit runs ScanExec's finally
    with scan._primed_lock:
        assert not scan._primed
    from ballista_tpu_torch.ingest import ingest_pool

    # the shared pool must be usable afterwards (producer exited)
    assert ingest_pool().submit(lambda: 42).result(timeout=10) == 42
    deadline = time.monotonic() + 10
    while residency.process_table_cache().governor.resident_bytes and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    stats = residency.process_table_cache().stats()
    assert stats["entries"] == 0 and stats["resident_bytes"] == 0, stats


# ---------------------------------------------------------------------------
# cross-table overlap: primed scans parse CONCURRENTLY
# ---------------------------------------------------------------------------


def test_primed_scans_parse_concurrently(monkeypatch):
    """Two primed leaf scans rendezvous at a barrier inside their scan
    bodies: only concurrent producers can both arrive."""
    _configure(monkeypatch, 2, 1)
    barrier = threading.Barrier(2)
    sch = schema(("a", Int64))

    class RendezvousSource(TableSource):
        def table_schema(self):
            return sch

        def num_partitions(self):
            return 1

        def scan(self, partition, projection=None):
            barrier.wait(timeout=30)  # fails the test if run serially
            yield ColumnBatch.from_pydict(sch, {"a": [1, 2, 3]},
                                          device="cpu")

    scans = [ScanExec(f"t{i}", RendezvousSource()) for i in range(2)]
    from ballista_tpu_torch.ingest import prime_plan

    for s in scans:
        assert prime_plan(s) == 1
    for s in scans:
        batches = list(s.execute(0))
        assert int(batches[0].num_rows) == 3


def test_iter_partitions_preserves_order(monkeypatch):
    """Concurrent partition production still yields partition 0's batches
    first, then 1's, ... even when later partitions finish first."""
    _configure(monkeypatch, 4, 2)
    from ballista_tpu_torch.ingest import iter_partitions
    from ballista_tpu_torch.physical.base import Partitioning, PhysicalPlan

    sch = schema(("a", Int64))

    class TaggedPlan(PhysicalPlan):
        def output_schema(self):
            return sch

        def output_partitioning(self):
            return Partitioning("unknown", 3)

        def with_new_children(self, children):
            return self

        def execute(self, partition):
            # later partitions finish FIRST if order were by completion
            time.sleep((3 - partition) * 0.05)
            for chunk in range(2):
                yield ColumnBatch.from_pydict(
                    sch, {"a": [partition * 10 + chunk]}, device="cpu")

    out = [int(b.columns[0].values[0])
           for b in iter_partitions(TaggedPlan(), range(3))]
    assert out == [0, 1, 10, 11, 20, 21]


# ---------------------------------------------------------------------------
# concurrent child partitions: MergeExec, RepartitionExec and the merged
# join's build produce on the pool, identical to the serial loop
# ---------------------------------------------------------------------------


def _part_dir(tmp_path, name, files, rows, line):
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    for f in range(files):
        (d / f"{f}.tbl").write_text("".join(
            line(f * rows + i) for i in range(rows)))
    return str(d)


def _scan(path, sch):
    from ballista_tpu_torch.io import TblSource

    return ScanExec(path, TblSource(path, sch, device="cpu",
                                    batch_capacity=128))


def _operator(kind, tmp_path):
    """A multi-partition operator of ``kind`` over 4 files of 300 rows
    (3 batches of 128 rows a file)."""
    from ballista_tpu_torch import expr as ex
    from ballista_tpu_torch.physical.join import JoinExec
    from ballista_tpu_torch.physical.operators import (MergeExec,
                                                       RepartitionExec)

    facts = _part_dir(tmp_path, "fact", 4, 300,
                      lambda i: f"{i}|{i % 97}|k{i % 13}|\n")
    fact = _scan(facts, schema(("a", Int64), ("fk", Int64), ("c", Utf8)))
    if kind == "merge":
        return MergeExec(fact)
    if kind == "hash_repartition":
        return RepartitionExec(fact, 4, [ex.col("c")])
    if kind == "round_robin":
        return RepartitionExec(fact, 4)
    dims = _part_dir(tmp_path, "dim", 4, 25, lambda i: f"{i}|d{i % 5}|\n")
    dim = _scan(dims, schema(("k", Int64), ("name", Utf8)))
    return JoinExec(dim, fact, [("k", "fk")], device="cpu")


def _drain(plan):
    """Every output partition's batches, as one dict of host arrays per
    batch, in partition and batch order."""
    return [b.to_pydict() for p in range(
        plan.output_partitioning().num_partitions) for b in plan.execute(p)]


@pytest.mark.parametrize(
    "kind", ["merge", "hash_repartition", "round_robin", "join_build"])
def test_pipelined_operators_equal_serial(tmp_path, monkeypatch, kind):
    """Pipelined child partitions give the serial loop's batches, byte
    for byte; a hash repartition fetches its counts once, round-robin
    and the serial loop once per batch (12 here)."""
    from ballista_tpu_torch.physical.operators import RepartitionExec

    runs = {}
    for mode, (threads, prefetch) in (("serial", (1, 0)),
                                      ("pipelined", (4, 2))):
        _configure(monkeypatch, threads, prefetch)
        reset_port_caches()
        plan = _operator(kind, tmp_path)
        runs[mode] = _drain(plan)
        if isinstance(plan, RepartitionExec):
            fetches = plan.metrics().values()["count_fetches"]
            want = 1 if (mode, kind) == ("pipelined",
                                         "hash_repartition") else 12
            assert fetches == want, (mode, fetches)
    assert len(runs["serial"]) == len(runs["pipelined"]) > 0
    for i, (a, b) in enumerate(zip(runs["serial"], runs["pipelined"])):
        assert_identical(a, b, f"{kind}[{i}]")


# ---------------------------------------------------------------------------
# CacheSource: concurrent scans of one key materialize the inner scan once
# ---------------------------------------------------------------------------


def test_cache_source_concurrent_single_materialization():
    from ballista_tpu_torch.io import CacheSource

    sch = schema(("a", Int64))
    calls = []

    class CountingSource(TableSource):
        def table_schema(self):
            return sch

        def num_partitions(self):
            return 1

        def scan(self, partition, projection=None):
            calls.append(partition)
            time.sleep(0.05)  # widen the race window
            yield ColumnBatch.from_pydict(sch, {"a": list(range(10))},
                                          device="cpu")

    cache = CacheSource(CountingSource())
    results, errors = [], []

    def worker():
        try:
            results.append(list(cache.scan(0)))
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(calls) == 1, f"inner scan ran {len(calls)} times"
    assert len(results) == 4
    for batches in results:
        assert len(batches) == 1
        assert int(batches[0].num_rows) == 10


# ---------------------------------------------------------------------------
# observability: phase split on the scan's metrics + trace spans
# ---------------------------------------------------------------------------


def _t_ctx(tmp_path):
    from ballista_tpu_torch.client import BallistaContext

    ctx = BallistaContext.standalone(device="cpu")
    ctx.register_source("t", _tbl(_write_tbl(tmp_path)))
    return ctx


def test_phase_split_in_scan_metrics(tmp_path, monkeypatch):
    """``elapsed_parse``/``elapsed_h2d`` land on the ScanExec's metrics
    (the port's stand-in for EXPLAIN ANALYZE, not ported yet), with the
    table cache's outcome beside them."""
    _configure(monkeypatch, 2, 2)
    df = _t_ctx(tmp_path).sql("SELECT c, count(*) AS n FROM t GROUP BY c")
    df.to_pydict()
    (scan,) = scan_nodes(df.physical_plan())
    vals = scan.metrics().values()
    assert vals["elapsed_parse"] > 0 and vals["elapsed_h2d"] > 0, vals
    txt = df.physical_plan().pretty_metrics()
    assert "elapsed_parse" in txt and "elapsed_h2d" in txt, txt
    assert "[cache: filled]" in txt, txt
    # warm: served from the table cache, nothing parsed
    df.to_pydict()
    vals = scan.metrics().values()
    assert "elapsed_parse" not in vals, vals
    assert vals["table_cache_hits"] == 1, vals
    assert "[cache: hit]" in df.physical_plan().pretty_metrics()


def test_ingest_trace_spans(tmp_path, monkeypatch):
    from ballista_tpu_torch.observability import tracing

    trace_file = str(tmp_path / "trace.jsonl")
    monkeypatch.setenv("BALLISTA_TRACE", "1")
    monkeypatch.setenv("BALLISTA_TRACE_FILE", trace_file)
    tracing.reconfigure()
    _configure(monkeypatch, 2, 2)
    try:
        _t_ctx(tmp_path).sql("SELECT sum(a) AS s FROM t").to_pydict()
    finally:
        monkeypatch.delenv("BALLISTA_TRACE")
        monkeypatch.delenv("BALLISTA_TRACE_FILE")
        tracing.reconfigure()
    spans = [json.loads(line) for line in open(trace_file)]
    names = {s["name"] for s in spans}
    assert "ingest.parse" in names, names
    assert "ingest.h2d" in names, names
    assert "ingest.prime" in names, names
    # parse spans carry their producer thread id, making overlap
    # observable (not inferred) in the trace
    parse = [s for s in spans if s["name"] == "ingest.parse"]
    assert all("tid" in s and "dur" in s for s in parse)
    assert {s["tid"] for s in parse} != {threading.get_ident()}


def test_phase_totals_accumulate(tmp_path, monkeypatch):
    _configure(monkeypatch, 1, 0)  # serial: phases still recorded
    before = ingest.phase_totals()
    _t_ctx(tmp_path).sql("SELECT sum(a) AS s FROM t").to_pydict()
    after = ingest.phase_totals()
    assert after["parse"] > before["parse"]
    assert after["h2d"] > before["h2d"]


# ---------------------------------------------------------------------------
# on a card: pinned asynchronous uploads
# ---------------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: uploads on streams have no CPU "
                    "mode (python3 -m ballista_tpu_torch.testing."
                    "card_checks)")


def test_cuda_pinned_uploads_under_concurrent_capture():
    """Producer threads upload batches on their own streams while this
    thread warms up and captures governed programs as CUDA graphs: every
    upload equals its numpy source, every program its eager result."""
    _needs_card()
    from ballista_tpu_torch.columnar import side_stream_uploads
    from ballista_tpu_torch.compile import compile_stats, governed

    sch = schema(("a", Int64), ("b", Int64))
    stop = threading.Event()
    uploads, errors = [], []

    def producer(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set() and len(uploads) < 400:
                n = int(rng.integers(1, 300_000))
                data = {"a": rng.integers(-2**62, 2**62, n),
                        "b": rng.integers(0, 1000, n)}
                with side_stream_uploads():
                    b = ColumnBatch.from_numpy(sch, data, device="cuda")
                assert b._upload_event is not None
                uploads.append((data, b))
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(s,))
               for s in range(3)]
    for t in threads:
        t.start()
    try:
        before = compile_stats()["graph_captures"]
        for i in range(12):
            fn = governed(("sort.run", "test.cuda.upload_capture", i),
                          lambda: (lambda x: (x * 3 + 1).cumsum(0)))
            x = torch.arange(1 << 16, device="cuda") + i
            want = (x * 3 + 1).cumsum(0)
            for _ in range(3):  # capture, then two replays
                assert torch.equal(fn(x), want)
        assert compile_stats()["graph_captures"] == before + 12
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert uploads
    for data, b in uploads:
        b.wait_upload()
        n = len(data["a"])
        for name in ("a", "b"):
            got = b.column(name).values.cpu().numpy()
            np.testing.assert_array_equal(got[:n], data[name])
            assert not got[n:].any()
        assert int(b.num_rows) == n
        assert int(b.selection.sum()) == n


def test_cuda_record_stream_keeps_a_block_alive():
    """A batch uploaded on a side stream and read by a consumer delayed on
    its own stream: once the batch is dropped on the host, allocations on
    the upload stream must not get its block before the consumer has
    read it (``wait_upload`` records the consumer's stream)."""
    _needs_card()
    from ballista_tpu_torch.columnar import (_upload_stream,
                                             side_stream_uploads)

    sch = schema(("a", Int64))
    n = 1 << 22
    src = np.arange(n, dtype=np.int64) * 7
    with side_stream_uploads():
        b = ColumnBatch.from_numpy(sch, {"a": src}, capacity=n,
                                   device="cuda")
    b.wait_upload()
    torch.cuda._sleep(200_000_000)  # hold the consumer's stream ~0.1 s
    out = b.columns[0].values + 0   # queued behind the sleep
    ptr = b.columns[0].values.data_ptr()
    del b
    up = _upload_stream(torch.device("cuda"))
    with torch.cuda.stream(up):
        junk = [torch.full((n,), -1, dtype=torch.int64, device="cuda")
                for _ in range(4)]
    assert all(t.data_ptr() != ptr for t in junk)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy(), src)
