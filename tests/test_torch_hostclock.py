"""The port's host clock (``observability/hostclock.py``) on the CPU, at
TPC-H SF0.01:

- a standalone ledger's ``host`` key, beside ``operators`` and the JAX
  schema's ``phases``, holds the six categories and ``switches``; with
  the remainder they partition a warm q5's wall from ``ctx.sql`` to the
  rows, each at least 0 and the remainder under 10% of the wall;
- the ``ctx.sql`` before a collect is carried into its entry;
- nesting is exclusive: a ``device.block`` span inside a governed call
  counts once, as ``device_wait``;
- a pool thread's work adds nothing to the collect thread's categories,
  whose wait for it reads as ``pool_wait``; the worker's own split is
  handed to the collect under ``host["pool"]``; so does the wait for a
  lock another thread holds;
- two equal collects make the same number of switches.
"""

import statistics
import threading
import time

import pytest

from ballista_tpu_torch.compile import governed
from ballista_tpu_torch.ingest.pipeline import PrefetchHandle, ingest_pool
from ballista_tpu_torch.observability import hostclock
from ballista_tpu_torch.observability.tracing import trace_span

from torch_warm_path import pinned_threads, port_ctx, sql

CATS = hostclock.CATEGORIES


@pytest.fixture(scope="module", autouse=True)
def _pinned():
    with pinned_threads(2):
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    from benchmarks.tpch import datagen

    d = str(tmp_path_factory.mktemp("tpch_hostclock"))
    datagen.generate(d, scale=0.01, num_parts=2)
    return d


@pytest.fixture(scope="module")
def ctx(tpch_dir):
    ctx = port_ctx(tpch_dir)
    for _ in range(2):  # warm: plans cached, programs built
        ctx.sql(sql("q5")).to_pydict()
    return ctx


def _timed_q5(ctx):
    t0 = time.perf_counter()
    out = ctx.sql(sql("q5")).to_pydict()
    wall = time.perf_counter() - t0
    assert len(out["n_name"]) > 0
    return wall, ctx.last_query_ledger()


def test_ledger_host_key_beside_operators_and_phases(ctx):
    _, led = _timed_q5(ctx)
    assert {"phases", "operators", "host"} <= set(led)
    assert set(led["host"]) == set(CATS) | {"switches", "pool"}
    assert isinstance(led["host"]["switches"], int)
    assert led["host"]["switches"] > 0
    # the pool workers' seconds for the collect, in the same categories
    pool = led["host"]["pool"]
    assert set(pool) == set(CATS) | {"switches"}
    assert all(pool[c] >= 0.0 for c in CATS), pool
    from ballista_tpu_torch.observability.ledger import process_ledger_log

    assert process_ledger_log().last()["host"] == led["host"]


def test_categories_partition_a_warm_q5(ctx):
    rests = []
    for _ in range(3):
        wall, led = _timed_q5(ctx)
        host = led["host"]
        assert all(host[c] >= 0.0 for c in CATS), host
        rest = wall - sum(host[c] for c in CATS)
        assert rest >= 0.0, (wall, host)
        rests.append(rest / wall)
        # a warm q5 plans nothing (the plan cache) and runs operators,
        # their governed programs and their host reads of device values
        assert host["operators"] > 0.0 and host["governor"] > 0.0
        assert host["device_wait"] > 0.0 and host["recorder"] > 0.0
    # the median of three: a collector pause may land in the remainder
    assert statistics.median(rests) < 0.10, rests


def test_ctx_sql_is_carried_into_the_collect(ctx):
    ctx._plan_cache.clear()
    df = ctx.sql(sql("q5"))
    df.to_pydict()
    planned = ctx.last_query_ledger()["host"]["frontend"]
    df.to_pydict()  # the same frame: no ctx.sql, its plan kept
    kept = ctx.last_query_ledger()["host"]["frontend"]
    assert planned > kept >= 0.0


def test_device_wait_inside_a_governed_call_counts_once():
    def fn(x):
        time.sleep(0.02)  # the program's host work
        with trace_span("device.block", site="test.hostclock"):
            time.sleep(0.05)  # blocked on the card
        return x + 1

    gf = governed(("test_hostclock", "nested"), lambda: fn)
    hostclock.take()  # the thread's clock starts anew
    t0 = time.perf_counter()
    gf(1)
    wall = time.perf_counter() - t0
    host = hostclock.take()
    assert host["switches"] == 4  # into the call, the wait, and out
    # counted in the governor too, the wait would make it 0.07 s or more
    assert host["device_wait"] >= 0.05
    assert 0.02 <= host["governor"] < 0.05
    assert host["device_wait"] + host["governor"] == pytest.approx(
        wall, abs=2e-3)
    assert all(host[c] == 0.0 for c in CATS
               if c not in ("governor", "device_wait"))


def test_pool_thread_work_reads_as_pool_wait():
    def produce():
        with hostclock.charged(hostclock.OPERATORS):
            time.sleep(0.05)
            with trace_span("device.block", site="test.hostclock"):
                time.sleep(0.02)
        yield "batch"

    ingest_pool().submit(lambda: None).result()  # the worker is up
    hostclock.take()  # the thread's clock starts anew
    with hostclock.charged(hostclock.OPERATORS):
        got = list(PrefetchHandle(produce, 1, label="test"))
    host = hostclock.take()
    assert got == ["batch"]
    assert host["pool_wait"] >= 0.06, host
    assert host["device_wait"] == 0.0, host
    assert host["operators"] < 0.03, host
    # the worker's split, handed over with the handle's last item
    pool = host["pool"]
    assert 0.05 <= pool["operators"] < 0.07, pool
    assert pool["device_wait"] >= 0.02, pool
    assert pool["switches"] >= 4, pool


def test_lock_held_by_another_thread_reads_as_pool_wait():
    lock = threading.Lock()
    held = threading.Event()

    def hold():
        with lock:
            held.set()
            time.sleep(0.05)

    th = threading.Thread(target=hold)
    th.start()
    assert held.wait(10)
    hostclock.take()  # the thread's clock starts anew
    with hostclock.charged(hostclock.GOVERNOR):
        with hostclock.held(lock):
            pass
    th.join(10)
    assert not th.is_alive()
    host = hostclock.take()
    assert host["pool_wait"] >= 0.03, host
    assert host["governor"] < 0.01, host
    assert host["switches"] == 4


def test_equal_collects_switch_equally(tpch_dir, monkeypatch):
    from ballista_tpu_torch import ingest

    # the pipeline off: partitions and scans in turn on the collect's
    # thread, so no race with a pool worker decides where a scan runs
    monkeypatch.setenv("BALLISTA_PREFETCH_BATCHES", "0")
    ingest.reconfigure()
    try:
        ctx = port_ctx(tpch_dir)
        counts = []
        for _ in range(5):
            ctx.sql(sql("q5")).to_pydict()
            counts.append(ctx.last_query_ledger()["host"]["switches"])
    finally:
        monkeypatch.undo()
        ingest.reconfigure()
    # the first two build the plan and its programs and learn its
    # capacities (one compaction's row read less from the third on)
    assert counts[2] == counts[3] == counts[4], counts
