"""Cancellation of the port's standalone collect (ballista_tpu_torch/
lifecycle.py): ``ctx.cancel()`` during a primed q5 raises
``QueryCancelled``, stops every scan producer, and leaves the table cache
without a partial entry; the next collect is right. The slow-query
killer fires the same token.

Every parse is held at a gate until the test has cancelled, so the
cancel lands while all scans are primed and none has finished."""

import threading
from concurrent import futures

import pytest

from ballista_tpu_torch import ingest
from ballista_tpu_torch.cache import residency
from ballista_tpu_torch.errors import QueryCancelled
from ballista_tpu_torch.ingest import pipeline
from ballista_tpu_torch.io import native

from torch_warm_path import (assert_equals_reference, generate_tpch,
                             pinned_threads, port_ctx, reference_result,
                             reset_port_caches, sql)


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """Two torch, ingest and scanner threads for this file's queries
    (``torch_warm_path.pinned_threads``)."""
    with pinned_threads():
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("torch_cancel_tpch")))


@pytest.fixture(autouse=True)
def _pipeline_on(monkeypatch):
    monkeypatch.setenv("BALLISTA_INGEST_THREADS", "4")
    monkeypatch.setenv("BALLISTA_PREFETCH_BATCHES", "2")
    ingest.reconfigure()
    reset_port_caches()
    yield
    monkeypatch.undo()
    ingest.reconfigure()
    reset_port_caches()


class _Gate:
    """Holds every native parse until ``open()``, and records every
    PrefetchHandle made meanwhile, until ``remove()``."""

    def __init__(self, monkeypatch):
        self.arrived = threading.Event()
        self._open = threading.Event()
        self.handles = []
        self._real = real_scan, real_init = (
            native.scan_file, pipeline.PrefetchHandle.__init__)

        def gated_scan(*a, **kw):
            self.arrived.set()
            assert self._open.wait(timeout=60), "gate never opened"
            return real_scan(*a, **kw)

        def recording_init(handle, *a, **kw):
            real_init(handle, *a, **kw)
            self.handles.append(handle)

        monkeypatch.setattr(native, "scan_file", gated_scan)
        monkeypatch.setattr(pipeline.PrefetchHandle, "__init__",
                            recording_init)

    def open(self):
        self._open.set()

    def remove(self):
        native.scan_file, pipeline.PrefetchHandle.__init__ = self._real


def _collect_in_thread(df):
    box = {}

    def run():
        try:
            box["out"] = df.to_pydict()
        except BaseException as e:  # noqa: BLE001 - inspected by the test
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    return t, box


def test_cancel_during_a_primed_q5(tpch_dir, monkeypatch):
    ctx = port_ctx(tpch_dir)
    df = ctx.sql(sql("q5"))
    gate = _Gate(monkeypatch)
    t, box = _collect_in_thread(df)
    assert gate.arrived.wait(timeout=60), "no scan started"
    assert gate.handles, "the collect primed no scan"
    assert ctx.cancel("test") == 1
    gate.open()
    t.join(timeout=120)
    assert not t.is_alive()
    err = box.get("err")
    assert isinstance(err, QueryCancelled), box
    assert err.reason == "test"
    # every producer stopped: no handle's future is still running
    futures.wait([h._future for h in gate.handles], timeout=60)
    assert all(h._future.done() for h in gate.handles)
    assert ingest.pool_queue_depth() == 0
    # no partial entry: no partition finished before the cancel
    stats = residency.process_table_cache().stats()
    assert stats["entries"] == 0 and stats["resident_bytes"] == 0, stats
    assert ctx.cancel() == 0  # nothing in flight any more
    # the next collect of the same frame runs whole and is right
    gate.remove()
    assert_equals_reference(df.to_pydict(), reference_result(tpch_dir, "q5"))


def test_slow_query_killer_cancels(tpch_dir, monkeypatch):
    monkeypatch.setenv("BALLISTA_SLOW_QUERY_KILL_SECS", "0.2")
    df = port_ctx(tpch_dir).sql(sql("q5"))
    gate = _Gate(monkeypatch)
    t, box = _collect_in_thread(df)
    assert gate.arrived.wait(timeout=60), "no scan started"
    threading.Timer(1.0, gate.open).start()
    t.join(timeout=120)
    assert not t.is_alive()
    err = box.get("err")
    assert isinstance(err, QueryCancelled), box
    assert err.reason == "slow-query-kill"
    stats = residency.process_table_cache().stats()
    assert stats["entries"] == 0 and stats["resident_bytes"] == 0, stats


def test_cancel_with_nothing_in_flight(tpch_dir):
    ctx = port_ctx(tpch_dir)
    assert ctx.cancel() == 0
    out = ctx.sql(sql("q1")).to_pydict()
    assert_equals_reference(out, reference_result(tpch_dir, "q1"))
