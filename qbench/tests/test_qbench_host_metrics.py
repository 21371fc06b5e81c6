"""The readers of the port's host clock (the latency ledger's ``host``
key) on synthetic runs."""

import pytest

from qbench import harness

CELL = harness.Cell({"name": "x", "chips": 1}, {}, {}, [])


def _run(**kw):
    base = dict(cell=CELL, device_kind="NVIDIA H100 80GB HBM3", setup_s=3.0,
                window_start=10.0, window_end=14.0, queries=[],
                counters_before={}, counters_after={}, ledgers=[],
                table_rows={"lineitem": 1000})
    base.update(kw)
    return harness.Run(**base)


HOST_READERS = {"frontend_s_per_query": "frontend",
                "governor_host_s_per_query": "governor",
                "operator_host_s_per_query": "operators",
                "device_wait_s_per_query": "device_wait",
                "pool_wait_s_per_query": "pool_wait",
                "recorder_s_per_query": "recorder"}


def _host_run():
    # three completed queries (walls 0.5, 1.5, 0.25 s) and one failed; two
    # ledgers carry the port's host seconds, one (a program without the
    # host clock) none
    q = [harness.Query("q1", 0, 10.0, 10.5, answer={}),
         harness.Query("q3", 0, 10.5, 12.0, answer={}),
         harness.Query("q5", 0, 12.0, 12.2, error="boom"),
         harness.Query("q6", 0, 12.2, 12.45, answer={})]
    cats = list(HOST_READERS.values())
    ledgers = [{"host": dict({c: 0.01 * (i + 1) for i, c in
                              enumerate(cats)}, switches=120)},
               {"host": dict({c: 0.1 * (i + 1) for i, c in
                              enumerate(cats)}, switches=240)},
               {"phases": {}}]
    return _run(queries=q, ledgers=ledgers), cats


@pytest.mark.parametrize("name", sorted(HOST_READERS))
def test_host_readers_sum_over_completed(name):
    run, cats = _host_run()
    i = cats.index(HOST_READERS[name])
    got = harness.load_metric(name).read(run)
    assert got == pytest.approx((0.01 + 0.1) * (i + 1) / 3)


@pytest.mark.parametrize("name", sorted(HOST_READERS) + [
    "unattributed_s_per_query"])
def test_host_readers_without_the_key_read_nothing(name):
    run, _ = _host_run()
    run.ledgers = [{"phases": {}, "operators": {}}, {"host": {}}]
    assert harness.load_metric(name).read(run) is None
    assert harness.load_metric(name).read(_run()) is None


def test_unattributed_is_the_walls_less_the_categories():
    run, _ = _host_run()
    walls = 0.5 + 1.5 + 0.25
    held = (0.01 + 0.1) * sum(range(1, 7))
    got = harness.load_metric("unattributed_s_per_query").read(run)
    assert got == pytest.approx((walls - held) / 3)
    parts = sum(harness.load_metric(n).read(run) for n in HOST_READERS)
    assert got + parts == pytest.approx(walls / 3)
