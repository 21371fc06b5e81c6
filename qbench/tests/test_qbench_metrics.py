"""The per-layer readers and the trace arithmetic on synthetic runs, and
q1's byte count against a hand count at SF0.01."""

import importlib.util
import os

import pytest

from qbench import harness, trace

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = harness.Cell({"name": "x", "chips": 1}, {}, {}, [])


def _run(**kw):
    base = dict(cell=CELL, device_kind="NVIDIA H100 80GB HBM3", setup_s=3.0,
                window_start=10.0, window_end=14.0, queries=[],
                counters_before={}, counters_after={}, ledgers=[],
                table_rows={"lineitem": 1000})
    base.update(kw)
    return harness.Run(**base)


def test_q1_bytes_against_a_hand_count(tmp_path):
    path = os.path.join(REPO, "benchmarks", "tpch", "datagen.py")
    spec = importlib.util.spec_from_file_location("_dg", path)
    dg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dg)
    dg.generate(str(tmp_path), scale=0.01, num_parts=1, seed=3)
    with open(tmp_path / "lineitem" / "partition0.tbl", "rb") as f:
        rows = f.read().count(b"\n")
    # l_quantity, l_extendedprice, l_discount, l_tax: decimal, 8 B each;
    # l_shipdate: date, 4 B; l_returnflag, l_linestatus: char(1), 1 B each
    hand = rows * (8 + 8 + 8 + 8 + 4 + 1 + 1)
    q1 = harness.load_metric("q1_hbm_roofline_share")
    assert q1.q1_bytes(rows) == hand
    from qbench.data import generate

    assert len(generate.generate(0.01, 3)["lineitem"]["l_orderkey"]) == rows


def test_union_covered_and_gaps():
    iv = [(5, 10), (0, 2), (8, 12), (20, 25)]
    assert trace.union(iv) == [(0, 2), (5, 12), (20, 25)]
    assert trace.covered_ns(iv, 1, 22) == 1 + 7 + 2
    assert trace.gaps(iv, 0, 30) == [(2, 5), (12, 20), (25, 30)]


def _profile():
    # one q1 span of 1 ms holding 0.5 ms of device work, 1 launch inside
    p = trace.Profile(0, 2_000_000)
    p.device = [("k", 100_000, 600_000), ("memcpy", 1_500_000, 1_600_000)]
    p.runtime = [("cudaGraphLaunch", 150_000, 160_000),
                 ("cudaMemcpyAsync", 1_400_000, 1_410_000)]
    spans = [trace.Span("q1", 0, 1_000_000, 0),
             trace.Span("q1.to_pydict", 50_000, 1_000_000, 0),
             trace.Span("q6", 1_000_000, 2_000_000, 0)]
    return p, spans


def test_trace_readers():
    p, spans = _profile()
    run = _run(profile=p, spans=spans)
    idle = harness.load_metric("device_idle_share").read(run)
    assert idle == pytest.approx(100 * (1 - 0.6 / 2.0))
    assert harness.load_metric("launches_per_query").read(run) == 1.0
    share = harness.load_metric("q1_hbm_roofline_share").read(run)
    assert share == pytest.approx(100 * (1000 * 38 / 3.35e12) / 0.5e-3)
    assert trace.top_device_ops(p)[0] == ["k", 0.0005]
    gaps = trace.idle_gaps(p, spans)
    assert gaps[0] == ["q6", 0.0009]


def test_readers_with_nothing_to_read():
    run = _run()
    for name in ("device_idle_share", "launches_per_query",
                 "q1_hbm_roofline_share", "planning_ms",
                 "unledgered_s_per_query", "shuffle_write_s_per_query",
                 "queries_per_s", "query_p50_s", "query_p95_s"):
        assert harness.load_metric(name).read(run) is None, name
    # a card the table of peaks does not hold gives no roofline
    p, spans = _profile()
    other = _run(profile=p, spans=spans, device_kind="another card")
    assert harness.load_metric("q1_hbm_roofline_share").read(other) is None


def test_counter_and_ledger_readers():
    q = [harness.Query("q1", 0, 10.0, 10.5, answer={}),
         harness.Query("q3", 0, 10.5, 12.0, answer={})]
    ledgers = [{"phases": {"planning": 0.002, "shuffle_write": 0.1},
                "wall_seconds": 0.4, "unattributed_seconds": 0.1},
               {"phases": {"planning": 0.004, "shuffle_write": 0.3},
                "wall_seconds": 1.2, "unattributed_seconds": 0.3}]
    before = {"graph_captures": 5, "ingest_parse_s": 1.0,
              "ingest_h2d_s": 0.5}
    after = {"graph_captures": 6, "ingest_parse_s": 2.0,
             "ingest_h2d_s": 0.9}
    run = _run(queries=q, ledgers=ledgers, counters_before=before,
               counters_after=after)
    read = lambda n: harness.load_metric(n).read(run)  # noqa: E731
    assert read("queries_per_s") == 0.5
    assert read("query_p50_s") == 1.0
    assert read("planning_ms") == pytest.approx(3.0)
    assert read("shuffle_write_s_per_query") == pytest.approx(0.2)
    assert read("unledgered_s_per_query") == pytest.approx(1.0 - 0.8 + 0.2)
    assert read("captures_in_window") == 1
    assert read("parse_s_per_query") == pytest.approx(0.5)
    assert read("h2d_s_per_query") == pytest.approx(0.2)
    assert read("setup_s") == 3.0


def test_p95_needs_two_hundred_queries():
    qs = [harness.Query("q1", 0, 0.0, 0.001 * (i + 1), answer={})
          for i in range(200)]
    assert harness.load_metric("query_p95_s").read(_run(queries=qs)) == (
        pytest.approx(0.19005))
