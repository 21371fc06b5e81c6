"""The port's measurement runners (``ballista_tpu_torch/benchmarks/`` and
``testing/profile_query.py``) on SF0.002 data (two files a table) on the
CPU, against the JAX package, the JAX runners and the pandas oracle:

- the TPC-H CLI: ``benchmark`` standalone (equal to the JAX package and
  the oracle) and through ``--host``/``--port`` (equal to standalone),
  ``convert`` (Parquet, then ``benchmark --format parquet`` equal to
  ``.tbl``) and ``gen`` (the same files as ``datagen``);
- ``sweep`` (every result equal to the JAX package's) and ``compare``
  (every result matches the oracle, as ``python -m benchmarks.compare``
  finds for the JAX package on the same data);
- ``sf_run`` through the byte-range streaming scan, checked by the
  oracle, and ``cluster_run`` through a ``LocalCluster`` of 2 executors,
  checked against standalone;
- ``scaling`` on 2 and 4 CPU slots: equal results at every slot count,
  equal to a numpy group-by and a hash join, and a point that differs
  from numpy fails the run;
- ``profile_query``'s per-operator attribution;
- without ``--device`` and with no card, every runner exits non-zero.

Tolerances: exact for integers, decimals, dates and strings; floats
within rtol 1e-6 (the parity bar), against the oracle also atol 1e-6
(``benchmarks/compare.py``'s bar: the engine's averages are Decimal(6)),
1e-5 where a runner itself checks.
"""

import json
import os

import numpy as np
import pytest

from ballista_tpu_torch.benchmarks import (cluster_run, compare, scaling,
                                           sf_run, sweep, tpch)
from ballista_tpu_torch.testing import profile_query, tpch_oracle

from torch_warm_path import (assert_equals_reference, generate_tpch,
                             pinned_threads, reference_result, sql)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """One torch, ingest and scanner thread: two tests run a cluster."""
    with pinned_threads(1):
        yield


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("runners_port")))


def _bench_args(path, query, *extra):
    return tpch.build_parser().parse_args(
        ["benchmark", "--path", path, "--query", str(query),
         "--iterations", "2", "--device", "cpu", *extra])


def _assert_close(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.shape == w.shape, c
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=c)
        elif w.dtype.kind == "O":
            assert list(g) == list(w), c
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


@pytest.mark.parametrize("query", [1, 5, 13])
def test_tpch_benchmark_equals_the_jax_package_and_oracle(tiny_data, query,
                                                          capsys):
    ms, got = tpch.run_benchmark(_bench_args(tiny_data, query))
    assert len(ms) == 2 and all(t > 0 for t in ms)
    out = capsys.readouterr().out
    assert f"Query {query} iteration 1 took" in out
    assert f"Query {query} avg time:" in out
    assert_equals_reference(got, reference_result(tiny_data, f"q{query}"))
    oracle = tpch_oracle.load()
    exp = oracle.ORACLES[f"q{query}"](oracle.load_tables(tiny_data))
    assert list(got) == list(exp.columns)
    for c in exp.columns:
        e = exp[c].to_numpy()
        if e.dtype.kind == "f":
            # ``benchmarks/compare.py``'s bar against the oracle: the
            # engine's averages are Decimal(6), truncated at 1e-6
            np.testing.assert_allclose(got[c], e, rtol=1e-6, atol=1e-6,
                                       err_msg=c)
        else:
            assert [str(x) for x in got[c]] == [str(x) for x in e], c


def test_tpch_benchmark_remote_equals_standalone(tiny_data):
    from ballista_tpu_torch.distributed.executor import LocalCluster

    _, want = tpch.run_benchmark(_bench_args(tiny_data, 3))
    cluster = LocalCluster(num_executors=2, concurrent_tasks=2,
                           device="cpu")
    try:
        ms, got = tpch.run_benchmark(_bench_args(
            tiny_data, 3, "--host", "localhost", "--port",
            str(cluster.port)))
    finally:
        cluster.shutdown()
    assert len(ms) == 2
    _assert_close(got, want)


def test_tpch_convert_then_benchmark_parquet(tiny_data, tmp_path, capsys):
    pq = str(tmp_path / "pq")
    assert tpch.main(["convert", "--input", tiny_data, "--output", pq,
                      "--partitions", "2"]) == 0
    assert "converted lineitem" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(pq, "lineitem"))) == [
        "part-0.parquet", "part-1.parquet"]
    _, from_tbl = tpch.run_benchmark(_bench_args(tiny_data, 1))
    _, from_pq = tpch.run_benchmark(_bench_args(pq, 1, "--format",
                                                "parquet"))
    _assert_close(from_pq, from_tbl)


def test_tpch_gen_writes_datagen_files(tiny_data, tmp_path):
    out = str(tmp_path / "gen")
    assert tpch.main(["gen", "--output", out, "--scale", "0.002",
                      "--parts", "2"]) == 0
    for table in ("lineitem", "orders", "nation"):
        for f in sorted(os.listdir(os.path.join(tiny_data, table))):
            with open(os.path.join(out, table, f), "rb") as a, \
                    open(os.path.join(tiny_data, table, f), "rb") as b:
                assert a.read() == b.read(), (table, f)


def test_sweep_results_equal_the_jax_package(tiny_data, capsys):
    queries = ["1", "3", "5", "13", "18"]
    line, results = sweep.run_sweep(tiny_data, queries, "cpu")
    assert sorted(line["times"]) == sorted(f"q{q}" for q in queries)
    assert line["worst"] in line["times"] and line["device"] == "cpu"
    for q in queries:
        assert_equals_reference(results[f"q{q}"],
                                reference_result(tiny_data, f"q{q}"))


def test_compare_matches_as_the_jax_compare_does(tiny_data, tmp_path):
    import benchmarks.compare as jax_compare

    queries = ["1", "3", "5", "12"]
    out = tmp_path / "jax.json"
    assert jax_compare.main(["--path", tiny_data, "--queries",
                             ",".join(queries), "--iterations", "1",
                             "--out", str(out)]) == 0
    ref = json.loads(out.read_text())
    line = compare.run_compare(tiny_data, queries, 1, "cpu")
    assert line["all_match"] and ref["all_match"]
    assert [r["query"] for r in line["rows"]] == \
        [r["query"] for r in ref["rows"]]
    assert [r["match"] for r in line["rows"]] == \
        [r["match"] for r in ref["rows"]]
    assert all(r["port_s"] > 0 and r["pandas_s"] > 0 for r in line["rows"])


def test_compare_reports_a_mismatch(tiny_data, monkeypatch):
    """A wrong result is reported, not hidden: ``all_match`` false and
    the exit code 1."""
    oracle = tpch_oracle.load()
    right = oracle.ORACLES["q6"]

    def wrong(t):
        out = right(t)
        out.iloc[0, 0] = out.iloc[0, 0] + 1
        return out

    monkeypatch.setitem(oracle.ORACLES, "q6", wrong)
    assert compare.main(["--path", tiny_data, "--queries", "6",
                         "--iterations", "1", "--device", "cpu"]) == 1


def test_sf_run_streams_and_matches_the_oracle(tiny_data, monkeypatch):
    from ballista_tpu_torch.io import text

    streamed = []
    orig = text.DelimitedSource._parsed_ranges

    def spy(self, partition, names):
        streamed.append(partition)
        yield from orig(self, partition, names)

    monkeypatch.setattr(text.DelimitedSource, "_parsed_ranges", spy)
    # files over this size stream (the module attribute, as the other
    # streaming tests set it; BALLISTA_SCAN_CHUNK_BYTES at import)
    monkeypatch.setattr(text, "STREAM_CHUNK_BYTES", 64 << 10)
    out = sf_run.run_sf(tiny_data, ["q1", "q3"], 2, "cpu", oracle=True)
    assert streamed, "no file was parsed in byte ranges"
    assert out["stream_chunk_bytes"] == 64 << 10
    for q in ("q1", "q3"):
        e = out["queries"][q]
        assert e["oracle"] == "ok" and e["rows_out"] > 0
        assert e["first_s"] > 0 and e["warm_s"] > 0


def test_cluster_run_matches_standalone(tiny_data):
    out = cluster_run.run_cluster(tiny_data, ["q5", "q3"], 2, "cpu",
                                  executors=2, concurrent_tasks=2,
                                  shuffle_partitions="4", timeout=120.0)
    assert out["executors"] == 2 and out["device"] == "cpu"
    for q in ("q5", "q3"):
        e = out["queries"][q]
        assert e["matches_standalone"] is True
        assert e["rows_out"] > 0 and e["warm_s"] > 0


def test_scaling_results_equal_at_every_slot_count():
    out = scaling.run_curves([2, 4], rows_per_dev=2048, total_rows=8192,
                             runs=1, device="cpu")
    assert sorted(out["curves"]) == [
        "mesh_agg_dict_strong", "mesh_agg_dict_weak", "mesh_agg_strong",
        "mesh_agg_weak", "mesh_join_strong", "mesh_join_weak"]
    for name, points in out["curves"].items():
        assert [p["n_devices"] for p in points] == [2, 4], name
        # against the first point's wall: n0 slots do n0 slots' work
        assert points[0]["efficiency"] == (1.0 if name.endswith("weak")
                                           else 0.5)
        assert all(p["warm_s"] > 0 for p in points)
        if name.endswith("strong"):
            assert len({p["rows_out"] for p in points}) == 1, name
    assert out["curves"]["mesh_join_strong"][0]["rows_out"] == 8192


@pytest.mark.parametrize("dict_key", [False, True])
@pytest.mark.parametrize("n_slots", [2, 4])
def test_scaling_aggregate_equals_numpy(n_slots, dict_key):
    rows = 8192
    node, module_want = scaling._agg_exec(n_slots, rows, "cpu", n_groups=64,
                                          dict_key=dict_key)
    got = scaling._rows(list(node.execute(0)))
    rng = np.random.default_rng(11)
    k = rng.integers(0, 64, rows)
    v = rng.integers(0, 1000, rows)
    keys = np.unique(k)
    want = np.stack([np.arange(len(keys)) if dict_key else keys,
                     np.array([v[k == x].sum() for x in keys]),
                     np.array([(k == x).sum() for x in keys])], axis=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(module_want, want)


@pytest.mark.parametrize("n_slots", [2, 4])
def test_scaling_join_equals_numpy(n_slots):
    rows = 4096
    node, module_want = scaling._join_exec(n_slots, rows, "cpu")
    got = scaling._rows(list(node.execute(0)))
    rng = np.random.default_rng(13)
    n_keys = rows // 4
    bv = rng.integers(0, 1000, n_keys)
    pk = rng.integers(0, n_keys, rows)
    pv = rng.integers(0, 1000, rows)
    build = dict(zip(range(n_keys), bv.tolist()))  # a hash join's build
    pairs = sorted((p, build[p], p, v)
                   for p, v in zip(pk.tolist(), pv.tolist()) if p in build)
    np.testing.assert_array_equal(got, np.array(pairs, dtype=np.int64))
    np.testing.assert_array_equal(module_want, got)


def test_scaling_fails_when_a_point_differs_from_numpy(monkeypatch):
    rows_of = scaling._rows

    def off_by_one(batches):
        mat = rows_of(batches)
        mat[0, -1] += 1
        return mat

    monkeypatch.setattr(scaling, "_rows", off_by_one)
    with pytest.raises(AssertionError, match="differ from numpy"):
        scaling.run_curves([2], rows_per_dev=1024, total_rows=2048,
                           runs=1, device="cpu")


def test_profile_query_attributes_operators(tiny_data):
    from ballista_tpu_torch.benchmarks import register_tables
    from ballista_tpu_torch.client import BallistaContext

    ctx = BallistaContext.standalone(device="cpu")
    register_tables(ctx, tiny_data, cached=True)
    total, stats = profile_query.profile(ctx, sql("q5"), runs=2)
    assert total > 0
    labels = " ".join(stats)
    assert "ScanExec: lineitem" in labels and "JoinExec" in labels
    assert all(sec >= 0 and nb >= 0 for sec, nb in stats.values())
    assert sum(nb for _, nb in stats.values()) > 0


RUNNERS = {
    "tpch": (tpch.main, ["benchmark", "--path", "{d}", "--query", "1"]),
    "sweep": (sweep.main, ["--path", "{d}"]),
    "compare": (compare.main, ["--path", "{d}"]),
    "sf_run": (sf_run.main, ["--data", "{d}"]),
    "cluster_run": (cluster_run.main, ["--data", "{d}"]),
    "scaling": (scaling.main, []),
    "profile_query": (profile_query.main, ["--data", "{d}"]),
}


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_runner_without_a_card_exits(name, tiny_data):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    fn, argv = RUNNERS[name]
    with pytest.raises(SystemExit) as exc:
        fn([a.format(d=tiny_data) for a in argv])
    assert exc.value.code and "no CUDA device" in str(exc.value.code)
