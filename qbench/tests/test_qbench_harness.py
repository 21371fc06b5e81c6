"""The harness on the CPU at SF0.01: a rehearsal of every cell of
``BENCHMARK.json`` through ``run_cell``, and of the cluster cell that
``qbench/`` keeps ready but does not list there; the same runs with the
timed path broken underneath (each must come out not correct); and the
command, which without a card prints no result and exits non-zero."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from qbench import deploy, harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 99


def _cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


# The scheduler-and-executors cell: its configuration, mix and readers
# are in qbench/, its entries are not in BENCHMARK.json (its runs spread
# too widely on the card for a bound); rehearsed from a checkout that
# lists it.
CLUSTER = "sf1-cluster-4s"
CLUSTER_ENTRIES = {
    "configs": [{"name": "tpch-sf1-cluster",
                 "source": "https://github.com/andygrove/ballista/blob/main"
                           "/rust/benchmarks/tpch/docker-compose.yaml",
                 "file": "qbench/configs/tpch-sf1-cluster.json",
                 "reduced": [], "why": "a scheduler and 2 executors"}],
    "workloads": [{"name": CLUSTER, "config": "tpch-sf1-cluster",
                   "traffic": "mix-4s", "chips": 1, "why": "4 tenants"}],
    "per_layer": [
        {"name": n, "unit": u, "better": "lower", "source": "program_span",
         "layer": "cluster", "moves": "query_p50_s", "workloads": [CLUSTER]}
        for n, u in (("planning_ms", "ms"), ("unledgered_s_per_query", "s"),
                     ("shuffle_write_s_per_query", "s"))],
}


@pytest.fixture
def cluster_root(tmp_path):
    """A checkout whose BENCHMARK.json also lists the cluster cell."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for key, entries in CLUSTER_ENTRIES.items():
        bench[key] = bench[key] + entries
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m and m["name"] == "device_idle_share":
            m["workloads"] = m["workloads"] + [CLUSTER]
    root = tmp_path / "checkout"
    root.mkdir()
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    os.symlink(os.path.join(REPO, "qbench"), root / "qbench")
    return str(root)


@pytest.fixture(autouse=True)
def _environment():
    # a run sets its cell's knobs in the environment: keep them to the test
    saved = dict(os.environ)
    from ballista_tpu_torch.cache import residency

    residency.reset()
    yield
    os.environ.clear()
    os.environ.update(saved)


def rehearse(name, traced=False, **kw):
    return harness.run_cell(name, SEED, 1.0, traced, device="cpu",
                            scale=0.01, **kw)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", _cells() + [CLUSTER])
def test_rehearsal(name, traced, request):
    root = request.getfixturevalue("cluster_root") if name == CLUSTER \
        else harness.ROOT
    out = rehearse(name, traced, root=root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["kind"] == "cpu"
    assert "busy_s" not in out["device"]
    assert list(out)[-1] == "checks"
    bench = harness.cell(name, traced, root)
    listed = {m["name"] for m in bench.metrics}
    assert set(out["metrics"]) <= listed
    # no device metric is read without a card
    device_metrics = {m["name"] for m in bench.metrics
                      if m["source"] == "device_trace"}
    assert not device_metrics & set(out["metrics"])
    if not traced:
        assert {"setup_s", "queries_per_s", "query_p50_s"} <= set(
            out["metrics"])
    else:
        # every metric read from the program's counters and spans is there
        assert listed - device_metrics <= set(out["metrics"])


def _nudged(ctx, text, span):
    out = harness.default_collect(ctx, text, span)
    if "revenue" in out:
        out["revenue"] = np.nextafter(out["revenue"], np.inf)
    return out


def test_fault_answer_altered_where_produced():
    out = rehearse("sf1-warm-mix", collect=_nudged)
    assert not out["correct"]
    assert out["checks"]["decimal_gap_ulp"]["value"] >= 1


def test_fault_stale_answer():
    last = {}

    def stale(ctx, text, span):
        out = harness.default_collect(ctx, text, span)
        prev = last.get("answer", out)
        last["answer"] = out
        return prev

    out = rehearse("sf1-warm-mix", collect=stale)
    assert not out["correct"]
    assert out["checks"]["answers_wrong"]["value"] > 0


def test_fault_a_query_fails():
    calls = []

    def failing(ctx, text, span):
        calls.append(text)
        # past the warm-up's two rounds of six
        if len(calls) == 20:
            raise RuntimeError("lost task")
        return harness.default_collect(ctx, text, span)

    out = rehearse("sf1-warm-mix", collect=failing)
    assert not out["correct"]
    assert out["failed"] > 0


@pytest.mark.parametrize("name", ["sf1-warm-mix", CLUSTER])
def test_fault_half_of_lineitem_left_out(name, tmp_path, monkeypatch,
                                         request):
    root = request.getfixturevalue("cluster_root") if name == CLUSTER \
        else harness.ROOT
    real = deploy.register

    def register(ctx, data_dir, tables, cached):
        real(ctx, data_dir, tables, cached)
        with open(os.path.join(data_dir, "lineitem.tbl"), "rb") as f:
            lines = f.read().splitlines(keepends=True)
        half = tmp_path / "half"
        half.mkdir(exist_ok=True)
        with open(half / "lineitem.tbl", "wb") as f:
            f.writelines(lines[: len(lines) // 2])
        real(ctx, str(half), ["lineitem"], cached)

    monkeypatch.setattr(deploy, "register", register)
    out = rehearse(name, root=root)
    assert not out["correct"]
    assert out["checks"]["answers_wrong"]["value"] > 0


def _command(cwd):
    return subprocess.run(
        [sys.executable, "-m", "qbench.run", "--workload", "sf1-warm-mix",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_command_without_a_card_prints_no_result():
    got = _command(REPO)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_command_alone_in_its_paths_prints_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "qbench"), tmp_path / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _command(tmp_path)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
