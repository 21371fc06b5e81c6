"""The port's serving line, ``python -m ballista_tpu_torch.bench_serving``,
on SF0.002 data (two files a table) with clusters on the CPU: the
counterpart of ``test_admission.py::test_bench_serving_emits_gated_fields``
for the ``serving`` phase (and its results, handed to ``on_result``,
against standalone runs), plus the ``restart`` and ``autoscale``
phases' fields, and ``dev/check_bench_regress.py`` reading the port's
lines as they are."""

import json
import os
import subprocess
import sys

import pytest

from ballista_tpu_torch import bench_serving

from torch_warm_path import generate_tpch, pinned_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """One torch, ingest and scanner thread: the clusters run up to four
    tasks at once."""
    with pinned_threads(1):
        yield


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("serving_port")))


def _check_regress(tmp_path, line, keys):
    """Two copies of ``line`` through ``dev/check_bench_regress.py``:
    it must pass, having checked (not skipped) every key of ``keys``."""
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    old.write_text(json.dumps(line) + "\n")
    new.write_text(json.dumps(line) + "\n")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "dev", "check_bench_regress.py"),
         str(old), str(new)], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    checked = {ln.split()[1].rstrip(":") for ln in proc.stdout.splitlines()
               if ln.startswith("ok ")}
    missing = [k for k in keys if k not in checked]
    assert not missing, (missing, proc.stdout)


def test_serving_emits_gated_fields(tiny_data, tmp_path):
    out = bench_serving.run_serving(
        tiny_data, sessions=2, queries_per_session=1, executors=2,
        slots=1, max_running=2, session_quota=1, job_timeout=120.0,
        mix=("q1",), device="cpu")
    assert out["metric"] == "serving_qps" and out["value"] > 0
    assert out["serving_completed"] == 2
    assert out["serving_errors"] == 0
    assert out["serving_p50_seconds"] > 0
    assert out["serving_p99_seconds"] >= out["serving_p50_seconds"]
    assert out["serving_admitted"] >= 2
    assert out["serving_solo_seconds"]["q1"] > 0
    # the ledger's lanes of every query of the storm
    assert out["serving_ledgers"] == 2
    assert out["p99_attribution"]
    for phase in ("planning", "device_execute", "queue_wait"):
        assert f"serving_{phase}_p50_seconds" in out
        assert f"serving_{phase}_p99_seconds" in out
    _check_regress(tmp_path, out, ("value", "serving_p50_seconds",
                                   "serving_p99_seconds",
                                   "serving_completed", "serving_errors",
                                   "serving_ledgers"))


def test_serving_hands_over_every_result_and_restores_the_env(
        tiny_data, monkeypatch):
    """``on_result`` receives each completed query (the warm pass and
    the storm), each equal to a standalone run of the query; the phase
    leaves ``BALLISTA_LEDGER_LOG`` as it found it."""
    import pandas as pd

    from ballista_tpu_torch.benchmarks import (frame_mismatch, query_sql,
                                               register_tables)
    from ballista_tpu_torch.client import BallistaContext

    monkeypatch.delenv("BALLISTA_LEDGER_LOG", raising=False)
    got = []
    out = bench_serving.run_serving(
        tiny_data, sessions=2, queries_per_session=1, executors=2,
        slots=1, max_running=2, session_quota=1, job_timeout=120.0,
        mix=("q1", "q6"), device="cpu",
        on_result=lambda q, rows: got.append((q, rows)))
    assert "BALLISTA_LEDGER_LOG" not in os.environ
    assert out["serving_errors"] == 0
    assert len(got) == out["serving_completed"] + 2 == 4
    assert sorted(q for q, _ in got) == ["q1", "q1", "q6", "q6"]
    ctx = BallistaContext.standalone(device="cpu")
    register_tables(ctx, tiny_data)
    want = {q: pd.DataFrame(ctx.sql(query_sql(q)).to_pydict())
            for q in ("q1", "q6")}
    for q, rows in got:
        assert frame_mismatch(pd.DataFrame(rows), want[q], label=q) is None


def test_restart_phase_fields(tiny_data, tmp_path):
    out = bench_serving.run_restart(tiny_data, jobs=4, device="cpu")
    assert out["metric"] == "recovered_jobs"
    assert out["recovered_jobs"] == out["value"] == 4
    assert out["recovery_inflight"] == 1  # the admitted, planned job
    assert out["recovery_queued_restored"] == 3
    assert out["recovery_relaunched"] == 0
    assert out["recovery_errors"] == 0
    assert out["recovery_seconds"] > 0
    _check_regress(tmp_path, out, ("recovery_seconds", "recovered_jobs",
                                   "recovery_errors"))


def test_autoscale_phase_fields(tiny_data, tmp_path):
    out = bench_serving.run_autoscale(
        tiny_data, sessions=2, queries_per_session=2, executors=2, slots=1,
        job_timeout=120.0, mix=("q1", "q3"), device="cpu")
    assert out["metric"] == "autoscale_qps" and out["value"] > 0
    assert out["autoscale_completed"] == 8
    assert out["autoscale_errors"] == 0
    assert out["autoscale_events"] >= 1
    assert out["autoscale_peak_executors"] == 2
    assert out["autoscale_p99_seconds"] >= out["autoscale_p50_seconds"] > 0
    _check_regress(tmp_path, out, ("autoscale_events",
                                   "autoscale_p99_seconds",
                                   "autoscale_errors"))


def test_main_names_its_device(tiny_data, capsys):
    rc = bench_serving.main(
        ["--phase", "restart", "--scale", "0.002", "--data",
         os.path.dirname(tiny_data), "--sessions", "1", "--device", "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "restart" and line["device"] == "cpu"
    assert line["power_limit_w"] is None
    for key in ("table_cache_hits", "result_cache_hits", "donated_buffers"):
        assert key in line


def test_without_a_card_the_default_exits(tmp_path):
    """The default device is the card: without one, ``main`` exits
    non-zero before it generates data or starts a cluster."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(SystemExit) as exc:
        bench_serving.main(["--data", str(tmp_path)])
    assert exc.value.code and "no CUDA device" in str(exc.value.code)
    assert os.listdir(tmp_path) == []
