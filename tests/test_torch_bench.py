"""The port's benchmark line, ``python -m ballista_tpu_torch.bench``,
against the JAX package's ``bench.py`` on the same SF0.002 data (two
files a table, so the parse stage's concatenation runs too).

- the counterparts of ``tests/test_bench_instrumentation.py``:
  ``instrument_q1``'s stage fields, and the cold split's identity
  (parse + H2D + execute = wall) with the ingest pipeline gated off;
- the parse stage is the source's own parse (whole files, and byte
  ranges), with the JAX bench's arrays;
- ``instrument_q1`` counts the same rows as the JAX ``bench.py``'s, and
  the bench's q1 result equals the JAX package's (exactly);
- ``main --device cpu`` prints one JSON line with the fields of the JAX
  line that the port has, plus ``device`` and ``power_limit_w``, and
  ``dev/check_bench_regress.py`` reads two such lines;
- a phase that raises makes the run raise (a non-zero exit) after the
  line so far, and without ``--device`` and with no card the module
  exits non-zero before it runs anything.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ballista_tpu_torch import bench
from ballista_tpu_torch.testing.tpch_schema import TPCH_PKS, TPCH_SCHEMAS

from torch_warm_path import (generate_tpch, pinned_threads, reference_result,
                             reset_port_caches, sql)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAGE_KEYS = ("parse_s", "parse_mb_per_s", "h2d_s", "rows", "kernel_s",
              "kernel_rows_per_s", "kernel_aot_compile_s")
# the JAX line's fields that the port's line carries too
LINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "platform", "scale",
    "parse_seconds", "h2d_seconds", "execute_seconds", "lineitem_rows",
    "cold_seconds", "cold_rows_per_sec", "cold_vs_baseline",
    "first_run_seconds", "q1_groups", "warm_seconds",
    "compile_count", "compile_seconds", "persistent_cache_hit",
    "jit_programs", "aot_loads", "peak_rss_mb", "peak_device_bytes",
    "peak_host_tracked_bytes", "spill_bytes", "shuffle_peak_inflight_mb",
    "table_cache_hits", "result_cache_hits", "donated_buffers",
    "q5_first_seconds", "q5_warm_seconds", "q5_rows_per_sec",
    "progress_samples", "device_blocked_seconds", "host_dictionary_seconds",
    "compile_trace_lower_seconds", "q3_first_seconds", "q3_warm_seconds",
    "q18_first_seconds", "q18_warm_seconds", "q16_first_seconds",
    "q16_warm_seconds", "q16_host_dictionary_seconds",
    "cache_cold_q1_seconds", "cache_warm_q1_seconds", "cache_q1_speedup",
    "cache_q1_identical", "result_cache_hit_seconds", "result_cache_speedup",
    "result_cache_identical", "cache_budget_mb", "cache_budget_ok",
    "cache_budget_evictions", "cache_budget_identical",
    "spill_q5_seconds", "spill_budget_mb", "spill_chunk_mb",
    "spill_q5_peak_rss_mb", "stages",
)


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    with pinned_threads(2):
        yield


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("bench_port")))


@pytest.fixture(scope="module")
def bench_line(tmp_path_factory):
    """One run of ``main --device cpu`` at SF0.002: (its stdout lines,
    the parsed line)."""
    import io
    from contextlib import redirect_stdout

    data = str(tmp_path_factory.mktemp("bench_main"))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(["--scale", "0.002", "--data", data, "--runs", "1",
                         "--device", "cpu"])
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    return lines, json.loads(lines[-1])


def test_instrument_q1_populates_stages(tiny_data):
    out = bench.instrument_q1(tiny_data, runs=1, device="cpu")
    for key in STAGE_KEYS:
        assert key in out, f"missing stage field {key}: {out}"
    assert out["rows"] > 0
    assert out["kernel_s"] > 0
    assert out["kernel_rows_per_s"] > 0
    assert out["kernel_bytes_accessed"] > 0
    # no device peak on the CPU: the HBM share is a card's field
    assert "kernel_hbm_share" not in out


def test_instrument_q1_rows_equal_the_jax_bench(tiny_data):
    sys.path.insert(0, ROOT)
    import bench as jax_bench

    ref = jax_bench.instrument_q1(tiny_data, runs=1)
    mine = bench.instrument_q1(tiny_data, runs=1, device="cpu")
    assert mine["rows"] == ref["rows"] > 0


@pytest.mark.parametrize("chunk_bytes", [None, 16 << 10])
def test_parse_stage_is_the_sources_own_parse(tiny_data, monkeypatch,
                                              chunk_bytes):
    """The parse stage runs the source's host-side parse
    (``TblSource.parsed``), in byte ranges when the files are larger
    than the chunk, and its arrays equal the JAX bench's parse
    (``_scan_native`` of every partition, concatenated)."""
    from ballista_tpu_torch.io import TblSource, text

    if chunk_bytes is not None:
        monkeypatch.setattr(text, "STREAM_CHUNK_BYTES", chunk_bytes)
    calls = []
    orig = text.DelimitedSource.parsed

    def spy(self, partition, names):
        calls.append(partition)
        yield from orig(self, partition, names)

    monkeypatch.setattr(text.DelimitedSource, "parsed", spy)
    path = os.path.join(tiny_data, "lineitem")
    names = ["l_returnflag", "l_linestatus", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
    src = TblSource(path, TPCH_SCHEMAS["lineitem"], device="cpu")
    if chunk_bytes is not None:
        assert all(src._streams(p) for p in range(src.num_partitions()))
    n, arrays, _, _ = bench._parse_lineitem(src, names)
    assert calls == list(range(src.num_partitions())) == [0, 1]

    sys.path.insert(0, ROOT)
    from ballista_tpu.io import TblSource as JaxTblSource
    from benchmarks.tpch.schema_def import TPCH_SCHEMAS as JAX_SCHEMAS

    jsrc = JaxTblSource(path, JAX_SCHEMAS["lineitem"])
    parts = [jsrc._scan_native(p, names)
             for p in range(jsrc.num_partitions())]
    assert n == sum(part[0] for part in parts) > 0
    for m in names:
        np.testing.assert_array_equal(
            arrays[m], np.concatenate([part[1][m] for part in parts]))


def test_cold_phase_split_fields(tiny_data, monkeypatch):
    """With the ingest pipeline gated off, parse + H2D + execute sum to
    the wall (as ``test_bench_instrumentation.py`` pins for the JAX
    package)."""
    from ballista_tpu_torch import ingest
    from ballista_tpu_torch.client import BallistaContext

    reset_port_caches()  # the collect must parse
    monkeypatch.setenv("BALLISTA_INGEST_THREADS", "1")
    monkeypatch.setenv("BALLISTA_PREFETCH_BATCHES", "0")
    ingest.reconfigure()
    try:
        ctx = BallistaContext.standalone(device="cpu")
        ctx.register_tbl("lineitem", os.path.join(tiny_data, "lineitem"),
                         TPCH_SCHEMAS["lineitem"],
                         primary_key=TPCH_PKS["lineitem"])
        _, phases = bench.cold_phase_split(
            lambda: ctx.sql(sql("q1")).to_pydict())
    finally:
        monkeypatch.undo()
        ingest.reconfigure()
    for key in ("wall_seconds", "parse_seconds", "h2d_seconds",
                "execute_seconds"):
        assert key in phases, f"missing {key}: {phases}"
        assert phases[key] >= 0
    assert phases["parse_seconds"] > 0
    assert phases["h2d_seconds"] > 0
    total = (phases["parse_seconds"] + phases["h2d_seconds"]
             + phases["execute_seconds"])
    wall = phases["wall_seconds"]
    assert abs(total - wall) <= max(0.05 * wall, 0.02), phases


def test_bench_q1_equals_the_jax_package(tiny_data):
    result = {}
    q1 = bench._cold_q1(tiny_data, "cpu", result)
    want = reference_result(tiny_data, "q1")
    assert list(q1) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        if w.dtype.kind == "O":
            assert list(q1[c]) == list(w), c
        else:
            np.testing.assert_array_equal(q1[c], w, err_msg=c)
    assert result["q1_groups"] == len(want)
    assert result["lineitem_rows"] == sum(
        1 for f in os.listdir(os.path.join(tiny_data, "lineitem"))
        for _ in open(os.path.join(tiny_data, "lineitem", f)))


def test_main_prints_one_line_with_the_fields(bench_line):
    lines, line = bench_line
    assert len(lines) == 1, lines
    missing = [k for k in LINE_KEYS if k not in line]
    assert not missing, missing
    assert "partial" not in line
    assert line["metric"] == "tpch_q1_rows_per_sec_warm"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["platform"] == "cpu"
    # a CUDA graph does not outlive its process
    assert line["persistent_cache_hit"] == 0 and line["aot_loads"] == 0
    # the governor's process-wide counts (another test file in the same
    # worker may have emulated captures on the CPU)
    assert line["jit_programs"] > 0 and line["compile_seconds"] > 0
    assert line["kernel_launches_per_warm_q1"] == 0  # the plain version
    for key in ("cache_q1_identical", "result_cache_identical",
                "cache_budget_identical", "cache_budget_ok"):
        assert line[key] == 1, key
    for key in STAGE_KEYS:
        assert key in line["stages"], key
    assert line["stages"]["rows"] == line["lineitem_rows"]


def test_check_bench_regress_reads_two_lines(bench_line, tmp_path):
    """``dev/check_bench_regress.py`` reads the port's lines unchanged:
    every gate the line feeds is checked, not skipped, and passes."""
    _, line = bench_line
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    old.write_text(json.dumps(line) + "\n")
    new.write_text(json.dumps(line) + "\n")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "dev", "check_bench_regress.py"),
         str(old), str(new)], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    checked = {ln.split()[1].rstrip(":") for ln in proc.stdout.splitlines()
               if ln.startswith("ok ")}
    # (a lane at 0 s, such as host_dictionary on the CPU, is skipped by
    # the checker's design: no ratio from a zero baseline)
    for key in ("value", "warm_seconds", "cold_seconds", "q5_warm_seconds",
                "q16_warm_seconds", "peak_rss_mb",
                "progress_samples", "cache_q1_identical",
                "result_cache_identical", "table_cache_hits",
                "spill_q5_seconds"):
        assert key in checked, (key, proc.stdout)


def test_a_failing_phase_raises_after_the_partial_line(tmp_path,
                                                       monkeypatch, capsys):
    def broken(*args, **kw):
        raise RuntimeError("injected cache-phase fault")

    monkeypatch.setattr(bench, "_cache_phase", broken)
    with pytest.raises(RuntimeError, match="injected"):
        bench.main(["--scale", "0.002", "--data", str(tmp_path), "--runs",
                    "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["partial"] == "q16_done"  # the last phase that ended
    assert line["value"] > 0


def test_without_a_card_the_default_runs_nothing(tmp_path):
    """No ``--device``: the default is the card, and without one the
    module exits non-zero and generates no data."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "ballista_tpu_torch.bench", "--scale",
         "0.002", "--data", str(tmp_path), "--runs", "1"],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert proc.stdout == ""
    assert os.listdir(tmp_path) == []
