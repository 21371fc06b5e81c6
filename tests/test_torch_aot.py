"""``BALLISTA_FUSION_AOT_DIR`` on the port (``ballista_tpu_torch/compile/
aot.py``), on the CPU at SF0.002: the knob is read and the port exports
and loads nothing, by decision (a CUDA graph does not outlive its
process; see the module doc).

- with the knob naming an empty directory, q1, q6 and q16 leave it
  empty, and with it naming a path that does not exist, nothing is
  created there;
- ``compile_stats()`` reports ``aot_loads`` and ``aot_exports`` 0, and
  every ``system.compile`` row ``aot_loads`` 0;
- the results equal those with the knob unset, byte for byte, and the
  JAX package's (integer, decimal, date and string columns exactly,
  floats within rtol 1e-6);
- one INFO line per process, logged as ``ballista_tpu_torch.compile``
  is imported, says why (checked in fresh processes).
"""

import os
import subprocess
import sys

import pytest

from ballista_tpu_torch.compile import compile_stats

from torch_warm_path import (assert_equals_reference, assert_identical,
                             generate_tpch, pinned_threads, port_ctx,
                             reference_result, reset_port_caches, sql)

QUERIES = ["q1", "q6", "q16"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with pinned_threads():
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("aot_tpch")))


@pytest.fixture(scope="module")
def unset(tpch_dir):
    """Each query's result with the knob unset (cold caches), and the
    JAX package's (run here, where the knob is unset: the JAX package
    does write artifacts under it)."""
    assert "BALLISTA_FUSION_AOT_DIR" not in os.environ
    reset_port_caches()
    return {q: (port_ctx(tpch_dir).sql(sql(q)).to_pydict(),
                reference_result(tpch_dir, q)) for q in QUERIES}


# A fresh process that logs at INFO, imports the port and collects q1 and
# q6 on the CPU; argv: the TPC-H directory.
_CHILD = """
import logging, sys
logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                    format="LOG %(name)s %(message)s")
import torch
torch.set_num_threads(1)
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.testing.tpch_schema import register_tpch
for q in ("q1", "q6"):
    ctx = BallistaContext.standalone(device="cpu")
    register_tpch(ctx, sys.argv[1])
    sql = open(f"benchmarks/tpch/queries/{q}.sql").read()
    assert len(ctx.sql(sql).to_pydict()) > 0
"""


def _child_notes(tpch_dir, knob):
    """The ``ballista.compile.aot`` log lines of ``_CHILD`` run with
    ``BALLISTA_FUSION_AOT_DIR`` set to ``knob`` (unset when None)."""
    env = dict(os.environ)
    env.pop("BALLISTA_FUSION_AOT_DIR", None)
    if knob is not None:
        env["BALLISTA_FUSION_AOT_DIR"] = knob
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _CHILD, tpch_dir],
                          cwd=repo, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [ln for ln in proc.stderr.splitlines()
            if ln.startswith("LOG ballista.compile.aot ")]


@pytest.mark.parametrize("q", QUERIES)
def test_aot_dir_stays_empty_and_results_equal(tpch_dir, unset, tmp_path,
                                               monkeypatch, q):
    from ballista_tpu_torch.compile import governor

    out = tmp_path / "aot"
    out.mkdir()
    monkeypatch.setenv("BALLISTA_FUSION_AOT_DIR", str(out))
    governor().clear()  # every entry built again under the knob
    reset_port_caches()
    ctx = port_ctx(tpch_dir)
    got = ctx.sql(sql(q)).to_pydict()
    assert_identical(got, unset[q][0], q)
    assert_equals_reference(got, unset[q][1])
    assert list(out.iterdir()) == []
    st = compile_stats()
    assert st["aot_loads"] == 0 and st["aot_exports"] == 0
    ctx._plan_cache.clear()
    rows = ctx.sql("select namespace, aot_loads from system.compile"
                   ).to_pydict()
    assert len(rows["namespace"]) > 0
    assert set(rows["aot_loads"].tolist()) == {0}


def test_aot_dir_is_not_created_and_one_note_is_logged(tpch_dir,
                                                      tmp_path):
    missing = tmp_path / "never" / "made"
    notes = _child_notes(tpch_dir, str(missing))
    assert not (tmp_path / "never").exists()
    assert len(notes) == 1, notes
    assert str(missing) in notes[0]


def test_knob_unset_logs_nothing(tpch_dir):
    assert _child_notes(tpch_dir, None) == []
