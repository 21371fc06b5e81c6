"""Checks of the CUDA kernel that need a card and ``nvcc``.

Run from the root of a checkout: ``python3 -m
ballista_tpu_torch.testing.card_checks``. Two checks; any failure gives a
non-zero exit:

1. ptxas's report (``nvcc -Xptxas -v``) on ``csrc/dense_grouped_sums.cu``,
   built with the flags the port builds it with: each instantiation's
   registers, and no stack frame and no spills;
2. the card-only tests of ``tests/test_torch_dense_sums.py``,
   ``tests/test_torch_compile_governor.py``, ``tests/test_torch_ingest.py``
   and ``tests/test_torch_cluster.py`` (their ``test_cuda_*`` functions: the
   kernel against its plain version; governed programs captured as CUDA
   graphs — outputs that survive later replays, the kernel counted and
   observed on every replay; pinned asynchronous uploads on producer
   streams while programs are captured, and ``record_stream`` keeping a
   block from reuse while a delayed consumer reads it; a cluster q5
   with the progress sampler running while tasks capture) under pytest,
   which must all pass: a skip fails here. Those files also hold
   the comparisons with the JAX package and import jax and the JAX
   package at their top, which a card's machine need not have and the
   card-only tests never call; empty modules stand in for those names,
   and ``tests/conftest.py``, which sets jax up, is not loaded.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import types

from ..native_build import BUILD_DIR, NVCC_FLAGS, PACKAGE_DIR, find_nvcc

TEST_FILES = [os.path.join("tests", "test_torch_dense_sums.py"),
              os.path.join("tests", "test_torch_compile_governor.py"),
              os.path.join("tests", "test_torch_ingest.py"),
              os.path.join("tests", "test_torch_cluster.py")]
STAND_INS = ("jax", "jax.numpy", "ballista_tpu", "ballista_tpu.kernels",
             "ballista_tpu.kernels.aggregate",
             "ballista_tpu.kernels.pallas_agg")


def ptxas_report() -> None:
    src = os.path.join(PACKAGE_DIR, "csrc", "dense_grouped_sums.cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"ptxas-check-{os.getpid()}.so")
    try:
        proc = subprocess.run(
            [find_nvcc()] + NVCC_FLAGS + ["-Xptxas", "-v", "-o", out, src],
            capture_output=True, text=True, timeout=600)
    finally:
        if os.path.exists(out):
            os.remove(out)
    report = [line for line in (proc.stdout + proc.stderr).splitlines()
              if "ptxas" in line or "stack frame" in line]
    for line in report:
        print(f"# {line.strip()}", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if not any("registers" in line for line in report):
        raise SystemExit("ptxas printed no register counts")
    spills = [line for line in report
              if re.search(r"[1-9]\d* bytes (stack frame|spill)", line)]
    if spills:
        raise SystemExit(f"ptxas reports stack or spills: {spills}")


class _Outcomes:
    """pytest plugin: the outcome of every test's call phase."""

    def __init__(self):
        self.seen = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.seen[report.nodeid] = report.outcome


def card_tests() -> None:
    import pytest

    for name in STAND_INS:
        sys.modules[name] = types.ModuleType(name)
    for name in STAND_INS:
        parent, _, child = name.rpartition(".")
        if parent:
            setattr(sys.modules[parent], child, sys.modules[name])
    sys.modules["ballista_tpu.kernels.pallas_agg"].dense_grouped_sums = None
    outcomes = _Outcomes()
    rc = pytest.main(TEST_FILES + ["--noconftest", "-p", "no:cacheprovider",
                                   "-q", "-k", "test_cuda_"],
                     plugins=[outcomes])
    for nodeid, outcome in sorted(outcomes.seen.items()):
        print(f"# {outcome}: {nodeid}", flush=True)
    if rc != 0 or not outcomes.seen or any(
            o != "passed" for o in outcomes.seen.values()):
        raise SystemExit(f"card-only tests did not all pass (pytest exit {rc})")


def main() -> int:
    ptxas_report()
    card_tests()
    print("# card checks passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
