"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared by their
whole top-level part, so the port (``ballista_tpu_torch``) is not
mistaken for the JAX package (``ballista_tpu``)."""

import ast
import os
import subprocess
import sys

import pytest

QBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "ballista_tpu"}


def _sources(sub=""):
    root = os.path.join(QBENCH, sub)
    for d, _, files in os.walk(root):
        if os.path.basename(d) in ("tests", "__pycache__"):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, QBENCH))
def test_no_jax_import(path):
    assert not set(_imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, QBENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "ballista_tpu_torch" not in set(_imported(path))
    assert not set(_imported(path)) & FORBIDDEN


def test_loaded_modules_after_a_rehearsal():
    code = (
        "import sys\n"
        "from qbench import harness, run\n"
        "harness.run_cell('sf1-warm-mix', 5, 0.5, False, device='cpu',"
        " scale=0.01)\n"
        "print(run.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules"
        " if m.split('.')[0].startswith('ballista')}))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(QBENCH), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "['ballista_tpu_torch']"
