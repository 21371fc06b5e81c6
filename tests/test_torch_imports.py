"""The PyTorch/CUDA port stands alone: no module of ``ballista_tpu_torch``,
and not ``chip_smoke.py``, imports jax or the JAX package.

Checked on the source (an AST scan) rather than on ``sys.modules``: the
test interpreter imports jax at startup anyway."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ballista_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        out.extend(os.path.join(dirpath, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ballista_tpu") or (
        name.startswith("benchmarks.tpch.")
        and name not in ("benchmarks.tpch.datagen",))


def _imports(path: str):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
            if node.module == "benchmarks.tpch":
                for a in node.names:
                    yield node.lineno, f"benchmarks.tpch.{a.name}"


def test_scan_covers_the_port():
    files = _port_files()
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert "chip_smoke.py" in rel
    assert os.path.join("ballista_tpu_torch", "client.py") in rel
    # the mesh slice's modules
    for mod in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/multihost.py", "kernels/mesh_shuffle.py",
                "physical/mesh_agg.py", "physical/mesh_input.py",
                "distributed/mesh_group.py"):
        assert os.path.join("ballista_tpu_torch", *mod.split("/")) in rel
    assert len(files) > 25


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scanner_flags_forbidden_names():
    assert _forbidden("jax.numpy")
    assert _forbidden("ballista_tpu.columnar")
    assert _forbidden("benchmarks.tpch.schema_def")
    assert not _forbidden("ballista_tpu_torch.columnar")
    assert not _forbidden("benchmarks.tpch.datagen")
    assert not _forbidden("torch")


# the measurement entry points (the counterparts of bench.py,
# bench_serving.py, benchmarks/ and dev/profile_query.py)
ENTRY_POINTS = ("bench.py", "bench_serving.py", "benchmarks/__init__.py",
                "benchmarks/tpch.py", "benchmarks/sweep.py",
                "benchmarks/compare.py", "benchmarks/sf_run.py",
                "benchmarks/cluster_run.py", "benchmarks/scaling.py",
                "testing/profile_query.py", "testing/tpch_oracle.py")


@pytest.mark.parametrize("mod", ENTRY_POINTS)
def test_scan_covers_the_entry_points(mod):
    path = os.path.join(PORT, *mod.split("/"))
    assert path in _port_files()
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{mod} imports {bad}"


def test_oracle_loader_imports_no_jax_package():
    """``testing/tpch_oracle.py`` runs the oracle's source with the
    port's schemas: loading it imports neither jax nor the JAX package
    (checked in a fresh interpreter, which has imported neither)."""
    import subprocess
    import sys

    code = ("import sys\n"
            "from ballista_tpu_torch.testing import tpch_oracle\n"
            "o = tpch_oracle.load()\n"
            "assert len(o.ORACLES) == 22\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ballista_tpu') or "
            "m == 'benchmarks.tpch.schema_def']\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
