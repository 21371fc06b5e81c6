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
