"""The JAX package's static analysis over the port
(``ballista_tpu_torch/analysis/``, driven by ``python -m
ballista_tpu_torch.analysis``): the counterpart of
``tests/test_analysis.py``.

- each rule's matrix with torch idioms: a seeded violation fires, its
  clean variant does not, a suppression and a baseline entry absorb it;
  every one of the ten rules fires on a seeded torch violation;
- the whole port runs with the port's baseline and exits 0, every
  baseline entry carries a note and none is stale; ``--json`` and
  ``--changed-only`` work; a new finding exits 1;
- the analysis package loads standalone: the pure-AST rules run without
  torch in ``sys.modules`` (checked in a subprocess);
- the fix its first run over the port made: the text scan's dictionary
  pre-pass checks its cancel token at every byte range.

The subprocesses keep the reference's 120 s timeout; nothing here
asserts on elapsed time.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
MAIN_PY = os.path.join(REPO, "ballista_tpu_torch", "analysis", "__main__.py")
BASELINE = os.path.join("ballista_tpu_torch", "analysis", "baseline.json")


def _load_standalone():
    """The analysis package through its entry point's standalone loader."""
    spec = importlib.util.spec_from_file_location("_torch_analyze", MAIN_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_analysis(REPO)


analysis = _load_standalone()


def _pkg(tmp_path, files):
    root = tmp_path / "fixroot"
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return analysis.Package.load(str(root), package_rel="fixpkg")


def _run(pkg, rule, baseline=None):
    return analysis.analyze(pkg, [rule], baseline)


def _rule(rid, **kw):
    return analysis.RULE_FACTORIES[rid](**kw)


# ---------------------------------------------------------------------------
# engine mechanics: suppression, baseline, stale entries
# ---------------------------------------------------------------------------


def test_suppression_and_baseline_mechanics(tmp_path):
    trip = """
        import torch

        def f(x):
            return x.cpu()
    """
    suppressed = """
        import torch

        def f(x):
            return x.cpu()  # ballista: ignore[sync-span] host tensor
    """
    pkg = _pkg(tmp_path, {"fixpkg/trip.py": trip,
                          "fixpkg/ok.py": suppressed})
    rule = _rule("sync-span")
    res = _run(pkg, rule)
    assert [f.file for f in res.findings] == ["fixpkg/trip.py"]
    assert res.suppressed == 1

    f = res.findings[0]
    bl = analysis.Baseline([{"rule": f.rule, "file": f.file,
                             "anchor": f.anchor, "note": "fixture"}])
    res2 = _run(pkg, rule, bl)
    assert res2.findings == [] and len(res2.baselined) == 1
    assert res2.ok

    bl2 = analysis.Baseline([{"rule": f.rule, "file": f.file,
                              "anchor": "gone_anchor()", "note": "old"}])
    res3 = _run(pkg, rule, bl2)
    assert len(res3.stale) == 1 and not res3.ok


def test_comment_only_suppression_covers_next_line(tmp_path):
    src = """
        import torch

        def f(x):
            # ballista: ignore[sync-span] a 0-d count read between programs
            return x.item()
    """
    pkg = _pkg(tmp_path, {"fixpkg/m.py": src})
    res = _run(pkg, _rule("sync-span"))
    assert res.findings == [] and res.suppressed == 1


# ---------------------------------------------------------------------------
# cancel-coverage
# ---------------------------------------------------------------------------


def _cancel_rule():
    return _rule("cancel-coverage", critical_modules={"fixpkg/mod.py"})


def test_cancel_coverage_trips_and_clean(tmp_path):
    src = """
        import torch
        from .lc import check_cancel

        def bad(plan, parts):
            out = []
            for batch in plan.execute(parts):
                out.append(torch.cat([batch.selection]))
            return out

        def good(plan, parts):
            out = []
            for batch in plan.execute(parts):
                check_cancel()
                out.append(torch.cat([batch.selection]))
            return out

        def metadata_only(locs):
            seen = {}
            for part in locs:
                seen[part.stage] = part.rows
            return seen
    """
    pkg = _pkg(tmp_path, {"fixpkg/mod.py": src,
                          "fixpkg/lc.py": "def check_cancel():\n    pass\n"})
    res = _run(pkg, _cancel_rule())
    assert len(res.findings) == 1
    assert "bad" in res.findings[0].message


def test_cancel_coverage_follows_one_call_level(tmp_path):
    src = """
        from .lc import check_cancel

        def _pump(x):
            check_cancel()
            return x

        def covered(stream):
            for chunk in stream:
                _pump(chunk)

        class Reader:
            def _bail(self):
                check_cancel()

            def covered_method(self, stream):
                for chunk in stream:
                    self._bail()
                    chunk.wait_upload()
    """
    pkg = _pkg(tmp_path, {"fixpkg/mod.py": src,
                          "fixpkg/lc.py": "def check_cancel():\n    pass\n"})
    assert _run(pkg, _cancel_rule()).findings == []


def test_cancel_coverage_satisfiers_are_receiver_gated(tmp_path):
    src = """
        def bad(batches, validator):
            for b in batches:
                validator.check(b)
                b.wait_upload()

        def bad2(batches, fut):
            for b in batches:
                if fut.cancelled():
                    break
                b.wait_upload()

        def ok(batches, token):
            for b in batches:
                token.check()
                b.wait_upload()

        def ok2(batches, cancel_token):
            for b in batches:
                if cancel_token.cancelled:
                    break
                b.wait_upload()
    """
    pkg = _pkg(tmp_path, {"fixpkg/mod.py": src})
    found = {f.message.split(" ")[3] for f in _run(pkg,
                                                   _cancel_rule()).findings}
    assert found == {"bad", "bad2"}, found


# ---------------------------------------------------------------------------
# sync-span
# ---------------------------------------------------------------------------

_TRACE = ("from contextlib import contextmanager\n"
          "@contextmanager\n"
          "def trace_span(name, **kw):\n    yield\n")


@pytest.mark.parametrize("body,kind", [
    ("return t.item()", ".item()"),
    ("return t.cpu()", ".cpu()"),
    ("return t.to('cpu')", "to(\"cpu\")"),
    ("return t.to(device=torch.device('cpu'))", "to(\"cpu\")"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("ev.synchronize()", "ev.synchronize"),
    ("return col.values.tolist()", ".tolist() on a device value"),
    ("return torch.stack([t, t]).numpy()", ".numpy() on a device value"),
    ("return np.asarray(col.selection)", "np.asarray on a device value"),
    ("y = torch.sum(t)\n    return np.asarray(y)",
     "np.asarray on a device value"),
], ids=["item", "cpu", "to_cpu", "to_device_cpu", "cuda_sync",
        "event_sync", "tolist", "numpy", "asarray_attr",
        "asarray_provenance"])
def test_sync_span_fires_on_each_torch_sync(tmp_path, body, kind):
    src = ("import numpy as np\nimport torch\n\n"
           f"def f(t, col, ev):\n    {body}\n")
    pkg = _pkg(tmp_path, {"fixpkg/mod.py": src})
    res = _run(pkg, _rule("sync-span"))
    assert len(res.findings) == 1, res.findings
    assert kind in res.findings[0].message


def test_sync_span_clean_variants(tmp_path):
    src = """
        import numpy as np
        import torch
        from .tr import trace_span

        def spanned(col, t):
            with trace_span("device.block", site="fix"):
                n = t.item()
                return np.asarray(col.selection), n

        def host_object(d):
            return np.asarray(d.values, dtype=object)

        def host_input(rows):
            return np.asarray([r for r in rows]).tolist()

        def host_tensor(arr):
            staging = torch.empty((4,), pin_memory=True)
            view = torch.from_numpy(arr)
            return staging.numpy(), view.numpy()

        def to_dtype(t):
            return t.to(torch.int64)
    """
    pkg = _pkg(tmp_path, {"fixpkg/mod.py": src, "fixpkg/tr.py": _TRACE})
    res = _run(pkg, _rule("sync-span"))
    assert res.findings == [], res.findings


# ---------------------------------------------------------------------------
# h2d-discipline
# ---------------------------------------------------------------------------


def test_h2d_discipline_matrix(tmp_path):
    """Scan-source uploads must sit behind serve_or_fill: direct
    uploads in scan(), or in a module that never routes through the
    residency layer, are findings; produce-callback uploads and
    non-scan modules (shuffle codecs) are not."""
    unrouted = """
        from ..columnar import ColumnBatch

        class RogueSource:
            def scan(self, partition):
                yield from self._parts[partition]

            @classmethod
            def from_data(cls, schema, data):
                return [ColumnBatch.from_numpy(schema, data, {}, 8)]
    """
    routed = """
        import torch
        from ..columnar import ColumnBatch, _upload
        from ..cache.residency import serve_or_fill

        class GoodSource:
            def scan(self, partition):
                yield from serve_or_fill(
                    self._key(partition),
                    lambda: self._scan_direct(partition))

            def _scan_direct(self, partition):
                yield ColumnBatch.from_numpy(
                    self._schema, self._arrays[partition], {}, 8)
                yield _upload(self._arrays[partition], 8, self.device)

        class FrontRunner:
            def scan(self, partition):
                for arr in self._arrays[partition]:
                    yield torch.as_tensor(arr, device=self.device)
                    yield torch.from_numpy(arr).to(self.device)
                    yield torch.from_numpy(arr).cuda()
                    yield torch.from_numpy(arr).to(torch.int64)
                    yield torch.from_numpy(arr).to("cpu")
    """
    codec = """
        import torch

        def decode(vals, device):
            return torch.as_tensor(vals, device=device)  # no scan here
    """
    pkg = _pkg(tmp_path, {
        "fixpkg/io/unrouted.py": unrouted,
        "fixpkg/io/routed.py": routed,
        "fixpkg/io/codec.py": codec,
    })
    res = _run(pkg, _rule("h2d-discipline"))
    by_file = {}
    for f in res.findings:
        by_file.setdefault(f.file, []).append(f.message)
    assert "never routes through" in by_file["fixpkg/io/unrouted.py"][0]
    routed_msgs = by_file.get("fixpkg/io/routed.py", [])
    # as_tensor(device=), .to(device), .cuda(): the dtype cast and the
    # .to("cpu") are not uploads
    assert len(routed_msgs) == 3, routed_msgs
    assert all("in front of the residency layer" in m for m in routed_msgs)
    assert sorted(m.split(" upload")[0] for m in routed_msgs) == [
        ".cuda()", ".to(device)", "torch.as_tensor(device=...)"]
    assert "fixpkg/io/codec.py" not in by_file


def test_h2d_discipline_real_tree():
    """The port's io/ sources hold the discipline (memory.py's
    registration-time upload is the one triaged baseline entry, as in
    the JAX package)."""
    pkg = analysis.Package.load(REPO, package_rel="ballista_tpu_torch")
    res = _run(pkg, _rule("h2d-discipline"))
    files = sorted({f.file for f in res.findings})
    assert files == ["ballista_tpu_torch/io/memory.py"], files


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------


def test_lock_discipline_matrix(tmp_path):
    src = """
        import threading

        _lock = threading.Lock()
        _graphs = {}
        _safe = {}

        def bad_write(k, v):
            _graphs[k] = v

        def good_write(k, v):
            with _lock:
                _safe[k] = v

        def _fill_locked(k, v):
            _graphs[k] = v

        def dcl(key, locks):
            if key not in _graphs:
                with _lock:
                    if key not in _graphs:
                        _graphs[key] = 1
            return _graphs[key]

        def keyed(key, key_locks):
            if key not in _graphs:
                with key_locks.get(key):
                    if key not in _graphs:
                        with _lock:
                            _graphs[key] = 1
            return _graphs[key]
    """
    pkg = _pkg(tmp_path, {"fixpkg/mod.py": src})
    res = _run(pkg, _rule("lock-discipline"))
    by_msg = {}
    for f in res.findings:
        kind = ("dcl" if "double-checked" in f.message else "write")
        by_msg.setdefault(kind, []).append(f.line)
    assert len(by_msg.get("write", [])) == 1, res.findings
    assert len(by_msg.get("dcl", [])) == 1, res.findings


# ---------------------------------------------------------------------------
# the code-shape lints
# ---------------------------------------------------------------------------


def test_jit_sites_fire_on_raw_graph_and_compile_sites(tmp_path):
    src = """
        import torch
        from torch.cuda import CUDAGraph

        def rogue(fn, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = fn(x)
            h = CUDAGraph()
            return torch.compile(fn), g, h, y

        @torch.jit.script
        def scripted(x):
            return x + 1

        def opted_out(fn):
            return torch.compile(fn)  # jit-ok: fixture

        def unrelated(x):
            return torch.cuda.Stream(), x.to(torch.int32)
    """
    governor = """
        import torch

        def capture():
            return torch.cuda.CUDAGraph()
    """
    pkg = _pkg(tmp_path, {"fixpkg/mod.py": src,
                          "fixpkg/compile/governor.py": governor})
    res = _run(pkg, _rule("jit-sites", allow_prefix="fixpkg/compile/"))
    assert all(f.file == "fixpkg/mod.py" for f in res.findings)
    assert len(res.findings) == 5, res.findings


def test_dict_sites_fire_on_seeded_violation(tmp_path):
    src = """
        import numpy as np

        def rogue(xs, dicts):
            return np.unique(np.concatenate(dicts))

        def opted_out(xs, dicts):
            return np.searchsorted(dicts, xs)  # dict-ok: fixture
    """
    pkg = _pkg(tmp_path, {"fixpkg/mod.py": src})
    assert len(_run(pkg, _rule("dict-sites")).findings) == 1


def test_registry_rules_fire_on_seeded_violations(tmp_path):
    """metric-names, fault-points, lane-coverage and knob-docs read the
    port's live registries."""
    src = """
        import os

        def record(m):
            m.add_counter("bogus_metric_xyz")
            fault_point("bogus.point.xyz")
            with trace_span("bogus.span.xyz"):
                pass
            return os.environ.get("BALLISTA_BOGUS_KNOB_XYZ")
    """
    pkg = _pkg(tmp_path, {"fixpkg/mod.py": src})
    for rid, needle in (("metric-names", "bogus_metric_xyz"),
                        ("fault-points", "bogus.point.xyz"),
                        ("lane-coverage", "bogus.span.xyz"),
                        ("knob-docs", "BALLISTA_BOGUS_KNOB_XYZ")):
        found = _run(pkg, _rule(rid)).findings
        assert any(needle in f.message for f in found), (rid, found)


def test_every_rule_has_a_seeded_violation_above():
    assert sorted(analysis.RULE_FACTORIES) == sorted([
        "cancel-coverage", "sync-span", "lane-coverage", "h2d-discipline",
        "lock-discipline", "jit-sites", "dict-sites", "metric-names",
        "fault-points", "knob-docs"])


# ---------------------------------------------------------------------------
# the entry point over the port
# ---------------------------------------------------------------------------


def _run_cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "ballista_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})


def test_whole_port_analysis_clean_with_its_baseline():
    r = _run_cli("--baseline", BASELINE)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "analysis clean: 10 rule(s)" in r.stdout
    assert "stale" not in r.stdout + r.stderr


def test_baseline_entries_are_triaged():
    with open(os.path.join(REPO, BASELINE)) as fh:
        entries = json.load(fh)["findings"]
    assert entries
    for e in entries:
        assert e["file"].startswith("ballista_tpu_torch/"), e
        assert e["note"] and e["note"] != "TRIAGE ME", e


def test_cli_json_and_changed_only_modes():
    r = _run_cli("--json")
    assert r.returncode == 0, r.stdout + r.stderr
    payload = json.loads(r.stdout)
    assert payload["findings"] == [] and payload["stale_baseline"] == []
    assert payload["baselined"] > 0 and payload["suppressed"] > 0
    r2 = _run_cli("--changed-only")
    assert r2.returncode == 0, r2.stdout + r2.stderr


def test_cli_exits_nonzero_on_new_finding(tmp_path):
    """A seeded violation in a staged tree fails the entry point, which runs
    there as a plain file: the analysis package loads standalone."""
    stage = tmp_path / "repo"
    pkg = stage / "ballista_tpu_torch"
    pkg.mkdir(parents=True)
    (pkg / "rogue.py").write_text(
        "import torch\n"
        "def capture(fn):\n"
        "    return torch.cuda.CUDAGraph()\n")
    shutil.copytree(os.path.join(REPO, "ballista_tpu_torch", "analysis"),
                    pkg / "analysis",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, str(pkg / "analysis" / "__main__.py"),
         "--rules", "jit-sites", "--no-baseline"],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "rogue.py" in r.stderr, r.stderr


_STANDALONE = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("drv", sys.argv[1])
drv = importlib.util.module_from_spec(spec)
spec.loader.exec_module(drv)
analysis = drv.load_analysis(sys.argv[2])
rules = analysis.rules_for(["cancel-coverage", "sync-span",
                            "h2d-discipline", "lock-discipline",
                            "jit-sites", "dict-sites"])
pkg = analysis.Package.load(sys.argv[2], package_rel="ballista_tpu_torch")
res = analysis.analyze(pkg, rules)
print("files", len(pkg.files), "findings", len(res.findings))
print("torch loaded:", "torch" in sys.modules)
print("port loaded:", "ballista_tpu_torch" in sys.modules)
"""


def test_standalone_load_leaves_torch_out():
    r = subprocess.run([sys.executable, "-c", _STANDALONE, MAIN_PY, REPO],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "torch loaded: False" in r.stdout, r.stdout
    assert "port loaded: False" in r.stdout, r.stdout
    assert "files 0" not in r.stdout


# ---------------------------------------------------------------------------
# the fix the first run over the port made
# ---------------------------------------------------------------------------


def test_text_dictionary_prepass_checks_cancel(tmp_path, monkeypatch):
    """io/text.py ``_table_dictionaries``: the native pre-pass over a
    streamed file's byte ranges stops at the next range once the
    thread's token fires (found by cancel-coverage: the range loop had
    no check), and keeps nothing half-built."""
    from ballista_tpu_torch import Int64, Utf8, schema
    from ballista_tpu_torch.errors import QueryCancelled
    from ballista_tpu_torch.io import TblSource, native, text
    from ballista_tpu_torch.lifecycle import CancelToken, bind_token

    path = tmp_path / "t.tbl"
    path.write_text("".join(f"{i}|k{i % 7}|\n" for i in range(400)))
    monkeypatch.setattr(text, "STREAM_CHUNK_BYTES", 512)
    src = TblSource(str(path), schema(("a", Int64), ("k", Utf8)),
                    device="cpu")
    token = CancelToken()
    real = native.scan_file
    ranges = []

    def scan_then_cancel(*a, **kw):
        ranges.append(kw.get("offset"))
        token.cancel("test")
        return real(*a, **kw)

    monkeypatch.setattr(native, "scan_file", scan_then_cancel)
    with bind_token(token), pytest.raises(QueryCancelled):
        src._table_dictionaries(["k"])
    assert ranges == [0]
    assert "k" not in src._dicts
