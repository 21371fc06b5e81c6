"""Static analysis entry point for the port: every pass, one process, one exit
code — the counterpart of the JAX package's ``dev/analyze.py``.

Usage::

    python -m ballista_tpu_torch.analysis \
        [--baseline ballista_tpu_torch/analysis/baseline.json]
        [--rules id1,id2] [--list-rules] [--json]
        [--changed-only] [--write-baseline] [--root D]

    python ballista_tpu_torch/analysis/__main__.py ...   (the same,
        without importing torch for the pure-AST rules)

- exit 0 when every finding is suppressed or baselined; 1 otherwise.
- ``--baseline`` defaults to ``ballista_tpu_torch/analysis/baseline.json``
  when that file exists. Stale entries (triaged findings whose site was
  fixed) are reported as warnings; ``--write-baseline`` rewrites the
  file from the current findings (new entries carry a ``TRIAGE ME`` note
  — replace it with a justification before committing).
- ``--changed-only`` scopes reported findings to files touched per
  ``git diff --name-only HEAD`` (+ untracked) — the fast pre-commit
  mode; package-scoped rules still analyze the whole tree.
- ``--json`` emits a machine-readable report on stdout.

It analyzes ``ballista_tpu_torch/`` only. The analysis package is loaded
STANDALONE (``load_analysis``: no ``ballista_tpu_torch/__init__``
execution, hence no torch import when run as a file); the
registry-backed rules import the live registries lazily and only then
pay the package import.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.normpath(os.path.join(HERE, "..", ".."))

PACKAGE = "ballista_tpu_torch"
DEFAULT_BASELINE = os.path.join(PACKAGE, "analysis", "baseline.json")


def load_analysis(repo_root: str = REPO):
    """Import ``<repo>/ballista_tpu_torch/analysis`` as a standalone
    package (registered as ``_ballista_torch_analysis``) without
    executing the parent package's ``__init__``. Registry-backed rules
    that do ``from ballista_tpu_torch... import`` at run time still
    resolve the real package via ``repo_root`` on sys.path."""
    name = "_ballista_torch_analysis"
    if name in sys.modules:
        return sys.modules[name]
    pkg_dir = os.path.join(repo_root, PACKAGE, "analysis")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)
    spec.loader.exec_module(mod)
    return mod


def changed_files(repo_root: str):
    """Repo-relative paths touched vs HEAD (unstaged + staged +
    untracked) for --changed-only."""
    out = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            r = subprocess.run(args, cwd=repo_root, capture_output=True,
                               text=True, timeout=30)
        except Exception:  # noqa: BLE001 - no git: fall back to full run
            return None
        if r.returncode != 0:
            return None
        out.update(p.strip() for p in r.stdout.splitlines() if p.strip())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON path (default: "
                         f"{DEFAULT_BASELINE} when present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--changed-only", action="store_true")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    args = ap.parse_args(argv)

    analysis = load_analysis(args.root)

    if args.list_rules:
        for rid, factory in analysis.RULE_FACTORIES.items():
            print(f"{rid:18s} {factory.description}")
        return 0

    try:
        rules = (analysis.rules_for(args.rules.split(","))
                 if args.rules else analysis.all_rules())
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    baseline = None
    baseline_path = args.baseline
    if baseline_path is None:
        cand = os.path.join(args.root, DEFAULT_BASELINE)
        baseline_path = cand if os.path.exists(cand) else None
    elif not os.path.isabs(baseline_path):
        baseline_path = os.path.join(args.root, baseline_path)
    if baseline_path and not args.no_baseline and not args.write_baseline:
        baseline = analysis.Baseline.load(baseline_path)

    package = analysis.Package.load(args.root, package_rel=PACKAGE)
    only = None
    if args.changed_only and not args.write_baseline:
        # a baseline rewrite must always see the whole package — a
        # diff-scoped one would silently drop unchanged files' entries
        only = changed_files(args.root)
    result = analysis.analyze(package, rules, baseline, only_files=only)

    if args.write_baseline:
        if baseline_path is None:
            baseline_path = os.path.join(args.root, DEFAULT_BASELINE)
        previous = (analysis.Baseline.load(baseline_path)
                    if os.path.exists(baseline_path) else None)
        bl = analysis.Baseline.from_findings(result.findings,
                                             previous=previous)
        if previous is not None:
            # a --rules-scoped rewrite must not erase other rules'
            # triaged entries — carry them over untouched
            run_ids = {r.id for r in rules}
            bl.entries = sorted(
                [e for e in previous.entries
                 if e.get("rule") not in run_ids] + bl.entries,
                key=lambda e: (e.get("rule", ""), e.get("file", ""),
                               e.get("anchor", "")))
        bl.save(baseline_path)
        fresh = sum(1 for e in bl.entries if e.get("note") == "TRIAGE ME")
        print(f"wrote {len(bl.entries)} baseline entr"
              f"{'y' if len(bl.entries) == 1 else 'ies'} to "
              f"{os.path.relpath(baseline_path, args.root)} "
              f"({fresh} new) — replace every 'TRIAGE ME' note with a "
              "justification")
        return 0

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in result.findings],
            "parse_errors": [f.to_dict() for f in result.parse_errors],
            "baselined": len(result.baselined),
            "suppressed": result.suppressed,
            "stale_baseline": result.stale,
        }, indent=2))
        return 0 if result.ok else 1

    for f in result.parse_errors + result.findings:
        print(f.render(), file=sys.stderr)
    for e in result.stale:
        print(f"warning: stale baseline entry {e.get('rule')}: "
              f"{e.get('file')}: {e.get('anchor')!r} (fixed? prune with "
              "--write-baseline)", file=sys.stderr)
    n = len(result.findings) + len(result.parse_errors)
    if n:
        print(f"{n} finding(s) ({len(result.baselined)} baselined, "
              f"{result.suppressed} suppressed) — fix, suppress with "
              "'# ballista: ignore[rule]' + reason, or triage into the "
              "baseline", file=sys.stderr)
        return 1
    print(f"analysis clean: {len(rules)} rule(s), "
          f"{len(package.files)} files, {len(result.baselined)} "
          f"baselined, {result.suppressed} suppressed"
          + (f", {len(result.stale)} stale baseline entr"
             f"{'y' if len(result.stale) == 1 else 'ies'}"
             if result.stale else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
