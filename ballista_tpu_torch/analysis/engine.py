"""The analysis engine: parse the package once, run every pass over it.

The port's copy of the JAX package's engine (``ballista_tpu/analysis/
engine.py``), with the package name changed. The shared core the passes
run on:

- :class:`SourceFile` / :class:`Package` — every ``.py`` file under the
  package parsed ONCE (source text, AST, suppression comments); rules
  never re-read or re-parse.
- :class:`Finding` — structured result: rule id, repo-relative file,
  line, message, plus the stripped source line as a line-drift-stable
  ``anchor`` for baseline matching.
- suppressions — ``# ballista: ignore[rule-id]`` on the finding line
  (or alone on the line above) silences that rule there; legacy
  per-rule markers (``# jit-ok:``...) stay honored by their ports.
- :class:`Baseline` — a committed JSON file of triaged pre-existing
  findings (``ballista_tpu_torch/analysis/baseline.json``); matched by
  ``(rule, file, anchor)`` so line churn doesn't invalidate entries,
  and entries that no longer match anything are reported as stale.

The package is import-light on purpose: stdlib only, intra-package
relative imports only, so its entry point (``__main__.py``) and staged lint
self-tests can load it standalone without executing
``ballista_tpu_torch/__init__`` (which imports torch) — rules that need
live registries import them lazily inside ``run``.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(r"#\s*ballista:\s*ignore\[([^\]]*)\]")

# directories never worth parsing
_SKIP_DIRS = {"__pycache__"}


class SourceFile:
    """One parsed module: text, lines, AST, and suppression map."""

    __slots__ = ("rel", "path", "text", "lines", "tree", "suppressions",
                 "parse_error")

    def __init__(self, rel: str, path: str, text: str):
        self.rel = rel
        self.path = path
        self.text = text
        self.lines: List[str] = text.splitlines()
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:  # surfaced as a finding by the runner
            self.tree = ast.Module(body=[], type_ignores=[])
            self.parse_error = str(e)
        self.suppressions: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, 1):
            m = SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {t.strip() for t in m.group(1).split(",") if t.strip()}
            self.suppressions.setdefault(i, set()).update(rules or {"*"})
            # a comment-only line suppresses the line below it (long
            # statements have no room for a trailing marker)
            if line.lstrip().startswith("#"):
                self.suppressions.setdefault(i + 1, set()).update(
                    rules or {"*"})

    def line(self, n: int) -> str:
        """1-indexed raw source line ('' when out of range)."""
        if 1 <= n <= len(self.lines):
            return self.lines[n - 1]
        return ""

    def suppressed(self, line: int, rule: str) -> bool:
        rules = self.suppressions.get(line)
        return bool(rules) and ("*" in rules or rule in rules)


class Package:
    """Every module under one package root, parsed once and shared by
    all passes (plus lazily-built cross-module indexes, see
    :mod:`callgraph`)."""

    def __init__(self, root: str, files: List[SourceFile]):
        self.root = root  # repo root (rel paths resolve against it)
        self.files = files
        self.by_rel: Dict[str, SourceFile] = {f.rel: f for f in files}
        self._index = None  # callgraph.ProjectIndex, built on demand

    @classmethod
    def load(cls, root: str, package_rel: str = "ballista_tpu_torch"
             ) -> "Package":
        root = os.path.abspath(root)
        pkg_dir = os.path.join(root, package_rel)
        files: List[SourceFile] = []
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                try:
                    text = open(path, encoding="utf-8").read()
                except OSError:
                    continue
                files.append(SourceFile(rel, path, text))
        return cls(root, files)

    def index(self):
        """The shared import-resolving project index (built once)."""
        if self._index is None:
            from .callgraph import ProjectIndex

            self._index = ProjectIndex(self)
        return self._index


class Finding:
    """One rule violation at one site."""

    __slots__ = ("rule", "file", "line", "message", "anchor")

    def __init__(self, rule: str, file: str, line: int, message: str,
                 anchor: Optional[str] = None):
        self.rule = rule
        self.file = file
        self.line = line
        self.message = message
        self.anchor = anchor if anchor is not None else ""

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.anchor)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.message, "anchor": self.anchor}

    def render(self) -> str:
        return f"{self.rule}: {self.file}:{self.line}: {self.message}"

    def __repr__(self) -> str:  # debugging/pytest output
        return f"<Finding {self.render()}>"


def make_finding(rule: str, sf: SourceFile, line: int, message: str
                 ) -> Finding:
    """Finding anchored to the stripped source line (the baseline's
    line-drift-stable identity)."""
    return Finding(rule, sf.rel, line, message, sf.line(line).strip())


class Rule:
    """Base class for passes. Subclasses set ``id``/``description`` and
    implement ``run(package) -> list[Finding]``. Construction takes no
    required arguments so the registry can instantiate defaults; rules
    with tunable scope (module lists, allowlists) accept overrides as
    keyword arguments for fixture tests."""

    id: str = ""
    description: str = ""

    def run(self, package: Package) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


class Baseline:
    """Triaged pre-existing findings, committed as JSON.

    Entry shape: ``{"rule", "file", "anchor", "note"}`` — ``note`` is
    the triage justification (required by convention, not schema).
    Matching is by (rule, file, anchor): one entry absorbs every
    finding with that identity, so a moved line stays baselined and a
    FIXED site turns the entry stale (reported, prunable with
    ``--write-baseline``)."""

    def __init__(self, entries: Optional[List[dict]] = None):
        self.entries: List[dict] = list(entries or [])

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        return cls(data.get("findings", []))

    def save(self, path: str) -> None:
        data = {"version": 1, "findings": self.entries}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=2, sort_keys=True)
            fh.write("\n")

    def _keys(self) -> Set[Tuple[str, str, str]]:
        return {(e.get("rule", ""), e.get("file", ""), e.get("anchor", ""))
                for e in self.entries}

    def partition(self, findings: Sequence[Finding]
                  ) -> Tuple[List[Finding], List[Finding], List[dict]]:
        """(new, baselined, stale_entries)."""
        keys = self._keys()
        new = [f for f in findings if f.key() not in keys]
        old = [f for f in findings if f.key() in keys]
        live = {f.key() for f in old}
        stale = [
            e for e in self.entries
            if (e.get("rule", ""), e.get("file", ""),
                e.get("anchor", "")) not in live
        ]
        return new, old, stale

    @classmethod
    def from_findings(cls, findings: Sequence[Finding],
                      previous: Optional["Baseline"] = None) -> "Baseline":
        """Baseline covering ``findings``. Entries already present in
        ``previous`` keep their triage notes; only genuinely new sites
        get the TRIAGE ME placeholder (a rewrite must never destroy
        recorded justifications)."""
        prev_notes = {}
        if previous is not None:
            prev_notes = {
                (e.get("rule", ""), e.get("file", ""), e.get("anchor", "")):
                e.get("note", "")
                for e in previous.entries
            }
        seen: Set[Tuple[str, str, str]] = set()
        entries = []
        for f in sorted(findings, key=lambda f: (f.rule, f.file, f.line)):
            if f.key() in seen:
                continue
            seen.add(f.key())
            entries.append({"rule": f.rule, "file": f.file,
                            "anchor": f.anchor,
                            "note": prev_notes.get(f.key(), "TRIAGE ME")})
        return cls(entries)


class AnalysisResult:
    __slots__ = ("findings", "baselined", "stale", "suppressed",
                 "parse_errors")

    def __init__(self, findings: List[Finding], baselined: List[Finding],
                 stale: List[dict], suppressed: int,
                 parse_errors: List[Finding]):
        self.findings = findings      # NEW (non-baselined) findings
        self.baselined = baselined
        self.stale = stale
        self.suppressed = suppressed
        self.parse_errors = parse_errors

    @property
    def ok(self) -> bool:
        return not self.findings and not self.parse_errors


def analyze(package: Package, rules: Iterable[Rule],
            baseline: Optional[Baseline] = None,
            only_files: Optional[Set[str]] = None) -> AnalysisResult:
    """Run ``rules`` over ``package``; drop suppressed findings, split
    the rest against ``baseline``. ``only_files`` (repo-relative paths)
    filters file-scoped findings — package-scoped rules still see the
    whole tree, their findings are just not reported for other files
    (the ``--changed-only`` fast path)."""
    parse_errors = [
        Finding("parse-error", f.rel, 1, f.parse_error or "syntax error")
        for f in package.files if f.parse_error
    ]
    raw: List[Finding] = []
    for rule in rules:
        raw.extend(rule.run(package))
    kept: List[Finding] = []
    suppressed = 0
    for f in raw:
        sf = package.by_rel.get(f.file)
        if sf is not None and sf.suppressed(f.line, f.rule):
            suppressed += 1
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.file, f.line, f.rule))
    if baseline is None:
        new, old, stale = kept, [], []
    else:
        # partition against the FULL finding set — staleness must not
        # depend on the reporting scope (a --changed-only run would
        # otherwise call every unchanged file's entries stale)
        new, old, stale = baseline.partition(kept)
    if only_files is not None:
        new = [f for f in new if f.file in only_files]
        old = [f for f in old if f.file in only_files]
    return AnalysisResult(new, old, stale, suppressed, parse_errors)
