"""The five code-shape lints of the JAX package's analysis, on the port.

AST-based: docstring skipping falls out for free (a docstring mentioning
``torch.compile`` is not a Call node). The JAX package's per-line opt-out
markers (``# jit-ok:``, ``# dict-ok:``, ``# metric-names: ...``,
``# fault-points: ...``) keep their meaning. ``jit-sites`` looks for the
port's program caches instead of ``jax.jit``: raw CUDA graph captures
(``torch.cuda.CUDAGraph``, ``torch.cuda.graph``,
``torch.cuda.make_graphed_callables``), ``torch.compile`` and
``torch.jit.*`` outside ``ballista_tpu_torch/compile/``. The three
registry-backed rules import the port's registries lazily inside ``run``
so the pure-AST rules stay usable standalone (staged lint self-tests,
fixture trees).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from ..callgraph import call_name
from ..engine import Finding, Package, Rule, SourceFile, make_finding

# the analysis package contains rule patterns and marker strings that
# would confuse the shape lints scanning it — it is machinery, like
# observability/metrics.py is for metric recording
_ANALYSIS_DIR = "ballista_tpu_torch/analysis/"
_PROTO_DIR = "ballista_tpu_torch/proto/"


def _first_arg_literal(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


# ---------------------------------------------------------------------------
# jit-sites (the JAX package's dev/check_jit_sites.py, for torch)
# ---------------------------------------------------------------------------

# dotted names (under a torch import) that build a program cache of
# their own: a CUDA graph capture, a compiled or scripted function
_GRAPH_SITES = frozenset({
    "torch.cuda.CUDAGraph", "torch.cuda.graph",
    "torch.cuda.make_graphed_callables", "torch.compile",
})
_GRAPH_PREFIXES = ("torch.jit.",)


class JitSitesRule(Rule):
    id = "jit-sites"
    description = ("raw CUDA graph / torch.compile / torch.jit sites "
                   "outside the compile governor")

    # THE capture site: the governor (and everything under compile/)
    ALLOW_PREFIX = "ballista_tpu_torch/compile/"
    MARKER = "jit-ok:"

    def __init__(self, allow_prefix: Optional[str] = None):
        self.allow_prefix = (allow_prefix if allow_prefix is not None
                             else self.ALLOW_PREFIX)

    @staticmethod
    def _dotted(node: ast.AST, mi) -> Optional[str]:
        """The external dotted name ``node`` refers to, through the
        module's imports (``torch.cuda.CUDAGraph`` for ``torch.cuda.
        CUDAGraph``, or for ``CUDAGraph`` imported from torch.cuda)."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = mi.external_dotted(node.id) if mi is not None else None
        if root is None:
            if node.id != "torch":
                return None
            root = "torch"
        return ".".join([root] + list(reversed(parts)))

    def _is_site(self, node: ast.AST, mi) -> bool:
        dotted = self._dotted(node, mi)
        return dotted is not None and (
            dotted in _GRAPH_SITES or dotted.startswith(_GRAPH_PREFIXES))

    def run(self, package: Package) -> List[Finding]:
        findings: List[Finding] = []
        for sf in package.files:
            if sf.rel.startswith((self.allow_prefix, _ANALYSIS_DIR)):
                continue
            mi = package.index().module(sf.rel)
            for node in ast.walk(sf.tree):
                ref = None
                if isinstance(node, ast.Call) and \
                        self._is_site(node.func, mi):
                    ref = node.func
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    for dec in node.decorator_list:
                        d = dec.func if isinstance(dec, ast.Call) else dec
                        if self._is_site(d, mi):
                            ref = d
                            break
                if ref is None:
                    continue
                if self.MARKER in sf.line(ref.lineno):
                    continue
                findings.append(make_finding(
                    self.id, sf, ref.lineno,
                    "raw CUDA graph / torch.compile / torch.jit site "
                    "outside ballista_tpu_torch/compile/ — route through "
                    "ballista_tpu_torch.compile.governed()"))
        return findings


# ---------------------------------------------------------------------------
# dict-sites (the JAX package's dev/check_dict_sites.py)
# ---------------------------------------------------------------------------


class DictSitesRule(Rule):
    id = "dict-sites"
    description = ("host np.unique/np.searchsorted outside the "
                   "dictionary registry")

    ALLOWLIST = frozenset({
        # THE unify/remap site: versioned unions, cached remap tables
        "ballista_tpu_torch/columnar_registry.py",
        # the Dictionary's own encode/canonicalize/search primitives
        "ballista_tpu_torch/columnar.py",
    })
    MARKER = "dict-ok:"

    def __init__(self, allowlist: Optional[Set[str]] = None):
        self.allowlist = (frozenset(allowlist) if allowlist is not None
                          else self.ALLOWLIST)

    def run(self, package: Package) -> List[Finding]:
        findings: List[Finding] = []
        for sf in package.files:
            if sf.rel in self.allowlist or \
                    sf.rel.startswith(_ANALYSIS_DIR):
                continue
            mi = package.index().module(sf.rel)
            np_aliases = {
                local for local in (mi.imports if mi else {})
                if mi.external_root(local) == "numpy"
            } or {"np"}
            for node in ast.walk(sf.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("unique", "searchsorted")
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in np_aliases):
                    continue
                if self.MARKER in sf.line(node.lineno):
                    continue
                findings.append(make_finding(
                    self.id, sf, node.lineno,
                    "host dictionary unify/remap outside the registry — "
                    "route through ballista_tpu_torch.columnar_registry (or "
                    "mark a non-dictionary use with '# dict-ok: reason')"))
        return findings


# ---------------------------------------------------------------------------
# metric-names (the JAX package's dev/check_metric_names.py)
# ---------------------------------------------------------------------------

_METRIC_ANNOTATION = re.compile(r"#\s*metric-names:\s*([\w\s,-]+)")
_PROM_NAME = re.compile(r"ballista_[A-Za-z0-9_]+\Z")
# the packages' own names match the family pattern but are not metrics
_NOT_FAMILIES = frozenset({"ballista_tpu", "ballista_tpu_torch"})


class MetricNamesRule(Rule):
    id = "metric-names"
    description = "metric names drifting out of the registry"

    SKIP_FILES = frozenset({
        # the recording machinery re-emits caller-supplied names
        "ballista_tpu_torch/observability/metrics.py",
    })
    CALLS = frozenset({"add_counter", "add_time", "set_gauge"})

    def __init__(self):
        self._parents_cache: Dict[int, Dict[int, ast.AST]] = {}

    def run(self, package: Package) -> List[Finding]:
        from ballista_tpu_torch.observability.registry import (
            OPERATOR_METRICS,
            PROCESS_METRICS,
        )

        findings: List[Finding] = []
        for sf in package.files:
            if sf.rel in self.SKIP_FILES or \
                    sf.rel.startswith((_PROTO_DIR, _ANALYSIS_DIR)):
                continue
            dyn_lines: Set[int] = set()
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call) and \
                        call_name(node) in self.CALLS:
                    lit = _first_arg_literal(node)
                    if lit is None:
                        dyn_lines.add(node.lineno)
                    elif lit not in OPERATOR_METRICS:
                        findings.append(make_finding(
                            self.id, sf, node.lineno,
                            f"literal metric name {lit!r} not in "
                            "OPERATOR_METRICS registry"))
                elif isinstance(node, ast.Constant) and \
                        isinstance(node.value, str) and \
                        node.value not in _NOT_FAMILIES and \
                        _PROM_NAME.match(node.value):
                    # prometheus family literals in sample tuples/calls
                    # (docstrings are Expr-statement constants: skipped)
                    if node.value not in PROCESS_METRICS and \
                            self._in_data_position(sf, node):
                        findings.append(make_finding(
                            self.id, sf, node.lineno,
                            f"prometheus family {node.value!r} not in "
                            "PROCESS_METRICS registry"))
            for line in sorted(dyn_lines):
                ann = _METRIC_ANNOTATION.search(sf.line(line))
                if ann is None:
                    findings.append(make_finding(
                        self.id, sf, line,
                        "dynamic metric name without a "
                        "'# metric-names: ...' annotation"))
                    continue
                for name in re.split(r"[\s,]+", ann.group(1).strip()):
                    if name and name not in OPERATOR_METRICS:
                        findings.append(make_finding(
                            self.id, sf, line,
                            f"annotated metric name {name!r} not in "
                            "OPERATOR_METRICS registry"))
        return findings

    def _in_data_position(self, sf: SourceFile, node: ast.Constant) -> bool:
        """Mirror the original regex's intent ("ballista_x", — a name in
        a sample tuple or argument list), excluding docstrings and bare
        expression statements."""
        parents = self._parents_for(sf)
        p = parents.get(id(node))
        return isinstance(p, (ast.Tuple, ast.List, ast.Call, ast.Dict,
                              ast.Set, ast.Compare, ast.keyword))

    def _parents_for(self, sf: SourceFile) -> Dict[int, ast.AST]:
        cached = self._parents_cache.get(id(sf))
        if cached is None:
            cached = {}
            for parent in ast.walk(sf.tree):
                for child in ast.iter_child_nodes(parent):
                    cached[id(child)] = parent
            self._parents_cache[id(sf)] = cached
        return cached


# ---------------------------------------------------------------------------
# fault-points (the JAX package's dev/check_fault_points.py)
# ---------------------------------------------------------------------------

_FAULT_ANNOTATION = re.compile(r"#\s*fault-points:\s*([\w\s.,-]+)")


class FaultPointsRule(Rule):
    id = "fault-points"
    description = ("fault_point call sites vs the FAULT_POINTS "
                   "registry (symmetric)")

    SKIP_FILES = frozenset({
        "ballista_tpu_torch/testing/faults.py",  # the machinery itself
    })
    REGISTRY_FILE = "ballista_tpu_torch/testing/faults.py"

    def run(self, package: Package) -> List[Finding]:
        from ballista_tpu_torch.testing.faults import FAULT_POINTS

        findings: List[Finding] = []
        used: Dict[str, int] = {p: 0 for p in FAULT_POINTS}
        for sf in package.files:
            if sf.rel in self.SKIP_FILES or \
                    sf.rel.startswith((_PROTO_DIR, _ANALYSIS_DIR)):
                continue
            for node in ast.walk(sf.tree):
                if not (isinstance(node, ast.Call)
                        and call_name(node) == "fault_point"):
                    continue
                lit = _first_arg_literal(node)
                if lit is not None:
                    if lit in used:
                        used[lit] += 1
                    else:
                        findings.append(make_finding(
                            self.id, sf, node.lineno,
                            f"literal fault-point name {lit!r} not in "
                            "FAULT_POINTS registry"))
                    continue
                ann = _FAULT_ANNOTATION.search(sf.line(node.lineno))
                if ann is None:
                    findings.append(make_finding(
                        self.id, sf, node.lineno,
                        "dynamic fault-point name without a "
                        "'# fault-points: ...' annotation"))
                    continue
                for name in sorted({t for t in
                                    re.split(r"[\s,]+", ann.group(1))
                                    if t}):
                    if name in used:
                        used[name] += 1
                    else:
                        findings.append(make_finding(
                            self.id, sf, node.lineno,
                            f"annotated fault-point name {name!r} not "
                            "in FAULT_POINTS registry"))
        reg = package.by_rel.get(self.REGISTRY_FILE)
        for point in sorted(p for p, n in used.items() if n == 0):
            findings.append(Finding(
                self.id, self.REGISTRY_FILE,
                1 if reg is None else self._registry_line(reg, point),
                f"registered fault point {point!r} has no call site "
                "(an armable fault that can never fire)",
                anchor=f"fault-point:{point}"))
        return findings

    @staticmethod
    def _registry_line(sf: SourceFile, point: str) -> int:
        needle = f'"{point}"'
        for i, line in enumerate(sf.lines, 1):
            if needle in line:
                return i
        return 1


# ---------------------------------------------------------------------------
# knob-docs (the JAX package's dev/check_knob_docs.py)
# ---------------------------------------------------------------------------

_KNOB_EXACT = re.compile(r"^BALLISTA_[A-Z0-9]+(?:_[A-Z0-9]+)*$")
_KNOB_PREFIX = re.compile(r"^BALLISTA_[A-Z0-9]+(?:_[A-Z0-9]+)*_$")
_README_TOKEN = re.compile(r"\bBALLISTA_[A-Z0-9_]+\b")

# "BALLISTA_" alone is the base of dynamically-composed env names
_IGNORED_LITERALS = frozenset({"BALLISTA" + "_"})


class KnobDocsRule(Rule):
    id = "knob-docs"
    description = ("BALLISTA_* knob drift between source, "
                   "system.settings registry and README")

    README = "README.md"

    def run(self, package: Package) -> List[Finding]:
        from ballista_tpu_torch.observability.systables import (
            KNOB_PREFIXES,
            KNOBS,
        )

        prefixes = set(KNOB_PREFIXES)
        registry = set(KNOBS)
        literals: Dict[str, List] = {}
        for sf in package.files:
            if sf.rel.startswith(_ANALYSIS_DIR):
                continue
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Constant) and \
                        isinstance(node.value, str):
                    v = node.value
                    if v in _IGNORED_LITERALS:
                        continue
                    if _KNOB_EXACT.match(v) or _KNOB_PREFIX.match(v):
                        literals.setdefault(v, []).append((sf, node.lineno))

        findings: List[Finding] = []

        def global_finding(anchor: str, message: str,
                           sf: Optional[SourceFile] = None,
                           line: int = 1) -> None:
            findings.append(Finding(
                self.id, sf.rel if sf else self.README, line, message,
                anchor=anchor))

        def covered(name: str) -> bool:
            return any(name.startswith(p) for p in prefixes)

        exact = {n for n in literals if not n.endswith("_")}
        pfx = {n for n in literals if n.endswith("_")}

        for name in sorted(exact):
            if name not in registry and not covered(name):
                sf, line = literals[name][0]
                global_finding(
                    f"knob:{name}",
                    f"knob {name} is read in the source but missing "
                    "from the system.settings registry "
                    "(observability/systables.py KNOBS)", sf, line)
        for name in sorted(pfx):
            if name not in prefixes:
                sf, line = literals[name][0]
                global_finding(
                    f"knob:{name}",
                    f"dynamic knob prefix {name} is used in the source "
                    "but not declared in KNOB_PREFIXES", sf, line)

        try:
            readme = open(f"{package.root}/README.md",
                          encoding="utf-8").read()
        except OSError:
            readme = ""
        tokens = set(_README_TOKEN.findall(readme))

        for name in sorted(registry):
            if name not in exact:
                global_finding(
                    f"knob:{name}",
                    f"registry knob {name} is not read anywhere in the "
                    "package (stale KNOBS entry?)")
            if name not in tokens:
                global_finding(
                    f"knob-doc:{name}",
                    f"registry knob {name} is missing from the README "
                    "knob tables")
        for name in sorted(prefixes):
            if name not in pfx:
                global_finding(
                    f"knob:{name}",
                    f"declared prefix {name} is not used anywhere in "
                    "the package (stale KNOB_PREFIXES entry?)")
        for tok in sorted(tokens):
            if tok in registry or covered(tok):
                continue
            global_finding(
                f"knob-doc:{tok}",
                f"README mentions {tok}, which is neither a registered "
                "knob nor covered by a declared prefix")
        return findings
