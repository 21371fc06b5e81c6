"""lock-discipline: shared mutable state in threaded modules must be
written under a held lock; hand-rolled double-checked locking is
flagged.

The engine's concurrency contract (ingest pool, executor task threads,
dataplane server threads) routes every shared one-shot materialization
through :class:`ballista_tpu_torch.ingest.KeyedLocks` and guards module-level
mutable containers with a module lock (the JAX package's pass, with
the package name changed; the races it catches are double-checked
locking in caches and unguarded writes to shared tables). Two
sub-rules:

**unguarded-write** — in any module that uses threading (imports
``threading`` / ``concurrent.futures``), a write to a module-level
mutable container (dict/list/set/deque literal or constructor) from
inside a function must be lexically inside a ``with <lock>`` block
(any context manager whose expression mentions a lock/guard/mutex
name, including ``KeyedLocks.get``). Exception by convention: functions
named ``*_locked`` assert their callers hold the lock (the pattern
tracing.py documents).

**double-checked-locking** — ``if C: with lock: if C:`` re-check
shapes are flagged unless the lock comes from a ``KeyedLocks``-style
``.get(...)`` (receiver name containing "locks"): hand-rolled DCL is
where such races live, and KeyedLocks is the blessed carrier
for the pattern. Correct-but-manual instances get a baseline entry
with a justification instead of a rewrite.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from ..callgraph import walk_functions
from ..engine import Finding, Package, Rule, SourceFile, make_finding

MUTABLE_CALLS = frozenset({
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict",
    "Counter",
})

MUTATORS = frozenset({
    "append", "appendleft", "add", "update", "setdefault", "pop",
    "popleft", "extend", "remove", "discard", "clear", "insert",
})

LOCK_WORDS = ("lock", "guard", "mutex")


def _is_mutable_ctor(expr: ast.AST) -> bool:
    if isinstance(expr, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                         ast.ListComp, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call):
        f = expr.func
        name = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else "")
        return name in MUTABLE_CALLS
    return False


def _module_containers(sf: SourceFile) -> Dict[str, int]:
    """{name: def line} of module-level mutable containers."""
    out: Dict[str, int] = {}
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and _is_mutable_ctor(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.lineno
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and _is_mutable_ctor(node.value) \
                and isinstance(node.target, ast.Name):
            out[node.target.id] = node.lineno
    return out


def _uses_threading(package: Package, rel: str) -> bool:
    mi = package.index().module(rel)
    if mi is None:
        return False
    for local in mi.imports:
        dotted = mi.external_dotted(local) or ""
        if dotted.split(".")[0] in ("threading", "concurrent"):
            return True
    return False


def _mentions_lock(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        ident = (n.id if isinstance(n, ast.Name)
                 else n.attr if isinstance(n, ast.Attribute) else "")
        if ident and any(w in ident.lower() for w in LOCK_WORDS):
            return True
    return False


def _lock_ranges(fn: ast.AST) -> List[tuple]:
    ranges = []
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                if _mentions_lock(item.context_expr):
                    ranges.append((node.lineno,
                                   node.end_lineno or node.lineno))
                    break
    return ranges


def _writes(fn: ast.AST, containers: Set[str]):
    """Yield (line, name) for every mutation of a tracked container."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATORS and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in containers:
            yield node.lineno, node.func.value.id
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id in containers:
                    yield node.lineno, t.value.id
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id in containers:
                    yield node.lineno, t.value.id


def _keyed_locks_with(node: ast.With) -> bool:
    """True when any with-item acquires via ``<...locks...>.get(...)`` —
    the KeyedLocks carrier for per-key double-checked materialization."""
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
                and e.func.attr == "get":
            recv = e.func.value
            ident = (recv.attr if isinstance(recv, ast.Attribute)
                     else recv.id if isinstance(recv, ast.Name) else "")
            if "lock" in ident.lower():
                return True
    return False


class LockDisciplineRule(Rule):
    id = "lock-discipline"
    description = ("shared mutable state written without a held lock / "
                   "hand-rolled double-checked locking")

    def run(self, package: Package) -> List[Finding]:
        findings: List[Finding] = []
        for sf in package.files:
            findings.extend(self._unguarded_writes(package, sf))
            findings.extend(self._dcl(sf))
        return findings

    def _unguarded_writes(self, package: Package, sf: SourceFile
                          ) -> List[Finding]:
        containers = _module_containers(sf)
        if not containers or not _uses_threading(package, sf.rel):
            return []
        tracked = set(containers)
        findings: List[Finding] = []
        seen: Set[tuple] = set()  # nested defs are walked by their parent too
        locked_fns = [fn for fn, _ in walk_functions(sf)
                      if fn.name.endswith("_locked")]
        for fn, cls in walk_functions(sf):
            if fn.name.endswith("_locked"):
                continue  # convention: caller holds the lock
            ranges = _lock_ranges(fn)
            # a *_locked helper nested in/next to this fn keeps its own
            # exemption even when the parent's walk reaches its writes
            ranges += [(f.lineno, f.end_lineno or f.lineno)
                       for f in locked_fns]
            for line, name in _writes(fn, tracked):
                if (line, name) in seen:
                    continue
                seen.add((line, name))
                if any(lo <= line <= hi for lo, hi in ranges):
                    continue
                findings.append(make_finding(
                    self.id, sf, line,
                    f"module-level mutable '{name}' written in "
                    f"{cls + '.' if cls else ''}{fn.name} without a "
                    "held lock (threaded module)"))
        return findings

    def _dcl(self, sf: SourceFile) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.If):
                continue
            test_dump = ast.dump(node.test)
            for stmt in node.body:
                if not isinstance(stmt, ast.With):
                    continue
                if _keyed_locks_with(stmt):
                    continue
                for inner in stmt.body:
                    if isinstance(inner, ast.If) and \
                            ast.dump(inner.test) == test_dump:
                        findings.append(make_finding(
                            self.id, sf, node.lineno,
                            "hand-rolled double-checked locking (route "
                            "per-key materialization through "
                            "ingest.KeyedLocks, or triage with a "
                            "baseline note)"))
        return findings
