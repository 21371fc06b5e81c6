"""cancel-coverage: chunk/partition loops on the data path must check
their cancel token.

Cancellation is cooperative: work stops at batch/partition boundaries
via :func:`ballista_tpu_torch.lifecycle.check_cancel`, on every scan
chunk and shuffle chunk boundary. The invariant ("every loop that does
per-chunk work on a cancel-critical path checks the token") is the JAX
package's pass, with the module paths of the port:

- scope: the modules that make up the executor task-runner, shuffle
  read/write and ingest producer paths (``CANCEL_CRITICAL_MODULES`` —
  the ground truth set named in docs/robustness.md + docs/shuffle.md).
- a ``for``/``while`` statement there is a *chunk loop* when its
  header (for: target+iterable; while: test + names assigned in the
  body) mentions batch/chunk/partition-vocabulary identifiers
  (word-level match, so ``num_record_batches`` counts but
  ``partitioning`` does not), or its iterable calls a known producer
  (``execute``/``scan``/``fetch*``). Comprehensions are exempt
  (in-memory, no blocking work per element), as are loops whose body
  performs no calls at all (pure metadata walks).
- the loop is covered when its body (or a function it calls, ONE level
  of call-graph following through the import-resolving index) contains
  a cancel check: ``check_cancel()``, ``token.check()``,
  ``job_stream_cancelled(...)``, a read of ``.cancelled``, or an
  ``is_set()`` probe on a cancel/closed/stop flag.

Anything else is a finding — fix it with a ``check_cancel()`` at the
loop boundary, or suppress with ``# ballista: ignore[cancel-coverage]``
plus a reason when the loop is genuinely bounded elsewhere.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..callgraph import call_name, identifiers, name_words, walk_functions
from ..engine import Finding, Package, Rule, SourceFile, make_finding

# the executor task runner, shuffle read/write and ingest producer
# paths — the modules the port's cancellation covers
CANCEL_CRITICAL_MODULES = frozenset({
    "ballista_tpu_torch/distributed/executor.py",
    "ballista_tpu_torch/distributed/dataplane.py",
    "ballista_tpu_torch/distributed/spill.py",
    "ballista_tpu_torch/distributed/flight.py",
    "ballista_tpu_torch/physical/shuffle.py",
    "ballista_tpu_torch/ingest/pipeline.py",
    "ballista_tpu_torch/io/ipc.py",
    "ballista_tpu_torch/io/parquet.py",
    "ballista_tpu_torch/io/text.py",
    "ballista_tpu_torch/io/native.py",
    "ballista_tpu_torch/io/cache.py",
    "ballista_tpu_torch/execution.py",
})

CHUNK_WORDS = frozenset({
    "batch", "batches", "chunk", "chunks", "part", "parts", "partition",
    "partitions", "piece", "pieces", "rb", "frame", "frames", "segment",
    "segments",
})

# a for-loop iterating a call to one of these is a chunk loop even when
# no vocabulary identifier appears (``for b in plan.execute(p)``)
PRODUCER_CALLS = frozenset({"execute", "scan", "fetch", "replay"})

# direct satisfiers: a call to one of these inside the loop body
CHECK_CALLS = frozenset({"check_cancel", "job_stream_cancelled"})
# receiver-gated satisfiers: <token-ish>.check() / <token-ish>.cancelled
# (an unrelated validator.check(b) or future.cancelled() must NOT
# satisfy the rule)
TOKEN_WORDS = ("token", "cancel")
# flag-probe satisfier: <something cancel/closed/stop-ish>.is_set()
FLAG_WORDS = ("cancel", "closed", "stop", "drain")


def _receiver_ident(func: ast.Attribute) -> str:
    base = func.value
    if isinstance(base, ast.Attribute):
        return base.attr
    if isinstance(base, ast.Name):
        return base.id
    return ""


def _chunky_words(idents) -> bool:
    for ident in idents:
        for w in name_words(ident):
            if w in CHUNK_WORDS:
                return True
    return False


def _is_chunk_loop(node: ast.AST) -> bool:
    if isinstance(node, ast.For):
        if _chunky_words(identifiers(node.target)
                         + identifiers(node.iter)):
            return True
        for call in ast.walk(node.iter):
            if isinstance(call, ast.Call):
                name = call_name(call) or ""
                words = set(name_words(name))
                if words & PRODUCER_CALLS or name in PRODUCER_CALLS:
                    return True
        return False
    if isinstance(node, ast.While):
        idents = identifiers(node.test)
        idents.extend(_assigned_names(node.body))
        return _chunky_words(idents)
    return False


def _assigned_names(stmts) -> List[str]:
    """Assignment-target identifiers anywhere in ``stmts`` (descending
    through try/with/if, NOT into nested defs — their loops report for
    themselves)."""
    out: List[str] = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Assign):
                for t in child.targets:
                    out.extend(identifiers(t))
            elif isinstance(child, (ast.AugAssign, ast.AnnAssign)):
                out.extend(identifiers(child.target))
            visit(child)

    for stmt in stmts:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                out.extend(identifiers(t))
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            out.extend(identifiers(stmt.target))
        visit(stmt)
    return out


def _does_work(node: ast.AST) -> bool:
    """A loop with zero calls in its body is a pure metadata walk."""
    body = node.body + getattr(node, "orelse", [])
    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                return True
    return False


def _has_direct_check(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            name = call_name(n)
            if name in CHECK_CALLS:
                return True
            if name == "check" and isinstance(n.func, ast.Attribute):
                ident = _receiver_ident(n.func).lower()
                if any(w in ident for w in TOKEN_WORDS):
                    return True
            if name == "is_set" and isinstance(n.func, ast.Attribute):
                ident = _receiver_ident(n.func).lower()
                if any(w in ident for w in FLAG_WORDS):
                    return True
        elif isinstance(n, ast.Attribute) and n.attr == "cancelled":
            ident = _receiver_ident(n).lower()
            if not ident or any(w in ident for w in TOKEN_WORDS):
                return True
    return False


def _own_loops(fn: ast.AST):
    """Loop statements belonging to ``fn`` itself (nested defs report
    their own loops when walk_functions yields them)."""

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, (ast.For, ast.While)):
                yield child
            yield from visit(child)

    yield from visit(fn)


class CancelCoverageRule(Rule):
    id = "cancel-coverage"
    description = ("chunk/partition loops on executor, shuffle and "
                   "ingest paths must check their cancel token")

    def __init__(self, critical_modules: Optional[Set[str]] = None):
        self.critical_modules = (frozenset(critical_modules)
                                 if critical_modules is not None
                                 else CANCEL_CRITICAL_MODULES)

    def _loop_covered(self, sf: SourceFile, loop: ast.AST,
                      cls: Optional[str], package: Package) -> bool:
        body = ast.Module(body=list(loop.body), type_ignores=[])
        if _has_direct_check(body):
            return True
        # one level of call-graph following: a body call whose resolved
        # definition contains a direct check covers the loop
        index = package.index()
        for n in ast.walk(body):
            if not isinstance(n, ast.Call):
                continue
            fi = index.resolve_call(sf.rel, n, cls)
            if fi is not None and _has_direct_check(fi.node):
                return True
        return False

    def run(self, package: Package) -> List[Finding]:
        findings: List[Finding] = []
        for sf in package.files:
            if sf.rel not in self.critical_modules:
                continue
            for fn, cls in walk_functions(sf):
                for node in _own_loops(fn):
                    if not _is_chunk_loop(node) or not _does_work(node):
                        continue
                    if self._loop_covered(sf, node, cls, package):
                        continue
                    findings.append(make_finding(
                        self.id, sf, node.lineno,
                        f"chunk loop in {cls + '.' if cls else ''}"
                        f"{fn.name} has no cancel check in its body "
                        "(add check_cancel() at the boundary)"))
        return findings
