"""h2d-discipline: scan-side host->device upload sites must route
through the device-residency layer.

The warm-path table cache (``cache/residency.py``) pins hot scan outputs
on the device so repeat scans skip parse AND the upload entirely. That
only works if every table-source upload funnels through ONE integration
point — ``serve_or_fill`` — with the actual uploads living in the
produce callback behind it. A scan source that uploads directly from
``scan()`` (or never routes through the residency layer at all) re-pays
the upload on every query, and its bytes are invisible to the
device-memory governor.

The JAX package's rule, with the upload sites of torch. Scope: modules
under an ``io/`` package directory that implement a table source
(define a class with a ``scan`` method). Upload sites:

- ``ColumnBatch.from_numpy(...)`` — the engine's canonical batch
  upload (any ``.from_numpy`` whose receiver is not torch itself);
- ``torch.as_tensor(...)`` / ``torch.tensor(...)`` / ``torch.from_numpy
  (...)`` with a ``device=`` argument (``torch.from_numpy`` alone is a
  host view; its upload is the ``.to`` below);
- ``<x>.to(<device>)`` — a device argument (a ``device=`` keyword, a
  string, ``torch.device(...)``, or a name or attribute naming a
  device), not a dtype;
- ``<x>.cuda()``;
- ``_upload(...)`` — the port's pinned-staging upload helper
  (``columnar._upload``).

A site is covered when its module routes scans through
``serve_or_fill`` AND the site sits outside the ``scan`` method body
(i.e. behind the residency layer's produce callback, conventionally
``_scan_direct``). Anything else is a finding: route the source
through the residency layer, or suppress with
``# ballista: ignore[h2d-discipline]`` and a reason (e.g. memtables,
whose batches are uploaded once at registration and are already
permanently resident).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..engine import Finding, Package, Rule, make_finding

# torch constructors that place data on the device named by ``device=``
_DEVICE_CTORS = frozenset({"as_tensor", "tensor", "from_numpy"})
# the port's pinned-staging upload helper (columnar.py)
_UPLOAD_HELPERS = frozenset({"_upload"})


def _scan_source_module(tree: ast.AST) -> bool:
    """True when the module defines a class with a ``scan`` method
    (a TableSource implementor — shuffle IPC codecs are out of
    scope)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and item.name == "scan":
                    return True
    return False


def _routes_through_residency(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = (f.id if isinstance(f, ast.Name)
                    else f.attr if isinstance(f, ast.Attribute) else "")
            if name == "serve_or_fill":
                return True
    return False


def _scan_ranges(tree: ast.AST) -> List[Tuple[int, int]]:
    """Line ranges of every ``scan`` method body — uploads there run
    in FRONT of the residency layer, which is the violation."""
    return [
        (node.lineno, node.end_lineno or node.lineno)
        for node in ast.walk(tree)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and node.name == "scan"
    ]


def _names_device(expr: ast.AST, torch_aliases: Set[str]) -> bool:
    """Whether ``expr`` (a ``.to`` argument) names a device rather than
    a dtype."""
    if isinstance(expr, ast.Constant):  # "cuda", "cuda:0"; "cpu" is not
        return isinstance(expr.value, str) and expr.value != "cpu"
    if isinstance(expr, ast.Call):
        f = expr.func
        return isinstance(f, ast.Attribute) and f.attr == "device" and \
            isinstance(f.value, ast.Name) and f.value.id in torch_aliases
    ident = (expr.id if isinstance(expr, ast.Name)
             else expr.attr if isinstance(expr, ast.Attribute) else "")
    ident = ident.lower()
    return "device" in ident or ident in ("dev", "cuda")


class H2dDisciplineRule(Rule):
    id = "h2d-discipline"
    description = ("scan-side H2D upload sites must route through the "
                   "device-residency layer (cache/residency.py)")

    def _torch_aliases(self, package: Package, rel: str) -> Set[str]:
        mi = package.index().module(rel)
        if mi is None:
            return set()
        return {local for local in mi.imports
                if mi.external_root(local) == "torch"}

    def run(self, package: Package) -> List[Finding]:
        findings: List[Finding] = []
        for sf in package.files:
            parts = sf.rel.split("/")
            if "io" not in parts[:-1]:
                continue
            if sf.tree is None or not _scan_source_module(sf.tree):
                continue
            torch_aliases = self._torch_aliases(package, sf.rel)
            routed = _routes_through_residency(sf.tree)
            scan_spans = _scan_ranges(sf.tree)
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                kind = self._upload_kind(node, torch_aliases)
                if kind is None:
                    continue
                in_scan = any(lo <= node.lineno <= hi
                              for lo, hi in scan_spans)
                if routed and not in_scan:
                    continue
                why = ("inside scan() in front of the residency layer"
                       if routed else
                       "in a module that never routes through "
                       "serve_or_fill")
                findings.append(make_finding(
                    self.id, sf, node.lineno,
                    f"{kind} {why} (move uploads behind "
                    "cache.residency.serve_or_fill's produce callback "
                    "or suppress with a reason)"))
        return findings

    @staticmethod
    def _upload_kind(call: ast.Call,
                     torch_aliases: Set[str]) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in _UPLOAD_HELPERS:
                return f"{f.id} upload"
            return None
        if not isinstance(f, ast.Attribute):
            return None
        base = f.value
        on_torch = isinstance(base, ast.Name) and base.id in torch_aliases
        if on_torch and f.attr in _DEVICE_CTORS:
            if any(kw.arg == "device" for kw in call.keywords):
                return f"torch.{f.attr}(device=...) upload"
            return None
        if f.attr == "from_numpy":
            return "ColumnBatch.from_numpy upload"
        if f.attr in _UPLOAD_HELPERS:
            return f"{f.attr} upload"
        if f.attr == "cuda" and not on_torch:
            return ".cuda() upload"
        if f.attr == "to" and not on_torch:
            if any(kw.arg == "device" for kw in call.keywords) or (
                    call.args and _names_device(call.args[0],
                                                torch_aliases)):
                return ".to(device) upload"
        return None
