"""Shared scope / import-resolving index over a parsed :class:`Package`.

Every semantic pass needs the same three questions answered:

- what does local name ``X`` in module M refer to? (``import
  torch.nn.functional as F`` -> external ``torch.nn.functional``;
  ``from ..lifecycle import check_cancel`` -> symbol ``check_cancel``
  of ``ballista_tpu_torch/lifecycle.py``)
- what functions/methods does module M define? (qualified as ``f`` or
  ``Class.f``)
- which definition does a call ``f(...)`` / ``self.m(...)`` /
  ``mod.f(...)`` resolve to? (best-effort, *confident* resolutions
  only: an unknown receiver resolves to nothing rather than to every
  same-named method in the package — passes that follow calls must
  never be tricked into marking a loop covered by an unrelated method)

Imports are collected at ANY depth (this codebase imports lazily inside
functions as a matter of style), flattened into one per-module map —
an approximation that is exact in practice because local import aliases
here never shadow differently across functions.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from .engine import Package, SourceFile


class FunctionInfo:
    __slots__ = ("module", "qualname", "node", "cls")

    def __init__(self, module: str, qualname: str, node: ast.AST,
                 cls: Optional[str]):
        self.module = module      # repo-relative path
        self.qualname = qualname  # "f" or "Class.f"
        self.node = node
        self.cls = cls


class ModuleIndex:
    """Per-module name tables."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        # local alias -> ("ext", dotted) | ("mod", rel) | ("sym", rel, name)
        self.imports: Dict[str, Tuple] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self._pkg_files: set = set()

    # -- imports -------------------------------------------------------------

    def _module_parts(self) -> List[str]:
        # "ballista_tpu_torch/io/ipc.py" -> ["ballista_tpu_torch", "io"]:
        # dropping the last segment yields the containing package for plain
        # modules AND for __init__.py (whose dir IS its package)
        return self.sf.rel[:-3].split("/")[:-1]

    def _resolve_module(self, dotted: str, prefix: str) -> Optional[str]:
        """Dotted package-absolute module -> repo-relative file, if the
        target exists in the scanned package."""
        rel = dotted.replace(".", "/")
        if not (rel == prefix or rel.startswith(prefix + "/")):
            return None
        for cand in (rel + ".py", rel + "/__init__.py"):
            if cand in self._pkg_files:
                return cand
        return None

    def collect(self, pkg_files, prefix: str) -> None:
        self._pkg_files = pkg_files
        pkg_parts = self._module_parts()
        for node in ast.walk(self.sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    dotted = a.name if a.asname else a.name.split(".")[0]
                    target = self._resolve_module(dotted, prefix)
                    if target is not None:
                        self.imports[local] = ("mod", target)
                    else:
                        self.imports[local] = ("ext", dotted)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[:len(pkg_parts) - (node.level - 1)] \
                        if node.level > 1 else list(pkg_parts)
                    if node.level - 1 > len(pkg_parts):
                        continue
                    dotted_base = ".".join(base)
                    dotted = (dotted_base + "." + node.module
                              if node.module else dotted_base)
                else:
                    dotted = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    local = a.asname or a.name
                    # "from X import Y": Y is a submodule or a symbol
                    sub = self._resolve_module(dotted + "." + a.name, prefix)
                    if sub is not None:
                        self.imports[local] = ("mod", sub)
                        continue
                    target = self._resolve_module(dotted, prefix)
                    if target is not None:
                        self.imports[local] = ("sym", target, a.name)
                    elif dotted:
                        self.imports[local] = ("ext", dotted + "." + a.name)
        # functions/methods (module level and one class level deep —
        # nested defs are walked for loops but not addressable targets)
        for node in self.sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = FunctionInfo(
                    self.sf.rel, node.name, node, None)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        q = f"{node.name}.{sub.name}"
                        self.functions[q] = FunctionInfo(
                            self.sf.rel, q, sub, node.name)

    def external_root(self, local: str) -> Optional[str]:
        """The top-level external package a local name refers to
        ('numpy', 'torch', ...) or None."""
        entry = self.imports.get(local)
        if entry and entry[0] == "ext":
            return entry[1].split(".")[0]
        return None

    def external_dotted(self, local: str) -> Optional[str]:
        entry = self.imports.get(local)
        if entry and entry[0] == "ext":
            return entry[1]
        return None


class ProjectIndex:
    """All modules' indexes + confident cross-module call resolution."""

    def __init__(self, package: Package):
        self.package = package
        prefixes = {f.rel.split("/")[0] for f in package.files}
        # single-rooted packages in practice; pick the common root
        self.prefix = sorted(prefixes)[0] if prefixes else ""
        pkg_files = set(package.by_rel)
        self.modules: Dict[str, ModuleIndex] = {}
        for sf in package.files:
            mi = ModuleIndex(sf)
            mi.collect(pkg_files, self.prefix)
            self.modules[sf.rel] = mi

    def module(self, rel: str) -> Optional[ModuleIndex]:
        return self.modules.get(rel)

    def resolve_call(self, rel: str, call: ast.Call,
                     cls: Optional[str] = None) -> Optional[FunctionInfo]:
        """Resolve a call site in module ``rel`` (inside class ``cls``
        when given) to its definition, confident cases only:

        - ``f(...)``        -> module-level ``f`` here, or an imported
                               symbol's definition in its home module
        - ``self.m(...)``   -> method ``m`` of the enclosing class
        - ``mod.f(...)``    -> ``f`` in an imported package module
        """
        mi = self.modules.get(rel)
        if mi is None:
            return None
        func = call.func
        if isinstance(func, ast.Name):
            fi = mi.functions.get(func.id)
            if fi is not None:
                return fi
            entry = mi.imports.get(func.id)
            if entry and entry[0] == "sym":
                target = self.modules.get(entry[1])
                if target is not None:
                    return target.functions.get(entry[2])
            return None
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name):
                if base.id in ("self", "cls") and cls:
                    return mi.functions.get(f"{cls}.{func.attr}")
                entry = mi.imports.get(base.id)
                if entry and entry[0] == "mod":
                    target = self.modules.get(entry[1])
                    if target is not None:
                        return target.functions.get(func.attr)
        return None


# -- shared AST helpers -------------------------------------------------------


def walk_functions(sf: SourceFile
                   ) -> Iterator[Tuple[ast.AST, Optional[str]]]:
    """Yield every (function node, enclosing class name) in the file,
    including nested functions (class = the nearest enclosing class)."""

    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, cls
                yield from visit(child, cls)
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, child.name)
            else:
                yield from visit(child, cls)

    yield from visit(sf.tree, None)


def identifiers(node: ast.AST) -> List[str]:
    """Every Name id and Attribute attr under ``node``."""
    out: List[str] = []
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Attribute):
            out.append(n.attr)
        elif isinstance(n, ast.arg):
            out.append(n.arg)
    return out


def name_words(ident: str) -> List[str]:
    """'num_record_batches' -> ['num', 'record', 'batches'] (matching
    vocabulary is word-level so substrings never false-positive)."""
    return [w for w in ident.lower().split("_") if w]


def call_name(call: ast.Call) -> Optional[str]:
    """Terminal name of a call's function expression."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None
