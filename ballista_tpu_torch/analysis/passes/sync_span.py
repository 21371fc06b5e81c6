"""sync-span: host syncs on device values must sit inside a
``device.block`` tracing span.

The profiler's lane decomposition attributes query wall time to lanes;
``device_blocked`` is computed as the sum of ``device.block`` spans, so
a blocking sync OUTSIDE such a span silently shifts device time into
whatever lane encloses it. This pass makes the attribution honest by
construction. It is the JAX package's rule with the sync sites of
torch:

- ``<x>.item()`` — scalar host read (flagged whatever the receiver, as
  the JAX rule does; suppress with a reason where the receiver provably
  never holds a device tensor);
- ``<x>.cpu()`` and ``<x>.to("cpu")`` (or ``device="cpu"``,
  ``torch.device("cpu")``) — the explicit device-to-host copy;
- ``<x>.tolist()`` and ``<x>.numpy()`` where ``x`` is
  *device-provenance* (below);
- ``torch.cuda.synchronize(...)`` and ``<event or stream>.synchronize()``;
- ``np.asarray(X)`` where ``X`` is device-provenance.

Device provenance: an attribute read of a ColumnBatch/Column device
buffer (``.values`` / ``.validity`` / ``.selection`` / ``.num_rows``),
a ``torch.*`` call (other than the host-side API below, and other than
a constructor without a ``device=``, which makes a host tensor), or a
local name assigned from either. Host-side ``np.asarray`` over parsed
Python lists/numpy inputs is NOT flagged — provenance, not the call, is
what makes it a sync.

A candidate is covered when it sits lexically inside a ``with
trace_span("device.block", ...)`` block (module-local containment —
the span need not be in the same function, a wrapper's span covers the
wrapped body). Everything else is a finding: wrap it with a span
carrying a ``site=`` attribute, or suppress with
``# ballista: ignore[sync-span]`` and a reason.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..callgraph import walk_functions
from ..engine import Finding, Package, Rule, SourceFile, make_finding

DEVICE_ATTRS = frozenset({"values", "validity", "selection", "num_rows"})

# torch's host-side API: returns Python objects or host tensors, never a
# device value — a name assigned from these carries NO device provenance
HOST_TORCH_CALLS = frozenset({
    "device", "from_numpy", "get_num_threads", "is_tensor",
    "device_count", "is_available", "get_device_name", "current_device",
    "finfo", "iinfo", "Size", "Generator",
})

# torch constructors: a host tensor unless given a ``device=``
TORCH_CTORS = frozenset({
    "empty", "zeros", "ones", "full", "arange", "tensor", "as_tensor",
    "linspace", "rand", "randn", "randint", "randperm",
})

# modules whose whole business is recording/deciding, not executing —
# the span machinery itself must not be asked to span itself
SKIP_FILES = frozenset({
    "ballista_tpu_torch/observability/tracing.py",
})


def _span_ranges(sf: SourceFile) -> List[Tuple[int, int]]:
    """(start, end) line ranges of every ``with trace_span("device.block"
    ...)`` body in the file."""
    ranges: List[Tuple[int, int]] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            call = item.context_expr
            if not isinstance(call, ast.Call):
                continue
            fname = (call.func.id if isinstance(call.func, ast.Name)
                     else call.func.attr
                     if isinstance(call.func, ast.Attribute) else "")
            if fname != "trace_span" or not call.args:
                continue
            first = call.args[0]
            if isinstance(first, ast.Constant) and \
                    first.value == "device.block":
                ranges.append((node.lineno, node.end_lineno or node.lineno))
                break
    return ranges


def _covered(line: int, ranges: List[Tuple[int, int]]) -> bool:
    return any(lo <= line <= hi for lo, hi in ranges)


def _to_cpu(call: ast.Call, torch_aliases: Set[str]) -> bool:
    """Whether a ``.to(...)`` call moves to the CPU."""

    def is_cpu(expr) -> bool:
        if isinstance(expr, ast.Constant):
            return expr.value == "cpu"
        if isinstance(expr, ast.Call) and \
                isinstance(expr.func, ast.Attribute) and \
                expr.func.attr == "device" and \
                isinstance(expr.func.value, ast.Name) and \
                expr.func.value.id in torch_aliases and expr.args:
            return is_cpu(expr.args[0])
        return False

    if call.args and is_cpu(call.args[0]):
        return True
    return any(kw.arg == "device" and is_cpu(kw.value)
               for kw in call.keywords)


class _Provenance:
    """Per-function map of local names assigned from device values."""

    def __init__(self, fn: ast.AST, torch_aliases: Set[str]):
        self.torch_aliases = torch_aliases
        self.device_names: Set[str] = set()
        # two passes so order of assignment vs use doesn't matter
        for _ in range(2):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    if self.is_device(node.value):
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                self.device_names.add(t.id)

    def is_device(self, expr: ast.AST) -> bool:
        expr = self._unwrap(expr)
        if isinstance(expr, ast.Attribute):
            return expr.attr in DEVICE_ATTRS
        if isinstance(expr, ast.Name):
            return expr.id in self.device_names
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self.is_device(e) for e in expr.elts)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Attribute) and f.attr in HOST_TORCH_CALLS:
                return False
            if isinstance(f, ast.Attribute) and f.attr in TORCH_CTORS \
                    and not any(kw.arg == "device" for kw in expr.keywords):
                return False
            root = f
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and \
                    root.id in self.torch_aliases:
                return True
        return False

    @staticmethod
    def _unwrap(expr: ast.AST) -> ast.AST:
        while isinstance(expr, (ast.Subscript, ast.Starred)):
            expr = expr.value
        return expr


class SyncSpanRule(Rule):
    id = "sync-span"
    description = ("implicit device->host syncs must run inside a "
                   "device.block span (profiler lane honesty)")

    def __init__(self, skip_files: Optional[Set[str]] = None):
        self.skip_files = (frozenset(skip_files) if skip_files is not None
                           else SKIP_FILES)

    def _aliases(self, package: Package, rel: str
                 ) -> Tuple[Set[str], Set[str]]:
        mi = package.index().module(rel)
        np_aliases: Set[str] = set()
        torch_aliases: Set[str] = set()
        if mi is None:
            return np_aliases, torch_aliases
        for local in mi.imports:
            root = mi.external_root(local)
            if root == "numpy":
                np_aliases.add(local)
            elif root == "torch":
                torch_aliases.add(local)
        return np_aliases, torch_aliases

    def run(self, package: Package) -> List[Finding]:
        findings: List[Finding] = []
        for sf in package.files:
            if sf.rel in self.skip_files:
                continue
            np_aliases, torch_aliases = self._aliases(package, sf.rel)
            spans = _span_ranges(sf)
            seen: Set[Tuple[int, int]] = set()  # nested defs walk twice
            for fn, _cls in walk_functions(sf):
                prov = _Provenance(fn, torch_aliases)
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    pos = (node.lineno, node.col_offset)
                    if pos in seen:
                        continue
                    hit = self._classify(node, prov, np_aliases,
                                         torch_aliases)
                    if hit is None:
                        continue
                    seen.add(pos)
                    if _covered(node.lineno, spans):
                        continue
                    findings.append(make_finding(
                        self.id, sf, node.lineno,
                        f"{hit} outside a device.block span (wrap with "
                        "trace_span(\"device.block\", site=...) or "
                        "suppress with a reason)"))
        return findings

    def _classify(self, call: ast.Call, prov: _Provenance,
                  np_aliases: Set[str], torch_aliases: Set[str]
                  ) -> Optional[str]:
        f = call.func
        if not isinstance(f, ast.Attribute):
            return None
        base = f.value
        bare = not call.args and not call.keywords
        if f.attr == "item" and bare:
            return "scalar .item() sync"
        if f.attr == "cpu" and bare:
            return ".cpu() sync"
        if f.attr == "to" and _to_cpu(call, torch_aliases):
            return ".to(\"cpu\") sync"
        if f.attr == "synchronize":
            return f"{_dotted(f)} sync"
        if f.attr in ("tolist", "numpy") and bare and prov.is_device(base):
            return f".{f.attr}() on a device value"
        if f.attr == "asarray" and isinstance(base, ast.Name) \
                and base.id in np_aliases and call.args:
            # dtype=object arrays are host-only by construction
            # (dictionary value tables, not device buffers)
            for kw in call.keywords:
                if kw.arg == "dtype" and \
                        isinstance(kw.value, ast.Name) and \
                        kw.value.id == "object":
                    return None
            if prov.is_device(call.args[0]):
                return "np.asarray on a device value"
        return None


def _dotted(f: ast.Attribute) -> str:
    """'torch.cuda.synchronize', 'event.synchronize', ... for a message."""
    parts = [f.attr]
    node = f.value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.append("<call>")
    return ".".join(reversed(parts))
