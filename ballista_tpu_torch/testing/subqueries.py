"""What scalar-subquery resolution does to a plan, for the tests and
``chip_smoke.py``: the literals a plan holds, and a recorder of every
``resolve_scalar_subqueries`` call.

Both work on the port's plans and, given its expression module, on any
package whose plans and expressions have the same shape (the JAX
package's, in the tests that twin the two).
"""

from __future__ import annotations

from collections import Counter
from typing import List


def _walk(plan, ex, literals: list, subqueries: list) -> None:
    """Append (value, dtype kind) of each literal in ``plan``'s expressions
    to ``literals`` and each scalar subquery to ``subqueries``, without
    entering the subqueries' own plans."""

    def expr(e):
        if isinstance(e, ex.Literal):
            literals.append((e.value, e.dtype.kind))
            return
        if isinstance(e, ex.ScalarSubquery):
            subqueries.append(e)
            return
        for attr in ("expr", "left", "right", "base", "otherwise"):
            v = getattr(e, attr, None)
            if isinstance(v, ex.Expr):
                expr(v)
        for attr in ("args", "list"):
            for a in getattr(e, attr, None) or []:
                expr(a)
        for w, t in getattr(e, "branches", None) or []:
            expr(w)
            expr(t)

    def node(p):
        if getattr(p, "predicate", None) is not None:
            expr(p.predicate)
        for attr in ("exprs", "group_exprs", "agg_exprs", "sort_exprs",
                     "hash_exprs"):
            for e in getattr(p, attr, None) or []:
                expr(e)
        for c in p.children():
            node(c)

    node(plan)


def _port_expr_module():
    from .. import expr

    return expr


def plan_literals(plan, ex=None) -> List[tuple]:
    """(value, dtype kind) of every literal in ``plan``'s expressions,
    outside the scalar subqueries' own plans. ``ex``: the package's
    expression module (the port's by default)."""
    out: list = []
    _walk(plan, ex or _port_expr_module(), out, [])
    return out


class SubqueryRecorder:
    """While entered, wraps ``module.resolve_scalar_subqueries``: each
    call on a plan that holds scalar subqueries appends to ``records``
    the subqueries' result kinds (``kinds``), the literals the call added
    to the plan (``literals``, sorted) and the port kernel's launches it
    made (``launches``). ``ex``: the package's expression module (the
    port's by default)."""

    def __init__(self, module, ex=None):
        self.module = module
        self.ex = ex or _port_expr_module()
        self.records: List[dict] = []

    def __enter__(self):
        from ..kernels import dense_sums as ds

        real = self.real = self.module.resolve_scalar_subqueries

        def resolve(plan, options=None):
            before: list = []
            subqueries: list = []
            _walk(plan, self.ex, before, subqueries)
            if not subqueries:
                return real(plan, options)
            n0 = ds.launch_count
            out = real(plan, options)
            self.records.append({
                "kinds": [sq.plan.schema().fields[0].dtype.kind
                          for sq in subqueries],
                "launches": ds.launch_count - n0,
                "literals": sorted((Counter(plan_literals(out, self.ex))
                                    - Counter(before)).elements()),
            })
            return out

        self.module.resolve_scalar_subqueries = resolve
        return self

    def __exit__(self, *exc):
        self.module.resolve_scalar_subqueries = self.real
        return False

    def only(self, label: str) -> dict:
        """The one record of a query with one subquery."""
        if len(self.records) != 1 or len(self.records[0]["literals"]) != 1:
            raise AssertionError(f"{label}: expected one resolved subquery, "
                                 f"got {self.records}")
        return self.records[0]
