"""Single-process plan execution helpers.

The port of the JAX package's ``execution.py``: plan a logical plan,
fuse it (``physical/fusion.py``), execute every partition (concurrently
on the ingest pool, ``ingest.iter_partitions``) and gather the live rows
on the host; ``plan_logical`` renders EXPLAIN and builds EXPLAIN
ANALYZE as the JAX package's does (``physical/explain.py``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .columnar import concat_pydicts
from .datatypes import Float64 as _F64
from .errors import ExecutionError
from . import expr as ex
from .logical import (
    Aggregate,
    Explain,
    Filter,
    LogicalPlan,
    Projection,
    Repartition,
    Sort,
)
from .optimizer import optimize
from .physical.base import PhysicalPlan
from .physical.planner import create_physical_plan


def resolve_scalar_subqueries(plan: LogicalPlan, options=None) -> LogicalPlan:
    """Execute uncorrelated scalar subqueries and inline them as literals.

    Runs before optimization/serialization, so distributed plans never
    carry subquery nodes (the client resolves them, like the reference
    plans SQL client-side — reference: rust/client/src/context.rs:131-144).
    """

    def subquery_value(sq: ex.ScalarSubquery) -> ex.Literal:
        sub = sq.plan
        if sub is None:
            raise ExecutionError(
                "unplanned scalar subquery (correlated scalar subqueries "
                "are only supported in WHERE comparisons)"
            )
        out = collect_physical(plan_logical(sub, options))
        f = sub.schema().fields[0]
        col = out[f.name]
        if len(col) == 0:
            return ex.Literal(None, f.dtype)  # SQL: empty scalar -> NULL
        if len(col) > 1:
            raise ExecutionError(
                f"scalar subquery returned {len(col)} rows"
            )
        v = col[0]
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return ex.Literal(None, f.dtype)
        if f.dtype.kind in ("decimal", "float32", "float64"):
            return ex.Literal(float(v), _F64)
        if f.dtype.kind == "date32":
            days = int(np.asarray(v).astype("datetime64[D]").astype(np.int32))
            return ex.Literal(days, f.dtype)
        if f.dtype.kind == "utf8":
            return ex.Literal(str(v), f.dtype)
        return ex.Literal(int(v), f.dtype)

    return map_scalar_subqueries(plan, subquery_value)


def map_scalar_subqueries(plan: LogicalPlan, value) -> LogicalPlan:
    """Replace, in place, every scalar subquery in ``plan``'s expressions
    with ``value(subquery)``; returns ``plan``."""

    def fix(e: ex.Expr) -> ex.Expr:
        if isinstance(e, ex.ScalarSubquery):
            return value(e)
        for attr in ("expr", "left", "right", "base", "otherwise"):
            if hasattr(e, attr) and isinstance(getattr(e, attr), ex.Expr):
                setattr(e, attr, fix(getattr(e, attr)))
        if hasattr(e, "args"):
            e.args = [fix(a) for a in e.args]
        if hasattr(e, "list"):
            e.list = [fix(a) for a in e.list]
        if hasattr(e, "branches"):
            e.branches = [(fix(w), fix(t)) for w, t in e.branches]
        return e

    def walk(p: LogicalPlan) -> LogicalPlan:
        if isinstance(p, Filter):
            p.predicate = fix(p.predicate)
        elif isinstance(p, Projection):
            p.exprs = [fix(e) for e in p.exprs]
        elif isinstance(p, Aggregate):
            p.group_exprs = [fix(e) for e in p.group_exprs]
            p.agg_exprs = [fix(e) for e in p.agg_exprs]
        elif isinstance(p, Sort):
            p.sort_exprs = [fix(e) for e in p.sort_exprs]
        elif isinstance(p, Repartition) and p.hash_exprs:
            p.hash_exprs = [fix(e) for e in p.hash_exprs]
        for c in p.children():
            walk(c)
        return p

    return walk(plan)


def plan_logical(plan: LogicalPlan, options=None) -> PhysicalPlan:
    """Resolve scalar subqueries, optimize, and plan physically."""
    if isinstance(plan, Explain):
        # render before AND after optimization so EXPLAIN VERBOSE can show
        # what the optimizer did; the rows execute as a normal leaf node
        # (distributed: the text rides the standard shuffle/fetch path)
        from .physical.explain import make_explain_analyze, render_explain

        device = getattr(options, "device", "cpu")
        inner = resolve_scalar_subqueries(plan.input, options)
        unopt = inner.pretty()
        opt = optimize(inner)
        phys = create_physical_plan(opt, options)
        if plan.analyze:
            # EXPLAIN ANALYZE: execute the plan and annotate it with live
            # metrics; the node is a leaf, so distributed runs ship the
            # whole analyzed plan as one task
            return make_explain_analyze(
                phys, plan.verbose, opt.pretty(),
                getattr(options, "adaptive_settings", None), device)
        return render_explain(opt, phys, plan.verbose, device,
                              unoptimized_text=unopt,
                              cost_notes=getattr(options, "cost_notes",
                                                 None))
    plan = resolve_scalar_subqueries(plan, options)
    return create_physical_plan(optimize(plan), options)


def collect(plan: LogicalPlan, options=None) -> Dict[str, np.ndarray]:
    """Logical plan -> dict of numpy arrays (optimize, plan, fuse,
    execute, gather)."""
    from .physical.fusion import maybe_fuse

    return collect_physical(maybe_fuse(plan_logical(plan, options)))


def collect_physical(phys: PhysicalPlan) -> Dict[str, np.ndarray]:
    """Execute all partitions and concatenate live rows on host as a
    dict of numpy arrays (logical values). Partitions run concurrently
    on the ingest pool (batch order is preserved — see
    ingest.iter_partitions); serial when the pipeline is gated off."""
    from .ingest import iter_partitions
    from .lifecycle import check_cancel

    parts: List[Dict[str, np.ndarray]] = []
    for batch in iter_partitions(
            phys, range(phys.output_partitioning().num_partitions)):
        # cooperative cancellation: a fired token (ctx.cancel, the
        # slow-query killer) stops the collect at a batch boundary
        check_cancel()
        parts.append(batch.to_pydict())
    if not parts:
        return {f.name: np.asarray([]) for f in phys.output_schema().fields}
    return concat_pydicts(parts)
