"""Physical planner: logical plan -> physical operator tree.

The port of the JAX package's ``physical/planner.py``: each logical node
maps to an operator of this package, with the Partial -> Merge -> Final
aggregate split. Joins and repartitioning are not ported yet and raise
``NotImplementedError_``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..errors import NotImplementedError_
from ..logical import (
    Aggregate,
    EmptyRelation,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Projection,
    Repartition,
    Sort,
    TableScan,
)
from .aggregate import HashAggregateExec
from .base import PhysicalPlan
from .operators import (
    EmptyExec,
    FilterExec,
    LimitExec,
    MergeExec,
    ProjectionExec,
    ScanExec,
    SortExec,
)


@dataclass
class PlannerOptions:
    """Physical planning knobs (client ``settings`` map them by key).

    ``device``: where operators that create batches from nothing
    (``EmptyExec``) put them; scans take the device from their source.
    The JAX package's join and shuffled-aggregation knobs have no
    operator to steer here yet: a setting that asks for a shuffled
    aggregation (``agg.partitions``) raises.
    """

    device: torch.device = torch.device("cpu")

    @staticmethod
    def from_settings(settings: Optional[Dict[str, str]],
                      device) -> "PlannerOptions":
        if (settings or {}).get("agg.partitions", "") not in ("", "off",
                                                              "none"):
            raise _not_ported("hash-shuffled aggregation (agg.partitions)")
        return PlannerOptions(device=torch.device(device))


def create_physical_plan(
    plan: LogicalPlan, options: Optional[PlannerOptions] = None
) -> PhysicalPlan:
    return _create(plan, options or PlannerOptions())


def _not_ported(what: str) -> NotImplementedError_:
    return NotImplementedError_(
        f"{what} is not ported yet: ROADMAP queue 1 item 6")


def _create(plan: LogicalPlan, opts: PlannerOptions) -> PhysicalPlan:
    def create_physical_plan(p):  # threads opts through the recursion
        return _create(p, opts)

    if isinstance(plan, TableScan):
        return ScanExec(plan.table_name, plan.source, plan.projection)

    if isinstance(plan, Projection):
        return ProjectionExec(plan.exprs, create_physical_plan(plan.input))

    if isinstance(plan, Filter):
        return FilterExec(plan.predicate, create_physical_plan(plan.input))

    if isinstance(plan, Aggregate):
        child = create_physical_plan(plan.input)
        partial = HashAggregateExec("partial", plan.group_exprs, plan.agg_exprs, child)
        merged: PhysicalPlan = partial
        if partial.output_partitioning().num_partitions > 1:
            merged = MergeExec(partial)
        return HashAggregateExec("final", plan.group_exprs, plan.agg_exprs, merged)

    if isinstance(plan, Sort):
        child = create_physical_plan(plan.input)
        if child.output_partitioning().num_partitions > 1:
            child = MergeExec(child)
        return SortExec(plan.sort_exprs, child)

    if isinstance(plan, Limit):
        child = create_physical_plan(plan.input)
        if child.output_partitioning().num_partitions > 1:
            child = MergeExec(child)
        return LimitExec(plan.n, child)

    if isinstance(plan, Repartition):
        raise _not_ported("RepartitionExec")

    if isinstance(plan, Join):
        raise _not_ported(f"{plan.how} join (JoinExec)")

    if isinstance(plan, EmptyRelation):
        return EmptyExec(opts.device, plan.produce_one_row)

    raise NotImplementedError_(f"no physical plan for {type(plan).__name__}")
