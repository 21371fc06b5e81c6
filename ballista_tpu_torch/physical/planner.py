"""Physical planner: logical plan -> physical operator tree.

The port of the JAX package's ``physical/planner.py``: each logical node
maps to an operator of this package, with the Partial -> Merge -> Final
aggregate split (or Partial -> hash Repartition -> Final when
``agg.partitions`` asks for a shuffled aggregation), and for joins the
probe/build orientation, the cost-based swap and the co-partitioned join.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..errors import NotImplementedError_
from .. import expr as ex
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
from .join import JoinExec
from .operators import (
    EmptyExec,
    FilterExec,
    LimitExec,
    MergeExec,
    ProjectionExec,
    RepartitionExec,
    ScanExec,
    SortExec,
)


@dataclass
class PlannerOptions:
    """Physical planning knobs (client ``settings`` map them by key).

    ``device``: where operators that create batches from nothing
    (``EmptyExec``, an empty hash partition's join build) put them; scans
    take the device from their source.
    ``join_partition_threshold``: estimated build-side row count above
    which both join inputs are hash-shuffled on the join keys and the join
    runs co-partitioned (partition p joins build[p] x probe[p]) instead of
    merging the whole build side. None disables.
    ``join_partitions``: partition count for such shuffled joins.
    ``join_swap``: cost-based inner-join orientation.
    ``agg_partitions``: hash-shuffled aggregation (partial -> Repartition
    on the group keys -> final) into this many partitions; None merges.
    """

    device: torch.device = torch.device("cpu")
    join_partition_threshold: Optional[int] = 1_000_000
    join_partitions: int = 8
    join_swap: bool = True
    agg_partitions: Optional[int] = None

    @staticmethod
    def from_settings(settings: Optional[Dict[str, str]],
                      device) -> "PlannerOptions":
        opts = PlannerOptions(device=torch.device(device))
        s = settings or {}
        if "join.partitioned.threshold" in s:
            v = s["join.partitioned.threshold"]
            opts.join_partition_threshold = (
                None if v in ("", "off", "none") else int(v)
            )
        if "join.partitions" in s:
            opts.join_partitions = int(s["join.partitions"])
        swap = s.get("join.swap",
                     os.environ.get("BALLISTA_JOIN_SWAP", "on")).lower()
        if swap in ("off", "0", "false"):
            opts.join_swap = False
        elif swap not in ("on", "1", "true", ""):
            logging.getLogger("ballista.planner").warning(
                "unrecognized join.swap value %r; keeping swap ON", swap)
        if "agg.partitions" in s:
            v = s["agg.partitions"]
            opts.agg_partitions = None if v in ("", "off", "none") else int(v)
        return opts


def create_physical_plan(
    plan: LogicalPlan, options: Optional[PlannerOptions] = None
) -> PhysicalPlan:
    return _create(plan, options or PlannerOptions())


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
        if opts.agg_partitions and plan.group_exprs:
            # shuffled aggregation: co-locate groups by hashing the
            # materialized group columns, final-aggregate per partition
            shuffled = RepartitionExec(
                partial, opts.agg_partitions,
                [ex.ColumnRef(e.name()) for e in plan.group_exprs],
            )
            return HashAggregateExec("final", plan.group_exprs,
                                     plan.agg_exprs, shuffled)
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
        return RepartitionExec(
            create_physical_plan(plan.input), plan.num_partitions, plan.hash_exprs
        )

    if isinstance(plan, Join):
        return _plan_join(plan, create_physical_plan(plan.left),
                          create_physical_plan(plan.right), opts)

    if isinstance(plan, EmptyRelation):
        return EmptyExec(opts.device, plan.produce_one_row)

    raise NotImplementedError_(f"no physical plan for {type(plan).__name__}")


def _plan_join(plan: Join, left: PhysicalPlan, right: PhysicalPlan,
               opts: PlannerOptions) -> PhysicalPlan:
    # Probe side = the row-preserving side; the build side is merged to
    # one partition (or co-partitioned) and tabled (see JoinExec).
    if plan.how == "inner":
        build, probe, how = left, right, "inner"
        on = list(plan.on)
    elif plan.how == "left":
        build, probe, how = right, left, "left"
        on = [(r, l) for l, r in plan.on]
    elif plan.how == "right":
        build, probe, how = left, right, "left"
        on = list(plan.on)
    elif plan.how == "full":
        # build = right, probe = left; JoinExec streams every probe
        # partition itself and appends the unmatched build rows
        build, probe, how = right, left, "full"
        on = [(r, l) for l, r in plan.on]
    elif plan.how in ("semi", "anti"):
        build, probe, how = right, left, plan.how
        on = [(r, l) for l, r in plan.on]
    else:
        raise NotImplementedError_(f"join type {plan.how}")
    threshold = opts.join_partition_threshold
    # null-aware anti joins (NOT IN) must see the WHOLE build side: one
    # NULL subquery value empties every partition's result
    partitionable = (not plan.null_aware and threshold is not None
                     and how != "full")
    # Inner joins are symmetric and the projection below restores column
    # order, so orient by cost. Co-partitioned: build the LARGER side
    # (output capacities ride the probe side). Merged: build the SMALLER
    # side (a small unique build keeps probes off the expanding path).
    # Skipped when the sides share column names (JoinExec resolves
    # collisions build-first) or estimates are unknown.
    if plan.how == "inner" and opts.join_swap:
        le, re_ = build.estimated_rows(), probe.estimated_rows()
        collide = (set(build.output_schema().names())
                   & set(probe.output_schema().names()))
        if not collide and le is not None and re_ is not None:
            want_larger_build = partitionable and min(le, re_) > threshold
            if (re_ > le) == want_larger_build and re_ != le:
                build, probe = probe, build
                on = [(p, b) for b, p in on]
    est = build.estimated_rows() if partitionable else None
    if partitionable and est is not None and est > threshold:
        # co-partitioned join: hash-shuffle BOTH sides on the join keys
        # with the same partition count, so each partition joins one
        # bucket and none holds the whole build side
        n = opts.join_partitions
        build = RepartitionExec(build, n, [ex.ColumnRef(b) for b, _ in on])
        probe = RepartitionExec(probe, n, [ex.ColumnRef(p) for _, p in on])
        joined: PhysicalPlan = JoinExec(build, probe, on, how,
                                        null_aware=plan.null_aware,
                                        partitioned=True, device=opts.device)
    else:
        if build.output_partitioning().num_partitions > 1:
            build = MergeExec(build)
        joined = JoinExec(build, probe, on, how, null_aware=plan.null_aware,
                          device=opts.device)
    # restore logical column order if the physical (build-first) order
    # differs (e.g. preserved-left joins probe the left side)
    want = plan.schema().names()
    if want != joined.output_schema().names():
        joined = ProjectionExec([ex.ColumnRef(n) for n in want], joined)
    return joined
