"""Distributed planner: physical plan -> stage DAG.

The port's copy of the JAX package's ``distributed/planner.py``.
Re-implements the reference's ``DistributedPlanner`` splitting rules
(reference: rust/scheduler/src/planner.rs:96-198):

- a ``MergeExec`` boundary turns its child into a new query stage and
  replaces it with an ``UnresolvedShuffleExec``;
- a final-mode ``HashAggregateExec``'s child (the partial side) becomes a
  stage;
- an output-partitioning change (RepartitionExec) becomes a stage whose
  output is hash-partitioned at materialization time;
- join children pass through (the build side's MergeExec already forms a
  stage).

Stage ids start at 1 (reference: planner.rs:201-204); the root plan becomes
the final stage.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..errors import PlanError
from ..physical.aggregate import HashAggregateExec
from ..physical.base import PhysicalPlan
from ..physical.join import JoinExec
from ..physical.operators import MergeExec, RepartitionExec
from ..physical.shuffle import (
    QueryStageExec,
    ShuffleReaderExec,
    UnresolvedShuffleExec,
)
from .types import PartitionLocation


class DistributedPlanner:
    def __init__(self):
        self._next_stage_id = 0

    def _new_stage_id(self) -> int:
        self._next_stage_id += 1
        return self._next_stage_id

    def plan_query_stages(
        self, job_id: str, plan: PhysicalPlan
    ) -> List[QueryStageExec]:
        """Returns all stages; the last one is the final (root) stage."""
        new_plan, stages = self._plan_internal(job_id, plan)
        stages.append(QueryStageExec(job_id, self._new_stage_id(), new_plan))
        return stages

    def _plan_internal(
        self, job_id: str, plan: PhysicalPlan
    ) -> Tuple[PhysicalPlan, List[QueryStageExec]]:
        stages: List[QueryStageExec] = []
        children = plan.children()
        if not children:
            return plan, stages

        new_children: List[PhysicalPlan] = []
        for child in children:
            c_plan, c_stages = self._plan_internal(job_id, child)
            stages.extend(c_stages)
            new_children.append(c_plan)

        if isinstance(plan, RepartitionExec):
            # hash-partitioned shuffle: the producing stage's tasks (one per
            # child partition) write one shuffle-q file per consumer
            # partition; the consumer reads the q-files of every producer
            child = new_children[0]
            stage = QueryStageExec(
                job_id, self._new_stage_id(), child,
                shuffle_hash_exprs=plan.hash_exprs,
                shuffle_output_partitions=plan.num_partitions,
            )
            stages.append(stage)
            return (
                UnresolvedShuffleExec(
                    [stage.stage_id], child.output_schema(),
                    plan.num_partitions,
                ),
                stages,
            )

        if isinstance(plan, MergeExec):
            # child becomes a stage; this node reads its shuffled output
            child = new_children[0]
            stage = QueryStageExec(job_id, self._new_stage_id(), child)
            stages.append(stage)
            unresolved = UnresolvedShuffleExec(
                [stage.stage_id],
                child.output_schema(),
                child.output_partitioning().num_partitions,
            )
            return plan.with_new_children([unresolved]), stages

        if isinstance(plan, HashAggregateExec) and plan.mode == "final":
            child = new_children[0]
            if not isinstance(child, UnresolvedShuffleExec):
                stage = QueryStageExec(job_id, self._new_stage_id(), child)
                stages.append(stage)
                child = UnresolvedShuffleExec(
                    [stage.stage_id],
                    stage.output_schema(),
                    stage.output_partitioning().num_partitions,
                )
            return plan.with_new_children([child]), stages

        return plan.with_new_children(new_children), stages


def find_unresolved_shuffles(plan: PhysicalPlan) -> List[UnresolvedShuffleExec]:
    """(reference: state/mod.rs:372-385)"""
    out = []
    if isinstance(plan, UnresolvedShuffleExec):
        out.append(plan)
    for c in plan.children():
        out.extend(find_unresolved_shuffles(c))
    return out


def remove_unresolved_shuffles(
    plan: PhysicalPlan,
    locations: Dict[int, List[PartitionLocation]],  # stage_id -> locations
    reader_info: "Dict[int, dict] | None" = None,
    *,
    device,
) -> PhysicalPlan:
    """Substitute resolved ShuffleReaderExecs (reference:
    planner.rs:236-269).

    ``reader_info`` (stage_id -> {"read_partitions", "hash_columns",
    "original_partitions"}) carries the adaptive reader layout and the
    producing stage's hash-partitioning columns into the reader, so the
    in-task plan both respects AQE decisions and reports trustworthy
    co-partitioning (the ``Partitioning("unknown", n)`` fix).

    ``device`` (the port's one change to this module): where the readers'
    batches land."""
    if isinstance(plan, UnresolvedShuffleExec):
        locs: List[PartitionLocation] = []
        for sid in plan.query_stage_ids:
            if sid not in locations:
                raise PlanError(f"no locations for stage {sid}")
            locs.extend(
                sorted(locations[sid], key=lambda l: l.partition_id)
            )
        info = {}
        if reader_info and len(plan.query_stage_ids) == 1:
            info = reader_info.get(plan.query_stage_ids[0]) or {}
        return ShuffleReaderExec(
            locs, plan.output_schema(),
            read_partitions=info.get("read_partitions"),
            hash_columns=tuple(info.get("hash_columns") or ()),
            original_partitions=info.get("original_partitions", 0),
            device=device,
        )
    children = plan.children()
    if not children:
        return plan
    return plan.with_new_children(
        [remove_unresolved_shuffles(c, locations, reader_info, device=device)
         for c in children]
    )
