"""Run a query stage by stage through Arrow IPC shuffle files, without
a scheduler or executors.

A thin runner for what a ``LocalCluster`` cannot express: a query whose
first stages another writer ran (the JAX package, in the tests), read
and finished here. Everything else runs through the port's cluster
(``distributed/executor.py``). In one process and without RPC it:

1. plans the query (``execution.plan_logical``, the context's settings);
2. cuts it into stages (``DistributedPlanner.plan_query_stages``);
3. for each stage in order, resolves its inputs into ``ShuffleReaderExec``
   nodes over the locations written so far (``remove_unresolved_shuffles``,
   hash-shuffled producers expanded into one location per consumer
   partition, as the scheduler's ``_expand_shuffle_locations`` does);
4. ships the stage through protobuf (``physical_to_proto`` ->
   ``SerializeToString`` -> ``ParseFromString`` -> ``physical_from_proto``
   on the context's device);
5. fuses it (``maybe_fuse``, as the executor does after deserializing);
6. executes each partition and writes it with the executor's own writes:
   ``write_shuffled`` for a stage with ``shuffle_output_partitions``,
   ``write_partition`` for any other;
7. reads the final stage's files back through a ``ShuffleReaderExec``
   and collects them.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .. import expr as ex
from .. import serde
from ..client import _plan_nodes
from ..distributed.dataplane import shuffle_file_name
from ..distributed.executor import write_partition, write_shuffled
from ..distributed.planner import (DistributedPlanner,
                                   find_unresolved_shuffles,
                                   remove_unresolved_shuffles)
from ..distributed.types import PartitionId, PartitionLocation
from ..proto import ballista_pb2 as pb

_JOB_SEQ = itertools.count(1)


@dataclass
class StageRecord:
    """What one stage that ran here was and read."""

    stage_id: int
    partitions: int
    fan_out: int  # shuffle_output_partitions (0: merge-style output)
    deps: List[int]
    plan: object  # the deserialized, fused plan that ran
    bytes_read: int = 0


@dataclass
class StagedRun:
    job_id: str
    result: Dict[str, np.ndarray]
    stages: List[StageRecord] = field(default_factory=list)


def _hash_column_names(hash_exprs) -> tuple:
    """Plain-column names of a stage's hash expressions (the readers'
    co-partitioning), or () when one is not a plain column."""
    names = []
    for e in hash_exprs or ():
        if not isinstance(e, ex.ColumnRef):
            return ()
        names.append(e.column)
    return tuple(names)


def _expand_shuffle_locations(locs, n_out: int):
    """Per-producer locations -> one location per (producer, consumer
    partition) shuffle file."""
    out = []
    for loc in locs:
        base = os.path.dirname(loc.path) if loc.path else ""
        for q in range(n_out):
            out.append(PartitionLocation(
                job_id=loc.job_id, stage_id=loc.stage_id,
                partition_id=loc.partition_id, executor_id=loc.executor_id,
                host=loc.host, port=loc.port,
                path=os.path.join(base, shuffle_file_name(q)) if base else "",
                stats=loc.stats, shuffle_output=q))
    return out


def ship(plan, device):
    """One protobuf round trip of a physical plan onto ``device``."""
    wire = serde.physical_to_proto(plan).SerializeToString()
    node = pb.PhysicalPlanNode()
    node.ParseFromString(wire)
    return serde.physical_from_proto(node, device=device)


def _bytes_read(plan) -> int:
    from ..physical.shuffle import ShuffleReaderExec

    return sum(int(node.metrics().values().get("bytes_read", 0))
               for node in _plan_nodes(plan)
               if isinstance(node, ShuffleReaderExec))


def run_staged(ctx, sql: str, work_dir: str, job_id: Optional[str] = None,
               written: Optional[Dict[int, List[PartitionLocation]]] = None
               ) -> StagedRun:
    """Run ``sql`` on ``ctx``'s device stage by stage (module doc);
    returns the result (as ``to_pydict``) and per-stage records.
    ``written`` maps stage ids another writer already ran (the JAX
    package, in the tests) to their per-producer locations under
    ``job_id``: those stages are read, not run."""
    from ..execution import collect_physical, plan_logical
    from ..ingest import cancel_plan, prime_plan
    from ..physical.fusion import maybe_fuse
    from ..physical.shuffle import ShuffleReaderExec

    device = ctx.device
    job_id = job_id or f"staged{os.getpid()}x{next(_JOB_SEQ)}"
    phys = plan_logical(ctx.sql(sql).plan, ctx._planner_options())
    stages = DistributedPlanner().plan_query_stages(job_id, phys)

    run = StagedRun(job_id, {})
    locations: Dict[int, List[PartitionLocation]] = {}
    specs: Dict[int, tuple] = {}  # stage id -> (hash exprs, n_out)
    for stage in stages:
        if stage.shuffle_output_partitions:
            specs[stage.stage_id] = (stage.shuffle_hash_exprs,
                                     stage.shuffle_output_partitions)
        if written and stage.stage_id in written:
            locations[stage.stage_id] = written[stage.stage_id]
            continue
        deps = [sid for u in find_unresolved_shuffles(stage.child)
                for sid in u.query_stage_ids]
        locs, info = {}, {}
        for dep in deps:
            if dep in specs:
                hx, n_out = specs[dep]
                locs[dep] = _expand_shuffle_locations(locations[dep],
                                                      n_out)
                info[dep] = {"hash_columns": _hash_column_names(hx),
                             "original_partitions": n_out}
            else:
                locs[dep] = locations[dep]
        plan = remove_unresolved_shuffles(stage.child, locs, info,
                                          device=device)
        plan = maybe_fuse(ship(plan, device))
        nparts = stage.output_partitioning().num_partitions
        n_out = stage.shuffle_output_partitions
        rec = StageRecord(stage.stage_id, nparts, n_out, deps, plan)
        out_locs = []
        for p in range(nparts):
            prime_plan(plan, partitions=[p])
            pid = PartitionId(job_id, stage.stage_id, p)
            try:
                if n_out:
                    st = write_shuffled(plan, pid, work_dir,
                                        stage.shuffle_hash_exprs, n_out)
                else:
                    st = write_partition(plan, pid, work_dir)
                    st.pop("write_seconds")
            finally:
                cancel_plan(plan)
            path = st.pop("path")
            out_locs.append(PartitionLocation(
                job_id, stage.stage_id, p, "staged", "", 0, path=path,
                stats=st))
        rec.bytes_read = _bytes_read(plan)
        for node in _plan_nodes(plan):
            node.release()
        locations[stage.stage_id] = out_locs
        run.stages.append(rec)
    final = ShuffleReaderExec(locations[stages[-1].stage_id],
                              stages[-1].output_schema(), device=device)
    run.result = collect_physical(final)
    return run


def stage_dag(stages) -> List[tuple]:
    """(stage id, partitions, shuffle fan-out, node class names in
    pre-order) of each planned stage: the shape two planners are
    compared on."""
    out = []
    for st in stages:
        out.append((st.stage_id, st.output_partitioning().num_partitions,
                    st.shuffle_output_partitions,
                    tuple(type(n).__name__ for n in _plan_nodes(st.child))))
    return out
