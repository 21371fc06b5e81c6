"""Run a query stage by stage through Arrow IPC shuffle files, without
a scheduler or executors.

This reproduces, in one process and without RPC, what the JAX package's
scheduler and executor do with the port's data-plane modules
(ROADMAP queue 1 item 9 replaces its use with the port's
``LocalCluster``):

1. plan the query (``execution.plan_logical``, the context's settings);
2. cut it into stages (``DistributedPlanner.plan_query_stages``);
3. for each stage in order, resolve its inputs into ``ShuffleReaderExec``
   nodes over the locations written so far (``remove_unresolved_shuffles``,
   hash-shuffled producers expanded into one location per consumer
   partition, as the scheduler's ``_expand_shuffle_locations`` does);
4. ship the stage through protobuf (``physical_to_proto`` ->
   ``SerializeToString`` -> ``ParseFromString`` -> ``physical_from_proto``
   on the context's device);
5. fuse it (``maybe_fuse``, as the executor does after deserializing);
6. execute each partition and write it: a stage with
   ``shuffle_output_partitions`` splits every batch per output partition
   ``q`` with ``compute_partition_ids`` and the device mask
   ``selection & (pids == q)`` into ``shuffle_path`` files (the
   executor's ``_write_shuffled``); any other stage goes whole into its
   ``partition_path`` file, both through ``ipc.PartitionWriter``;
7. read the final stage's files back through a ``ShuffleReaderExec`` and
   collect them.

With ``remote="python"`` or ``remote="native"`` every read fetches its
files through that data-plane server (``ShuffleReaderExec.FORCE_REMOTE``)
instead of the local path; ``"native"`` raises unless the port's own C++
server really started (``start_data_plane`` falls back to the Python
server when the binary fails, as in the JAX package).
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import expr as ex
from .. import serde
from ..client import _plan_nodes
from ..distributed.dataplane import (NativeDataPlane, partition_path,
                                     shuffle_file_name, shuffle_path,
                                     start_data_plane)
from ..distributed.planner import (DistributedPlanner,
                                   find_unresolved_shuffles,
                                   remove_unresolved_shuffles)
from ..distributed.types import PartitionLocation
from ..errors import ExecutionError
from ..proto import ballista_pb2 as pb

_JOB_SEQ = itertools.count(1)


@dataclass
class StageRecord:
    """What one stage did: its shape, its writes and its reads."""

    stage_id: int
    partitions: int
    fan_out: int  # shuffle_output_partitions (0: merge-style output)
    deps: List[int]
    plan: object  # the deserialized, fused plan that ran
    bytes_written: int = 0
    rows_written: int = 0
    write_seconds: float = 0.0  # host clock: execute + split + write
    bytes_read: int = 0
    read_seconds: float = 0.0  # readers' elapsed_read, summed
    remote_fetches: int = 0


@dataclass
class StagedRun:
    job_id: str
    result: Dict[str, np.ndarray]
    stages: List[StageRecord] = field(default_factory=list)
    server: Optional[str] = None  # type name of the data-plane server
    bytes_read_final: int = 0
    read_seconds_final: float = 0.0


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


def _write_partition(plan, job_id, stage_id, p, work_dir) -> dict:
    from ..io import ipc
    from ..lifecycle import check_cancel

    path = partition_path(work_dir, job_id, stage_id, p)
    writer = ipc.PartitionWriter(path, schema=plan.output_schema(),
                                 compute_column_stats=True)
    try:
        for batch in plan.execute(p):
            check_cancel()
            writer.write_batch(batch)
        stats = writer.close()
    except BaseException:
        writer.abort()
        raise
    return {**stats, "path": path}


def _write_shuffled(plan, job_id, stage_id, p, work_dir, hash_exprs,
                    n_out) -> dict:
    """The executor's streaming n_out-way shuffle write: each produced
    batch is split per output partition by a device mask and written at
    once (one compaction to the host per batch and output partition)."""
    from ..io import ipc
    from ..kernels.expr_eval import Evaluator
    from ..lifecycle import check_cancel
    from ..physical.operators import compute_partition_ids

    schema = plan.output_schema()
    ev = Evaluator(schema)
    writers = [ipc.PartitionWriter(
        shuffle_path(work_dir, job_id, stage_id, p, q), schema=schema)
        for q in range(n_out)]
    totals = {"num_rows": 0, "num_batches": 0, "num_bytes": 0}
    offset = 0
    try:
        for b in plan.execute(p):
            check_cancel()
            pids = compute_partition_ids(b, hash_exprs, n_out, offset, ev)
            for q in range(n_out):
                writers[q].write_batch(b.with_selection(
                    torch.logical_and(b.selection, pids == q)))
            offset += b.num_rows_host()
        qbytes = []
        for q in range(n_out):
            st = writers[q].close()
            qbytes.append(int(st["num_bytes"]))
            for k in totals:
                totals[k] += st[k]
    except BaseException:
        for w in writers:
            w.abort()
        raise
    totals["shuffle_partition_bytes"] = qbytes
    totals["path"] = shuffle_path(work_dir, job_id, stage_id, p, n_out - 1)
    return totals


def _reader_totals(plan, rec) -> None:
    from ..physical.shuffle import ShuffleReaderExec

    for node in _plan_nodes(plan):
        if isinstance(node, ShuffleReaderExec):
            v = node.metrics().values()
            rec.bytes_read += int(v.get("bytes_read", 0))
            rec.read_seconds += float(v.get("elapsed_read", 0.0))
            rec.remote_fetches += int(v.get("remote_fetches", 0))


def run_staged(ctx, sql: str, work_dir: str, remote: Optional[str] = None,
               job_id: Optional[str] = None,
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

    if remote not in (None, "python", "native"):
        raise ValueError(f"remote must be None, 'python' or 'native': {remote}")
    device = ctx.device
    job_id = job_id or f"staged{os.getpid()}x{next(_JOB_SEQ)}"
    phys = plan_logical(ctx.sql(sql).plan, ctx._planner_options())
    stages = DistributedPlanner().plan_query_stages(job_id, phys)

    server = None
    host, port = "", 0
    if remote is not None:
        server = start_data_plane("localhost", 0, work_dir,
                                  native=remote == "native")
        if remote == "native" and not isinstance(server, NativeDataPlane):
            server.close()
            raise ExecutionError("the native shuffle server did not start")
        host, port = "localhost", server.port
    prev_force = ShuffleReaderExec.FORCE_REMOTE
    ShuffleReaderExec.FORCE_REMOTE = remote is not None
    run = StagedRun(job_id, {}, server=type(server).__name__
                    if server is not None else None)
    locations: Dict[int, List[PartitionLocation]] = {}
    specs: Dict[int, tuple] = {}  # stage id -> (hash exprs, n_out)
    try:
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
            t0 = time.perf_counter()
            for p in range(nparts):
                prime_plan(plan, partitions=[p])
                try:
                    if n_out:
                        st = _write_shuffled(plan, job_id, stage.stage_id, p,
                                             work_dir,
                                             stage.shuffle_hash_exprs, n_out)
                    else:
                        st = _write_partition(plan, job_id, stage.stage_id,
                                              p, work_dir)
                finally:
                    cancel_plan(plan)
                rec.bytes_written += int(st["num_bytes"])
                rec.rows_written += int(st["num_rows"])
                path = st.pop("path")
                out_locs.append(PartitionLocation(
                    job_id, stage.stage_id, p, "staged", host, port,
                    path=path, stats=st))
            rec.write_seconds = time.perf_counter() - t0
            _reader_totals(plan, rec)
            for node in _plan_nodes(plan):
                node.release()
            locations[stage.stage_id] = out_locs
            run.stages.append(rec)
        final = ShuffleReaderExec(locations[stages[-1].stage_id],
                                  stages[-1].output_schema(), device=device)
        run.result = collect_physical(final)
        v = final.metrics().values()
        run.bytes_read_final = int(v.get("bytes_read", 0))
        run.read_seconds_final = float(v.get("elapsed_read", 0.0))
    finally:
        ShuffleReaderExec.FORCE_REMOTE = prev_force
        if server is not None:
            server.close()
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
