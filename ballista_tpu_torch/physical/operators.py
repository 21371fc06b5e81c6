"""Core physical operators: scan, filter, projection, merge, coalesce,
sort, limit, empty.

The port of the JAX package's ``physical/operators.py``. Filter and
Projection are PipelineOps, applied batch by batch by the outermost
operator of their chain. ``RepartitionExec`` and the hash partitioning it
needs are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from ..columnar import ColumnBatch
from ..datatypes import Schema
from ..errors import ExecutionError
from .. import expr as ex
from ..kernels.expr_eval import Evaluator
from ..kernels.sort import sort_permutation
from ..logical import TableSource
from .base import PhysicalPlan, PipelineOp, Partitioning, concat_batches, take_batch


class ScanExec(PhysicalPlan):
    """Table scan over a partitioned source (the serial pull loop; the
    JAX package's prefetching ingest pipeline is not ported yet)."""

    def __init__(self, table_name: str, source: TableSource,
                 projection: Optional[Sequence[str]] = None):
        self.table_name = table_name
        self.source = source
        self.projection = tuple(projection) if projection is not None else None

    def output_schema(self) -> Schema:
        s = self.source.table_schema()
        return s.project(self.projection) if self.projection else s

    def output_partitioning(self) -> Partitioning:
        return Partitioning("unknown", self.source.num_partitions())

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        yield from self.source.scan(partition, self.projection)

    def display(self) -> str:
        p = f" projection={list(self.projection)}" if self.projection else ""
        return f"ScanExec: {self.table_name}{p}"


class FilterExec(PipelineOp):
    compactable = True  # kills rows: the chain's output is compacted

    def __init__(self, predicate: ex.Expr, child: PhysicalPlan):
        self.predicate = predicate
        self.child = child
        self._ev = Evaluator(child.output_schema())

    def output_schema(self) -> Schema:
        return self.child.output_schema()

    def device_transform(self, batch: ColumnBatch) -> ColumnBatch:
        mask = self._ev.evaluate_predicate(self.predicate, batch)
        sel = torch.logical_and(batch.selection, mask)
        return batch.with_selection(sel)

    def display(self) -> str:
        return f"FilterExec: {self.predicate.name()}"


class ProjectionExec(PipelineOp):
    def __init__(self, exprs: List[ex.Expr], child: PhysicalPlan):
        self.exprs = list(exprs)
        self.child = child
        self._in_schema = child.output_schema()
        self._ev = Evaluator(self._in_schema)
        self._schema = Schema([e.to_field(self._in_schema) for e in self.exprs])

    def output_schema(self) -> Schema:
        return self._schema

    def device_transform(self, batch: ColumnBatch) -> ColumnBatch:
        cols = [self._ev.to_column(e, batch) for e in self.exprs]
        # trust planned schema for dtypes (evaluator agrees by construction)
        return batch.with_columns(self._schema, cols)

    def display(self) -> str:
        return f"ProjectionExec: {', '.join(e.name() for e in self.exprs)}"


class MergeExec(PhysicalPlan):
    """Gather all input partitions into one, in partition order (the
    serial pull loop)."""

    def __init__(self, child: PhysicalPlan):
        self.child = child

    def output_schema(self) -> Schema:
        return self.child.output_schema()

    def output_partitioning(self) -> Partitioning:
        return Partitioning("unknown", 1)

    def children(self):
        return [self.child]

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        if partition != 0:
            raise ExecutionError("MergeExec has a single output partition")
        for p in range(self.child.output_partitioning().num_partitions):
            yield from self.child.execute(p)

    def display(self) -> str:
        return "MergeExec"


class CoalesceBatchesExec(PhysicalPlan):
    """Concatenate a partition's batches into one device batch."""

    def __init__(self, child: PhysicalPlan):
        self.child = child

    def output_schema(self) -> Schema:
        return self.child.output_schema()

    def children(self):
        return [self.child]

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        batches = list(self.child.execute(partition))
        if not batches:
            return
        yield concat_batches(self.output_schema(), batches)

    def display(self) -> str:
        return "CoalesceBatchesExec"


class SortExec(PhysicalPlan):
    """Total sort of a single partition."""

    def __init__(self, sort_exprs: List[ex.SortExpr], child: PhysicalPlan):
        self.sort_exprs = list(sort_exprs)
        self.child = child
        self._ev = Evaluator(child.output_schema())

    def output_schema(self) -> Schema:
        return self.child.output_schema()

    def output_partitioning(self) -> Partitioning:
        return Partitioning("unknown", 1)

    def children(self):
        return [self.child]

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        batches = list(self.child.execute(partition))
        if not batches:
            return
        b = concat_batches(self.output_schema(), batches)
        keys = []
        for se in self.sort_exprs:
            r = self._ev.evaluate(se.expr, b)
            keys.append((torch.broadcast_to(r.values, (b.capacity,)),
                         se.ascending))
        perm = sort_permutation(keys, b.selection)
        live_sorted = b.selection[perm.to(torch.int64)]
        yield take_batch(b, perm, live_sorted)

    def display(self) -> str:
        return f"SortExec: {', '.join(e.name() for e in self.sort_exprs)}"


class LimitExec(PhysicalPlan):
    """Take the first n live rows of a (single) partition."""

    def __init__(self, n: int, child: PhysicalPlan):
        self.n = n
        self.child = child

    def output_schema(self) -> Schema:
        return self.child.output_schema()

    def children(self):
        return [self.child]

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        remaining = self.n
        for batch in self.child.execute(partition):
            if remaining <= 0:
                break
            rank = torch.cumsum(batch.selection.to(torch.int32), 0) - 1
            out = batch.with_selection(
                torch.logical_and(batch.selection, rank < remaining))
            remaining -= out.num_rows_host()
            yield out

    def display(self) -> str:
        return f"LimitExec: {self.n}"


class EmptyExec(PhysicalPlan):
    """Zero- or one-row empty relation on ``device``."""

    def __init__(self, device: torch.device, produce_one_row: bool = False):
        self.device = torch.device(device)
        self.produce_one_row = produce_one_row

    def output_schema(self) -> Schema:
        return Schema([])

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        n = 1 if self.produce_one_row else 0
        sel = torch.zeros(8, dtype=torch.bool, device=self.device)
        sel[:n] = True
        yield ColumnBatch(Schema([]), [], sel,
                          torch.tensor(n, dtype=torch.int32,
                                       device=self.device))

    def display(self) -> str:
        return "EmptyExec"
