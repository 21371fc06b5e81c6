"""Core physical operators: scan, filter, projection, merge, coalesce,
sort, limit, repartition, empty.

The port of the JAX package's ``physical/operators.py``. Filter and
Projection are PipelineOps: their chain runs as one governed program per
batch, called by its outermost operator, unless fusion folds it into the
aggregate or join program it feeds. Sort, limit and the repartition's
per-batch sort and per-partition gather are governed programs under the
JAX package's namespaces (``sort.run``, ``limit.take``,
``repart.sort_by_pid``, ``repart.take``); the repartition's count fetch
stays between them, on the host.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..columnar import ColumnBatch
from ..compile import bucket_capacity, fingerprint
from ..compile.governor import device_constant
from ..datatypes import Schema
from ..errors import ExecutionError
from .. import expr as ex
from ..kernels.expr_eval import Evaluator
from ..kernels.hashing import splitmix64, unsigned_mod
from ..kernels.sort import sort_permutation
from ..logical import TableSource
from .base import (PhysicalPlan, PipelineOp, Partitioning, concat_batches,
                   pad_batch, take_batch)


def compute_partition_ids(batch: ColumnBatch, hash_exprs, num_partitions: int,
                          row_offset: int, evaluator: Evaluator):
    """int32 partition id per row: chained splitmix64 over the hash exprs,
    or round-robin by global row index — the JAX package's ids, bit for
    bit.

    utf8 keys hash their STRING VALUE (via per-dictionary stable FNV-1a
    hashes), never the dictionary code — codes are producer-local and would
    break hash co-location across independent producers."""
    dev = batch.device
    if hash_exprs:
        h = torch.zeros((batch.capacity,), dtype=torch.int64, device=dev)
        for e in hash_exprs:
            r = evaluator.evaluate(e, batch)
            v = torch.broadcast_to(r.values, (batch.capacity,))
            if r.dictionary is not None:
                hashes = r.dictionary.stable_hashes()
                if len(hashes) == 0:  # no value to hash: every code is dead
                    hashes = np.zeros(1, np.int64)
                table = device_constant(hashes, dev)
                # JAX's take(mode="clip")
                v = table[v.to(torch.int64).clamp(0, table.shape[0] - 1)]
            h = splitmix64(h ^ splitmix64(v.to(torch.int64)))
        return unsigned_mod(h, num_partitions)
    idx = row_offset + torch.arange(batch.capacity, dtype=torch.int32,
                                    device=dev)
    return idx % num_partitions


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

    def with_new_children(self, children):
        return self

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        yield from self.source.scan(partition, self.projection)

    def estimated_rows(self):
        return self.source.estimated_rows()

    def display(self) -> str:
        p = f" projection={list(self.projection)}" if self.projection else ""
        return f"ScanExec: {self.table_name}{p}"


class FilterExec(PipelineOp):
    compactable = True  # kills rows: the chain's output is compacted

    def __init__(self, predicate: ex.Expr, child: PhysicalPlan):
        self.predicate = predicate
        self.child = child
        self._ev = Evaluator(child.output_schema())

    def _signature_parts(self) -> tuple:
        return (fingerprint(self.predicate), self.child.output_schema())

    def output_schema(self) -> Schema:
        return self.child.output_schema()

    def with_new_children(self, children):
        return FilterExec(self.predicate, children[0])

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

    def _signature_parts(self) -> tuple:
        return (fingerprint(self.exprs), self._in_schema)

    def output_schema(self) -> Schema:
        return self._schema

    def with_new_children(self, children):
        return ProjectionExec(self.exprs, children[0])

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

    def with_new_children(self, children):
        return MergeExec(children[0])

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

    def with_new_children(self, children):
        return CoalesceBatchesExec(children[0])

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

    def _signature_parts(self) -> tuple:
        return (fingerprint(self.sort_exprs), self.child.output_schema())

    def output_schema(self) -> Schema:
        return self.child.output_schema()

    def output_partitioning(self) -> Partitioning:
        return Partitioning("unknown", 1)

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return SortExec(self.sort_exprs, children[0])

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        batches = list(self.child.execute(partition))
        if not batches:
            return
        batch = concat_batches(self.output_schema(), batches)

        def build():
            tw = self.trace_twin()  # don't pin the child subtree

            def do_sort(b: ColumnBatch) -> ColumnBatch:
                keys = []
                for se in tw.sort_exprs:
                    r = tw._ev.evaluate(se.expr, b)
                    keys.append((torch.broadcast_to(r.values, (b.capacity,)),
                                 se.ascending))
                perm = sort_permutation(keys, b.selection)
                live_sorted = b.selection[perm.to(torch.int64)]
                return take_batch(b, perm, live_sorted)

            return do_sort

        yield self.governed_jit(("sort.run",), build)(batch)

    def display(self) -> str:
        return f"SortExec: {', '.join(e.name() for e in self.sort_exprs)}"


class LimitExec(PhysicalPlan):
    """Take the first n live rows of a (single) partition."""

    def __init__(self, n: int, child: PhysicalPlan):
        self.n = n
        self.child = child

    def output_schema(self) -> Schema:
        return self.child.output_schema()

    def _signature_parts(self) -> tuple:
        return ()  # take_first is operator-independent (k is an argument)

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return LimitExec(self.n, children[0])

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        remaining = self.n

        def build():
            def take_first(b: ColumnBatch, k) -> ColumnBatch:
                rank = torch.cumsum(b.selection.to(torch.int32), 0) - 1
                return b.with_selection(
                    torch.logical_and(b.selection, rank < k))

            return take_first

        take = self.governed_jit(("limit.take",), build)
        for batch in self.child.execute(partition):
            if remaining <= 0:
                break
            k = torch.full((), remaining, dtype=torch.int32,
                           device=batch.device)
            out = take(batch, k)
            remaining -= out.num_rows_host()
            yield out

    def display(self) -> str:
        return f"LimitExec: {self.n}"


class RepartitionExec(PhysicalPlan):
    """Re-partition input into N output partitions by hash or round-robin.

    Single-process: the child's partitions are materialized once, in
    order and serially (the port has no ingest pool), each batch is
    sorted by destination partition once, and output partition p gathers
    its rows to the front of a batch that fits them."""

    def __init__(self, child: PhysicalPlan, num_partitions: int,
                 hash_exprs: Optional[List[ex.Expr]] = None):
        self.child = child
        self.num_partitions = num_partitions
        self.hash_exprs = hash_exprs
        self._ev = Evaluator(child.output_schema())
        self._parts = None

    def _signature_parts(self) -> tuple:
        return (self.num_partitions, fingerprint(self.hash_exprs),
                self.child.output_schema())

    def _detach(self) -> None:
        super()._detach()
        self._parts = None  # materialized batches must not be pinned

    def with_new_children(self, children):
        return RepartitionExec(children[0], self.num_partitions,
                               self.hash_exprs)

    def output_schema(self) -> Schema:
        return self.child.output_schema()

    def output_partitioning(self) -> Partitioning:
        kind = "hash" if self.hash_exprs else "round_robin"
        cols = tuple(e.name() for e in (self.hash_exprs or []))
        return Partitioning(kind, self.num_partitions, cols)

    def children(self):
        return [self.child]

    def release(self) -> None:
        self._parts = None

    def partition_ids(self, batch: ColumnBatch, row_offset: int):
        """int32 partition id per row."""
        return compute_partition_ids(batch, self.hash_exprs,
                                     self.num_partitions, row_offset,
                                     self._ev)

    def _materialize_parts(self):
        """[(batch, perm, host counts)]: every child batch, the stable
        permutation that orders its live rows by destination partition
        (dead rows last), and its rows per partition."""
        if self._parts is None:

            def build():
                tw = self.trace_twin()  # don't pin materialized batches
                n_out = tw.num_partitions

                def sort_by_pid(b: ColumnBatch, offset):
                    pids = tw.partition_ids(b, offset)
                    d = torch.where(b.selection, pids, n_out)  # dead last
                    perm = torch.argsort(d, stable=True)
                    # a histogram by scatter: bincount reads its input's
                    # maximum back to the host on a card
                    counts = torch.zeros((n_out + 1,), dtype=torch.int64,
                                         device=b.device)
                    counts.index_add_(0, d.to(torch.int64),
                                      torch.ones_like(d, dtype=torch.int64))
                    return perm, counts[:n_out]

                return sort_by_pid

            sort_fn = self.governed_jit(("repart.sort_by_pid",), build)
            parts = []
            offset = 0
            for p in range(self.child.output_partitioning().num_partitions):
                for batch in self.child.execute(p):
                    off = torch.full((), offset, dtype=torch.int32,
                                     device=batch.device)
                    perm, counts = sort_fn(batch, off)
                    # the count fetch, between programs
                    parts.append((batch, perm, counts.cpu().numpy()))
                    offset += batch.num_rows_host()
            self._parts = parts
        return self._parts

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        """Yields ONE COMPACTED batch: the partition's rows of every child
        batch gathered to the front of a ladder capacity that fits, the
        pieces concatenated and padded to a ladder rung."""
        pieces = []
        for batch, perm, counts in self._materialize_parts():
            n = int(counts[partition])
            start = int(counts[:partition].sum())
            # never exceed the source capacity; bucketed, so unevenly
            # filled output partitions land on the canonical ladder
            cap = min(bucket_capacity(n), batch.capacity)
            idx = perm[start:start + cap]
            if idx.shape[0] < cap:  # tail partition: pad the gather
                idx = torch.cat([idx, idx.new_zeros(cap - idx.shape[0])])

            def build(_cap=cap):
                def take_front(b, idx, n):
                    live = torch.arange(_cap, dtype=torch.int32,
                                        device=b.device) < n
                    return take_batch(b, idx, live)

                return take_front

            take = self.governed_jit(("repart.take", cap), build)
            pieces.append(take(batch, idx, torch.full(
                (), n, dtype=torch.int32, device=batch.device)))
        if len(pieces) == 1:
            yield pieces[0]
        elif pieces:
            out = concat_batches(self.output_schema(), pieces)
            target = bucket_capacity(out.capacity)
            if target != out.capacity:
                out = pad_batch(out, target)
            yield out

    def display(self) -> str:
        k = "hash" if self.hash_exprs else "round-robin"
        return f"RepartitionExec: {k} into {self.num_partitions}"


class EmptyExec(PhysicalPlan):
    """Zero- or one-row empty relation on ``device``."""

    def __init__(self, device: torch.device, produce_one_row: bool = False):
        self.device = torch.device(device)
        self.produce_one_row = produce_one_row

    def output_schema(self) -> Schema:
        return Schema([])

    def with_new_children(self, children):
        return self

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        n = 1 if self.produce_one_row else 0
        sel = torch.zeros(8, dtype=torch.bool, device=self.device)
        sel[:n] = True
        yield ColumnBatch(Schema([]), [], sel,
                          torch.tensor(n, dtype=torch.int32,
                                       device=self.device))

    def display(self) -> str:
        return "EmptyExec"
