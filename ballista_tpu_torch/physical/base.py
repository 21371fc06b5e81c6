"""Physical plan base classes + batch utilities.

The port of the JAX package's ``physical/base.py``. Execution model:
``execute(partition)`` yields ColumnBatches (host-driven volcano at batch
granularity), and each operator's device work runs as governed programs
(``compile/governor.py``): eager torch ops on the CPU, one captured CUDA
graph per call signature on a card. A chain of pipeline operators
(filter/projection) runs as one such program per batch; whole-stage
fusion (``fusion.py``) folds chains into the aggregate or join program
they feed. Operators key their programs on ``compile_signature`` and
hand the governor closures over a config-only ``trace_twin``. A
single-consumer batch is donated to the program that consumes it
(``donating_call``, the JAX package's ``governed_call``;
``cache/donation.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..cache.donation import (consume_transient, donation_enabled,
                              mark_transient, record_donation)
from ..columnar import Column, ColumnBatch, Dictionary
from ..compile import bucket_capacity, governed
from ..datatypes import Schema
from ..errors import ExecutionError
from ..observability.metrics import MetricsSet, instrument_execute


@dataclass(frozen=True)
class Partitioning:
    """Output partitioning descriptor."""

    kind: str  # "unknown" | "round_robin" | "hash"
    num_partitions: int
    hash_columns: tuple = ()


class PhysicalPlan:
    """Base physical operator.

    Every subclass that overrides ``execute`` is transparently
    instrumented (``__init_subclass__`` below): each call records
    ``output_rows``/``output_batches``/``elapsed_compute`` on the
    operator's :class:`MetricsSet`.
    """

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        exec_fn = cls.__dict__.get("execute")
        if exec_fn is not None:
            cls.execute = instrument_execute(exec_fn)

    def metrics(self) -> MetricsSet:
        """The operator's MetricsSet (lazily created)."""
        m = getattr(self, "_metrics", None)
        if m is None:
            m = self._metrics = MetricsSet()
        return m

    # -- compile governor ---------------------------------------------------

    def compile_signature(self) -> tuple:
        """Value-signature of everything this operator's governed closures
        read from instance state. Governed keys include it, so two
        instances with equal signatures (e.g. the same operator before
        and after a re-plan) share one entry. The default covers
        operators whose ``display()`` renders their full configuration;
        operators with more state override ``_signature_parts``."""
        sig = getattr(self, "_compile_sig", None)
        if sig is None:
            sig = self._compile_sig = (
                (type(self).__name__,) + self._signature_parts()
            )
        return sig

    def _signature_parts(self) -> tuple:
        return (self.display(), self.output_schema())

    def governed_jit(self, subkey: tuple, build):
        """Process-wide governed function for this operator under
        ``subkey`` (namespace first); first calls are attributed to this
        operator's metrics. The name is the JAX package's: here it is a
        program cache, eager on the CPU and CUDA graphs on a card."""
        key = (subkey[0], self.compile_signature()) + tuple(subkey[1:])
        return governed(key, build, metrics=self.metrics())

    def trace_twin(self) -> "PhysicalPlan":
        """Config-only shallow clone for governed closures to capture.

        Governed entries outlive operator instances, so a closure over
        ``self`` would pin the whole plan subtree — scan batches,
        repartitioned batches, join build tables — for as long as the
        entry lives. The twin carries what the closures read
        (mode/exprs/schemas/evaluators) while ``_detach`` severs children
        and data caches. Closures passed to ``governed_jit`` must
        reference the twin, never ``self``."""
        tw = getattr(self, "_trace_twin", None)
        if tw is None:
            import copy

            tw = copy.copy(self)
            self._trace_twin = tw
            tw._trace_twin = tw  # twin of the twin is itself
            tw._metrics = None
            tw._detach()
        return tw

    def _detach(self) -> None:
        """Sever plan-subtree and materialized-state references on a
        trace twin (runs on the COPY). Default: the child becomes a
        schema-only leaf. Operators whose closures read other heavy
        members override and extend."""
        if getattr(self, "child", None) is not None:
            self.child = SchemaLeaf(self.child.output_schema())
        if getattr(self, "_fused_fn", None) is not None:
            self._fused_fn = None  # no entry->twin->entry cycles

    def output_schema(self) -> Schema:
        raise NotImplementedError

    def output_partitioning(self) -> Partitioning:
        cs = self.children()
        if cs:
            return cs[0].output_partitioning()
        return Partitioning("unknown", 1)

    def children(self) -> List["PhysicalPlan"]:
        return []

    def with_new_children(self, children: List["PhysicalPlan"]) -> "PhysicalPlan":
        raise NotImplementedError(type(self).__name__)

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        raise NotImplementedError(type(self).__name__)

    def release(self) -> None:
        """Drop what this operator materialized for its later partitions
        (join build tables, repartitioned batches). The client calls it
        on every operator around each collect, so a plan kept for reuse
        holds no device memory between collects and a repeated collect
        reads its inputs again."""

    def estimated_rows(self) -> Optional[int]:
        """Crude output-cardinality estimate for planning decisions (join
        orientation, co-partitioning). Filters and joins deliberately
        over-estimate (pass-through / sum); None = unknown."""
        ests = [c.estimated_rows() for c in self.children()]
        # any unknown child makes the total unknown: silently dropping it
        # would UNDER-estimate, and callers rely on over-estimation
        if not ests or any(e is None for e in ests):
            return None
        return sum(ests)

    def display(self) -> str:
        return type(self).__name__

    def pretty(self, indent: int = 0) -> str:
        out = "  " * indent + self.display() + "\n"
        for c in self.children():
            out += c.pretty(indent + 1)
        return out

    def pretty_metrics(self, indent: int = 0) -> str:
        """Plan text annotated with the operators' metrics."""
        ann = self.metrics().summary()
        out = ("  " * indent + self.display()
               + (f", metrics=[{ann}]" if ann else "") + "\n")
        for c in self.children():
            out += c.pretty_metrics(indent + 1)
        return out


class SchemaLeaf(PhysicalPlan):
    """Schema-only placeholder standing in for a severed child on a
    trace twin. Never executed."""

    def __init__(self, schema: Schema):
        self._schema = schema

    def output_schema(self) -> Schema:
        return self._schema

    def with_new_children(self, children):
        return self


class PipelineOp(PhysicalPlan):
    """Operator whose work is a pure batch->batch device transform.

    A chain of PipelineOps runs as one governed program per batch, called
    by its outermost operator, as the JAX package's fused chain is.
    """

    child: PhysicalPlan
    # True for transforms that can kill rows (FilterExec): the chain's
    # output is then adaptively compacted (maybe_compact: >=4x shrink)
    compactable = False

    def device_transform(self, batch: ColumnBatch) -> ColumnBatch:
        raise NotImplementedError(type(self).__name__)

    def children(self) -> List[PhysicalPlan]:
        return [self.child]

    def _pipeline_chain(self):
        """(transforms outer-to-inner reversed into apply order, source op)."""
        chain: List[PipelineOp] = []
        node: PhysicalPlan = self
        while isinstance(node, PipelineOp):
            chain.append(node)
            node = node.child
        chain.reverse()  # innermost transform first
        return chain, node

    def _fused_governed(self):
        """Governed transform for this operator's pipeline chain, keyed
        on the chain's operator signatures, so a re-planned chain (fresh
        instances, same logical chain) reuses its programs."""
        fused = getattr(self, "_fused_fn", None)
        if fused is None:
            chain, _ = self._pipeline_chain()

            def build():
                # twins: device_transform reads exprs/evaluators, never
                # .child — the live ops would pin the source's batches
                twins = [op.trace_twin() for op in chain]

                def apply_all(batch):
                    for op in twins:
                        batch = op.device_transform(batch)
                    return batch

                return apply_all

            key = ("pipeline.fused",
                   tuple(op.compile_signature() for op in chain))
            fused = self._fused_fn = governed(key, build,
                                              metrics=self.metrics())
        return fused

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        chain, source = self._pipeline_chain()
        fused = self._fused_governed()
        # Adaptive, as in the JAX package: after 2 consecutive batches
        # that decline to compact, stop paying the per-batch live-count
        # sync; the learned capacity floor keeps later batches from
        # compacting to ever-different ladder rungs.
        compact = any(op.compactable for op in chain)
        for batch in source.execute(partition):
            # a single-consumer scan/concat output is donated to the chain
            out = donating_call(fused, batch)
            if compact and getattr(self, "_compact_misses", 0) < 2:
                res = maybe_compact(
                    out, floor=getattr(self, "_compact_floor", 8))
                if res is out:
                    self._compact_misses = \
                        getattr(self, "_compact_misses", 0) + 1
                else:
                    self._compact_misses = 0
                    self._compact_floor = max(
                        getattr(self, "_compact_floor", 8), res.capacity)
                    self.metrics().add_counter("compact_count")
                out = res
            # the chain's output (or its compaction) has exactly one
            # downstream consumer: donation-eligible
            mark_transient(out)
            yield out


def donating_call(fn, batch: ColumnBatch, *extra):
    """``fn(batch, *extra)`` for a governed ``fn``, donating ``batch``
    when it is transient and donation is enabled: the batch's claim is
    consumed, its columns' and selection's bytes are counted, and it
    gives up its tensors (``call_donating``). Unlike the JAX package's
    donating entries, the program is the same either way: only when the
    batch drops its tensors differs."""
    if donation_enabled() and consume_transient(batch):
        record_donation(batch.payload_nbytes())
        return fn.call_donating(batch, *extra)
    return fn(batch, *extra)


# ---------------------------------------------------------------------------
# Batch utilities shared by operators
# ---------------------------------------------------------------------------


def _unify_dictionaries(dicts: List[Optional[Dictionary]]):
    """Sorted union of several dictionaries + one int32 remap table per
    input (None where the input already is the union)."""
    present = [d for d in dicts if d is not None]
    union = Dictionary(np.unique(np.concatenate(
        [d.values_str() for d in present])))
    remaps = [None if d is None or (len(d) == len(union) and np.array_equal(
        d.values_str(), union.values_str())) else union.positions_of(d.values)
        for d in dicts]
    return union, remaps


def concat_batches(schema: Schema, batches: List[ColumnBatch]) -> ColumnBatch:
    """Concatenate batches (same device) into one larger-capacity batch.

    utf8 columns whose batches carry DIFFERENT dictionaries are unified: a
    sorted union dictionary is built host-side and each batch's codes are
    remapped by a gather on the device.

    Output capacity is the exact SUM of the inputs (not padded up to a
    ladder rung), as in the JAX package.
    """
    if not batches:
        raise ExecutionError("concat of zero batches")
    if len(batches) == 1:
        return batches[0]
    dev = batches[0].device
    if any(b.device != dev for b in batches):
        raise ExecutionError("concat of batches on different devices")
    cols: List[Column] = []
    for i, f in enumerate(schema.fields):
        values_list = [b.columns[i].values for b in batches]
        dicts = [b.columns[i].dictionary for b in batches]
        dict_ = next((d for d in dicts if d is not None), None)
        if dict_ is not None and any(
            d is not None and d is not dict_ for d in dicts
        ):
            dict_, remaps = _unify_dictionaries(dicts)
            remapped = []
            for v, remap in zip(values_list, remaps):
                if remap is None:
                    remapped.append(v)
                    continue
                table = torch.from_numpy(remap).to(dev)
                idx = v.to(torch.int64).clamp(0, max(len(remap) - 1, 0))
                remapped.append(table[idx])
            values_list = remapped
        vals = torch.cat(values_list)
        vs = [b.columns[i].validity for b in batches]
        if any(v is not None for v in vs):
            validity = torch.cat([
                v if v is not None
                else torch.ones((b.capacity,), dtype=torch.bool, device=dev)
                for v, b in zip(vs, batches)
            ])
        else:
            validity = None
        cols.append(Column(vals, f.dtype, validity, dict_))
    selection = torch.cat([b.selection for b in batches])
    num_rows = torch.stack([b.num_rows for b in batches]).sum(dtype=torch.int32)
    out = ColumnBatch(schema, cols, selection, num_rows)
    # fresh torch.cat tensors with exactly one consumer (the program the
    # concat feeds): donation-eligible. The len == 1 pass-through above
    # keeps the input's own mark: pinned cache batches stay pinned.
    mark_transient(out)
    return out


def maybe_compact(batch: ColumnBatch, shrink_factor: int = 4,
                  known_rows: Optional[int] = None,
                  floor: int = 8) -> ColumnBatch:
    """Shrink a sparse batch: when live rows fill under 1/shrink_factor
    of the capacity, gather them to the front of a smaller batch.

    Pass ``known_rows`` when the live count is already on host; otherwise
    this reads ``num_rows`` (one device sync). The JAX package skips that
    sync when it measured it as expensive (a remote TPU); on a local card
    it costs microseconds, so the port always pays it."""
    n = known_rows if known_rows is not None else int(batch.num_rows)
    cap = batch.capacity
    # compaction targets land on the bucket ladder
    new_cap = max(bucket_capacity(n), floor, 8)
    if new_cap * shrink_factor > cap:
        return batch

    def build(_new=new_cap):
        def compact(b: ColumnBatch) -> ColumnBatch:
            perm = compact_perm(b.selection, _new)
            live = torch.arange(_new, dtype=torch.int32,
                                device=b.device) < b.num_rows
            return take_batch(b, perm, live)

        return compact

    return governed(("batch.compact", new_cap), build)(batch)


def pad_batch(batch: ColumnBatch, capacity: int) -> ColumnBatch:
    """Grow a batch's capacity with dead padding rows (device)."""
    if capacity <= batch.capacity:
        return batch
    extra = capacity - batch.capacity
    dev = batch.device
    cols = []
    for col in batch.columns:
        vals = torch.cat([col.values, torch.zeros(
            (extra,) + tuple(col.values.shape[1:]), dtype=col.values.dtype,
            device=dev)])
        validity = (
            torch.cat([col.validity,
                       torch.zeros((extra,), dtype=torch.bool, device=dev)])
            if col.validity is not None else None)
        cols.append(Column(vals, col.dtype, validity, col.dictionary))
    selection = torch.cat(
        [batch.selection, torch.zeros((extra,), dtype=torch.bool, device=dev)])
    return ColumnBatch(batch.schema, cols, selection, batch.num_rows)


def compact_perm(selection: torch.Tensor, size: int) -> torch.Tensor:
    """Gather permutation of ``size`` entries putting live rows first, in
    order, padded with 0 — ``jnp.nonzero(size=, fill_value=0)`` — without
    reading the live count back to the host: each live row's rank (a
    cumsum) is its slot, live rows past ``size`` and dead rows go to a
    trash slot that is sliced off."""
    n = selection.shape[0]
    dev = selection.device
    rank = torch.cumsum(selection.to(torch.int64), 0) - 1
    slot = torch.where(selection & (rank < size), rank, size)
    out = torch.zeros((size + 1,), dtype=torch.int64, device=dev)
    out.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=dev))
    return out[:size].to(torch.int32)


def take_batch(batch: ColumnBatch, perm: torch.Tensor,
               live: torch.Tensor) -> ColumnBatch:
    """Reorder a batch by ``perm``; ``live`` is the selection after reorder."""
    idx = perm.to(torch.int64)
    cols = []
    for col in batch.columns:
        vals = torch.broadcast_to(
            col.values, (batch.capacity,) + tuple(col.values.shape[1:]))[idx]
        validity = col.validity[idx] if col.validity is not None else None
        cols.append(Column(vals, col.dtype, validity, col.dictionary))
    return ColumnBatch(batch.schema, cols, live, live.sum(dtype=torch.int32))
