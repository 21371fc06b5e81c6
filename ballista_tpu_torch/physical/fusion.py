"""Whole-stage fusion: run each pipeline stage as ONE governed program.

The port of the JAX package's ``physical/fusion.py``. It runs AFTER
physical planning, at the standalone collect (``client.py``,
``execution.py``). Three rewrites, all gated by ``BALLISTA_FUSION``
(default on):

- **Aggregate stages** (:class:`FusedStageExec`): a partial/final
  ``HashAggregateExec`` absorbs the scan→filter→project pipeline chain
  feeding it. The chain's ``device_transform``s run INSIDE the
  aggregate's programs (``HashAggregateExec._device_prologue``), so the
  whole stage is one governed entry — one captured CUDA graph per call
  signature on a card — and it runs once per partition over the
  CONCATENATED source batches instead of once per scan chunk.
- **Probe-side join chains**: Filter/Projection chains feeding a
  ``JoinExec`` probe fold into the join's probe programs
  (``JoinExec.probe_chain``) when every probe key column passes through
  the chain as a plain column reference.
- **Distinct-within-group** (:class:`FusedDistinctCountExec`): the SQL
  planner's COUNT(DISTINCT) two-level rewrite (dedup on (g, x), then
  count per g — three sort-based groupings) collapses into ONE program
  (``kernels.aggregate.grouped_distinct_count``, one lexicographic
  order).

Fusion reorders NOTHING: live-row order, group emission order and all
arithmetic are preserved, so results equal those with
``BALLISTA_FUSION=0`` (float sums within the card's atomic ordering,
which neither setting fixes).
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from ..columnar import Column, ColumnBatch, round_capacity
from ..cache.donation import mark_transient
from ..compile import fingerprint
from ..datatypes import Field, Schema
from .. import expr as ex
from ..kernels.aggregate import grouped_distinct_count
from ..kernels.expr_eval import Evaluator
from ..observability import trace_event, trace_span
from .aggregate import HashAggregateExec
from .base import (PhysicalPlan, PipelineOp, Partitioning, SchemaLeaf,
                   concat_batches)
from .join import JoinExec
from .operators import FilterExec, MergeExec, ProjectionExec

# pipeline operators whose device_transform may run inside a fused stage
# program (a future stateful one must opt in explicitly)
_FUSABLE_OPS = (FilterExec, ProjectionExec)


def fusion_enabled() -> bool:
    return os.environ.get("BALLISTA_FUSION", "on").lower() not in (
        "0", "off", "false", "no")


# ---------------------------------------------------------------------------
# shared chain mechanics
# ---------------------------------------------------------------------------


def _chain_prologue(chain: Sequence[PipelineOp], batch: ColumnBatch):
    """Apply a fused chain (innermost first), inside a program."""
    for op in chain:
        batch = op.device_transform(batch)
    return batch


def _rebuild_chain(chain: Sequence[PipelineOp], source: PhysicalPlan):
    """Re-link a fused chain over a replacement source; signatures are
    value-based, so the rebuilt stage hits the same governed entries."""
    node: PhysicalPlan = source
    rebuilt: List[PipelineOp] = []
    for op in chain:
        node = op.with_new_children([node])
        rebuilt.append(node)
    return rebuilt, node


def _chain_label(chain, source, head: str, stage_no: int) -> str:
    parts = [type(source).__name__.replace("Exec", "")]
    parts += [type(op).__name__.replace("Exec", "") for op in chain]
    parts.append(head)
    return f"[fused stage {stage_no}: {'→'.join(parts)}]"


def _fused_pretty(node, indent: int, with_metrics: bool) -> str:
    """Plan text for a fused stage: the stage line, the absorbed
    operators marked ``[fused]``, then the source subtree."""
    if with_metrics:
        ann = node.metrics().summary()
        head = node.display() + (f", metrics=[{ann}]" if ann else "")
    else:
        head = node.display()
    out = "  " * indent + head + "\n"
    for op in reversed(node.chain):
        out += "  " * (indent + 1) + "· " + op.display() + " [fused]\n"
    sub = (node.source.pretty_metrics(indent + 1) if with_metrics
           else node.source.pretty(indent + 1))
    return out + sub


# ---------------------------------------------------------------------------
# FusedStageExec: pipeline chain + aggregate as one program
# ---------------------------------------------------------------------------


class FusedStageExec(HashAggregateExec):
    """A ``HashAggregateExec`` fused with the pipeline chain feeding it.

    ``chain`` holds the absorbed PipelineOps in apply order (innermost —
    closest to the source — first); ``child`` remains the chain's
    outermost operator so every schema derivation of the base class
    stays valid, but execution pulls RAW batches from ``source`` and the
    chain runs inside the aggregation programs via ``_device_prologue``.
    Which grouping path a batch takes is read off the chain's output on a
    few probe rows on the CPU (``HashAggregateExec._key_probe``), where
    the JAX package uses ``eval_shape``.
    """

    def __init__(self, mode, group_exprs, agg_exprs, chain, source,
                 group_capacity, stage_no: int = 0):
        if not chain:
            raise ValueError("a fused stage absorbs at least one pipeline op")
        super().__init__(mode, group_exprs, agg_exprs, chain[-1],
                         group_capacity)
        self.chain = list(chain)
        self.source = source
        self.stage_no = stage_no

    @classmethod
    def from_agg(cls, agg: HashAggregateExec, chain, source,
                 stage_no: int) -> "FusedStageExec":
        return cls(agg.mode, agg.group_exprs, agg.agg_exprs, chain,
                   source, agg.group_capacity, stage_no)

    # -- plan surface --------------------------------------------------------

    def children(self) -> List[PhysicalPlan]:
        return [self.source]

    def with_new_children(self, children):
        rebuilt, _top = _rebuild_chain(self.chain, children[0])
        return FusedStageExec(self.mode, self.group_exprs, self.agg_exprs,
                              rebuilt, children[0], self.group_capacity,
                              self.stage_no)

    def output_partitioning(self) -> Partitioning:
        if self.mode == "partial":
            return self.source.output_partitioning()
        return Partitioning(
            "unknown", self.source.output_partitioning().num_partitions)

    def _signature_parts(self) -> tuple:
        return HashAggregateExec._signature_parts(self) + (
            tuple(op.compile_signature() for op in self.chain),)

    def _detach(self) -> None:
        HashAggregateExec._detach(self)
        self.source = SchemaLeaf(self.source.output_schema())
        self.chain = [op.trace_twin() for op in self.chain]

    def display(self) -> str:
        head = "PartialAgg" if self.mode == "partial" else "FinalAgg"
        return (HashAggregateExec.display(self) + " "
                + _chain_label(self.chain, self.source, head,
                               self.stage_no))

    def pretty(self, indent: int = 0) -> str:
        return _fused_pretty(self, indent, with_metrics=False)

    def pretty_metrics(self, indent: int = 0) -> str:
        return _fused_pretty(self, indent, with_metrics=True)

    # -- execution -----------------------------------------------------------

    def _device_prologue(self, batch: ColumnBatch) -> ColumnBatch:
        return _chain_prologue(self.chain, batch)

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        batches = list(self.source.execute(partition))
        if not batches:
            return
        batch = concat_batches(self.source.output_schema(), batches)
        del batches  # the concat's inputs: not read past it
        if not self.group_exprs:
            out = self._exec_scalar(batch)
        else:
            out = self._exec_grouped(batch)
        # fresh program output, one downstream consumer: donatable
        mark_transient(out)
        yield out


# ---------------------------------------------------------------------------
# FusedDistinctCountExec: single-pass COUNT(DISTINCT x) GROUP BY g
# ---------------------------------------------------------------------------


class FusedDistinctCountExec(PhysicalPlan):
    """Replaces the COUNT(DISTINCT) double-aggregate tower
    (final-count ← partial-count ← final-dedup [← merge ← partial-dedup])
    with one program: order by (g, x) once, count distinct-pair starts
    per group (``grouped_distinct_count``). When the dedup ran on a
    single partition it is dropped entirely and this operator fuses the
    dedup's pipeline chain instead (the kernel dedups anyway)."""

    def __init__(self, group_exprs: List[ex.Expr], distinct_expr: ex.Expr,
                 out_field: Field, chain: Sequence[PipelineOp],
                 source: PhysicalPlan, group_capacity: int,
                 stage_no: int = 0):
        self.group_exprs = list(group_exprs)
        self.distinct_expr = distinct_expr
        self.out_field = out_field
        self.chain = list(chain)
        self.source = source
        self.group_capacity = group_capacity
        self.stage_no = stage_no
        self._in_schema = (chain[-1] if chain else source).output_schema()
        self._ev = Evaluator(self._in_schema)
        gf = [e.to_field(self._in_schema) for e in self.group_exprs]
        self._schema = Schema(gf + [out_field])

    # -- plan surface --------------------------------------------------------

    def output_schema(self) -> Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning(
            "unknown", self.source.output_partitioning().num_partitions)

    def children(self) -> List[PhysicalPlan]:
        return [self.source]

    def with_new_children(self, children):
        chain, _top = _rebuild_chain(self.chain, children[0])
        return FusedDistinctCountExec(
            self.group_exprs, self.distinct_expr, self.out_field, chain,
            children[0], self.group_capacity, self.stage_no)

    def _signature_parts(self) -> tuple:
        return (fingerprint(self.group_exprs),
                fingerprint(self.distinct_expr), self.out_field,
                self._in_schema,
                tuple(op.compile_signature() for op in self.chain))

    def _detach(self) -> None:
        self.source = SchemaLeaf(self.source.output_schema())
        self.chain = [op.trace_twin() for op in self.chain]

    def display(self) -> str:
        g = ", ".join(e.name() for e in self.group_exprs)
        return (f"FusedDistinctCountExec: gby=[{g}] "
                f"distinct={self.distinct_expr.name()} "
                + _chain_label(self.chain, self.source, "DistinctCount",
                               self.stage_no))

    def pretty(self, indent: int = 0) -> str:
        return _fused_pretty(self, indent, with_metrics=False)

    def pretty_metrics(self, indent: int = 0) -> str:
        return _fused_pretty(self, indent, with_metrics=True)

    # -- execution -----------------------------------------------------------

    def _device_prologue(self, batch: ColumnBatch) -> ColumnBatch:
        return _chain_prologue(self.chain, batch)

    def _get_fn(self, cap: int):
        def build():
            tw = self.trace_twin()

            def run(b: ColumnBatch):
                b = tw._device_prologue(b)
                key_evals = [tw._ev.evaluate(e, b) for e in tw.group_exprs]
                d = tw._ev.evaluate(tw.distinct_expr, b)
                keys = [torch.broadcast_to(r.values, (b.capacity,))
                        for r in key_evals]
                res = grouped_distinct_count(
                    keys, b.selection,
                    torch.broadcast_to(d.values, (b.capacity,)), cap,
                    [r.validity for r in key_evals], d.validity)
                return tw._assemble(b, key_evals, res, cap), \
                    res.num_groups

            return run

        return self.governed_jit(("agg.distinct", cap), build)

    def _assemble(self, batch, key_evals, res, cap: int):
        """GroupedResult -> output batch (group cols + count)."""
        cols: List[Column] = []
        idx = res.rep_indices.to(torch.int64)
        for f, r in zip(self._schema.fields[:-1], key_evals):
            vals = torch.broadcast_to(r.values, (batch.capacity,))[idx]
            validity = r.validity[idx] if r.validity is not None else None
            cols.append(Column(vals, f.dtype, validity, r.dictionary))
        cols.append(Column(res.aggregates[0], self.out_field.dtype, None,
                           None))
        return ColumnBatch(self._schema, cols, res.group_valid,
                           torch.clamp(res.num_groups, max=cap))

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        batches = list(self.source.execute(partition))
        if not batches:
            return
        batch = concat_batches(self.source.output_schema(), batches)
        cap = self.group_capacity
        while True:
            out, num_groups = self._get_fn(cap)(batch)
            with trace_span("device.block", site="agg.distinct"):
                ng = int(num_groups)  # between programs
            if ng <= cap:
                # persist like HashAggregateExec: later collects skip the
                # undersized attempt + retry sync
                self.group_capacity = max(self.group_capacity, cap)
                yield out
                return
            cap = round_capacity(ng)


# ---------------------------------------------------------------------------
# the fusion planner pass
# ---------------------------------------------------------------------------


def _passthrough_map(chain: Sequence[PipelineOp],
                     names: Sequence[str]) -> Optional[Dict[str, str]]:
    """post-chain column name -> raw source column name for ``names``,
    or None when any of them is computed/renamed by something other than
    a plain (possibly aliased) column reference."""
    mapping = {n: n for n in names}
    for op in reversed(chain):  # outermost first
        if isinstance(op, FilterExec):
            continue
        if not isinstance(op, ProjectionExec):
            return None
        nxt: Dict[str, str] = {}
        for post, cur in mapping.items():
            e = next((e for e in op.exprs if e.name() == cur), None)
            base = ex.strip_alias(e) if e is not None else None
            if not isinstance(base, ex.ColumnRef):
                return None
            nxt[post] = base.column
        mapping = nxt
    return mapping


def _match_distinct(node) -> Optional[tuple]:
    """Match the physical tower the SQL planner's COUNT(DISTINCT)
    rewrite produces:

        HashAggregateExec(final,  G, [count(x)])        <- node
          HashAggregateExec(partial, G, [count(x)])
            HashAggregateExec(final, G+[x], [])
              <base>   (MergeExec(partial-dedup) | partial-dedup | other)

    Returns (outer_final, inner_final, base, distinct_col, out_name) or
    None. Only exact HashAggregateExec nodes participate (an already
    fused subclass never re-matches)."""
    if not (type(node) is HashAggregateExec and node.mode == "final"):
        return None
    if not node.group_exprs or len(node._aggs) != 1:
        return None
    out_name, cagg = node._aggs[0]
    if cagg.fn != "count" or cagg.is_star or cagg.expr is None:
        return None
    tgt = ex.strip_alias(cagg.expr)
    if not isinstance(tgt, ex.ColumnRef):
        return None
    for e in node.group_exprs:
        if not isinstance(ex.strip_alias(e), ex.ColumnRef):
            return None
    part = node.child
    if not (type(part) is HashAggregateExec and part.mode == "partial"
            and fingerprint(part.group_exprs) == fingerprint(node.group_exprs)
            and fingerprint(part.agg_exprs) == fingerprint(node.agg_exprs)):
        return None
    inner = part.child
    if not (type(inner) is HashAggregateExec and inner.mode == "final"
            and not inner._aggs):
        return None
    inner_names = [e.name() for e in inner.group_exprs]
    outer_names = [e.name() for e in node.group_exprs]
    if inner_names[:-1] != outer_names or inner_names[-1] != tgt.column:
        return None
    return node, inner, inner.child, tgt.column, out_name


def _fusable_chain(node: PhysicalPlan):
    """(chain, source) of the pipeline chain ending at ``node``, or
    ([], node) when ``node`` is no PipelineOp or its chain holds an
    operator that may not run inside a fused program."""
    if isinstance(node, PipelineOp):
        chain, src = node._pipeline_chain()
        if all(isinstance(op, _FUSABLE_OPS) for op in chain):
            return chain, src
    return [], node


def _build_distinct(match, transform, counter, stats):
    node, inner, base, distinct_col, out_name = match

    def _matching_dedup(cand) -> bool:
        return (type(cand) is HashAggregateExec and cand.mode == "partial"
                and not cand._aggs
                and fingerprint(cand.group_exprs)
                == fingerprint(inner.group_exprs))

    chain: List[PipelineOp] = []
    if isinstance(base, MergeExec) and _matching_dedup(base.child):
        # Merge(partial-dedup): in-process the dedup is pure overhead —
        # the distinct kernel dedups by construction, and its row-wise
        # input chain commutes with the merge's concat. Merge the dedup's
        # RAW input partitions and absorb its chain.
        dedup = base.child
        chain, src = _fusable_chain(dedup.child)
        source: PhysicalPlan = MergeExec(src)
        group_exprs = list(dedup.group_exprs[:-1])
        distinct_expr: ex.Expr = dedup.group_exprs[-1]
    elif isinstance(base, MergeExec):
        # multi-partition dedup of an unrecognized shape stays; the
        # generic pass fuses the partial-dedup with its own chain when it
        # recurses into the merge
        source = base
        group_exprs = [ex.ColumnRef(e.name()) for e in inner.group_exprs[:-1]]
        distinct_expr = ex.ColumnRef(distinct_col)
    elif (_matching_dedup(base)
          and base.output_partitioning().num_partitions == 1):
        # single-partition dedup is pure overhead — the distinct kernel
        # dedups by construction. Fuse the dedup's own pipeline chain
        # into this stage instead.
        chain, source = _fusable_chain(base.child)
        group_exprs = list(base.group_exprs[:-1])
        distinct_expr = base.group_exprs[-1]
    elif base.output_partitioning().num_partitions == 1:
        source = base
        group_exprs = [ex.ColumnRef(e.name()) for e in inner.group_exprs[:-1]]
        distinct_expr = ex.ColumnRef(distinct_col)
    else:
        return None  # multi-partition base without a merge: leave as-is
    out_field = node.output_schema().fields[-1]
    fused = FusedDistinctCountExec(
        group_exprs, distinct_expr, out_field, chain, source,
        node.group_capacity, next(counter))
    if fused.output_schema() != node.output_schema():
        return None  # safety: the rewrite must be schema-invisible
    src2 = transform(source)
    if src2 is not source:
        fused = fused.with_new_children([src2])
    stats["distinct"] += 1
    trace_event("compile.fuse", kind="distinct",
                stage=fused.stage_no, ops=fused.display()[:160])
    return fused


def fuse_plan(phys: PhysicalPlan, *, fuse_joins: bool = True,
              _counter=None) -> PhysicalPlan:
    """One bottom-up fusion pass. Idempotent: already-fused operators
    only have their sources revisited, so re-running fuses new subtrees
    and (value-keyed signatures) reuses every governed entry.
    ``fuse_joins=False`` skips probe-chain fusion."""
    counter = _counter or itertools.count(1)
    stats = {"stages": 0, "joins": 0, "distinct": 0}

    def transform(node: PhysicalPlan) -> PhysicalPlan:
        if isinstance(node, (FusedStageExec, FusedDistinctCountExec)):
            src = transform(node.source)
            return (node if src is node.source
                    else node.with_new_children([src]))
        m = _match_distinct(node)
        if m is not None:
            fused = _build_distinct(m, transform, counter, stats)
            if fused is not None:
                return fused
        if type(node) is HashAggregateExec and \
                isinstance(node.child, PipelineOp):
            chain, source = _fusable_chain(node.child)
            if chain:
                fused = FusedStageExec.from_agg(node, chain, source,
                                                next(counter))
                src = transform(source)
                if src is not source:
                    fused = fused.with_new_children([src])
                stats["stages"] += 1
                trace_event("compile.fuse", kind="stage",
                            stage=fused.stage_no,
                            ops=fused.display()[:160])
                return fused
        if (fuse_joins and isinstance(node, JoinExec)
                and not node.probe_chain
                and isinstance(node.probe, PipelineOp)):
            chain, source = _fusable_chain(node.probe)
            key_map = (_passthrough_map(chain, [p for _, p in node.on])
                       if chain else None)
            if key_map is not None:
                build = transform(node.build)
                src = transform(source)
                stats["joins"] += 1
                fused_join = JoinExec(
                    build, src, node.on, node.how,
                    null_aware=node.null_aware,
                    partitioned=node.partitioned, device=node.device,
                    adaptive_note=node.adaptive_note,
                    probe_chain=chain, probe_key_raw=key_map)
                trace_event("compile.fuse", kind="join_probe",
                            ops=fused_join.display()[:160])
                return fused_join
        kids = node.children()
        if kids:
            new = [transform(c) for c in kids]
            if not all(a is b for a, b in zip(kids, new)):
                node = node.with_new_children(new)
        return node

    with trace_span("compile.fuse"):
        out = transform(phys)
        if any(stats.values()):
            # aggregate counts next to the per-stage events: the first
            # thing to grep when hunting silent de-fusion
            trace_event("compile.fuse", kind="summary",
                        stages=stats["stages"], joins=stats["joins"],
                        distinct=stats["distinct"])
    return out


def maybe_fuse(phys: PhysicalPlan, *,
               fuse_joins: bool = True) -> PhysicalPlan:
    """``fuse_plan`` behind the ``BALLISTA_FUSION`` gate, marking the root
    so repeated collects of a kept plan skip the walk."""
    if not fusion_enabled():
        return phys
    if getattr(phys, "_fusion_applied", False):
        return phys
    out = fuse_plan(phys, fuse_joins=fuse_joins)
    out._fusion_applied = True
    return out
