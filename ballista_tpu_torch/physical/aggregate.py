"""Hash-aggregate physical operator (Partial / Final modes).

The port of the JAX package's ``physical/aggregate.py``. Three grouping
paths, picked as the JAX package picks them, so each query takes the
same one:

- group keys whose cardinalities are known (dictionary codes, booleans)
  and multiply to at most ``DENSE_GROUP_LIMIT`` take the dense, sort-free
  path (``kernels.aggregate.dense_grouped_aggregate``, whose integer sums
  run in the CUDA kernel on a card);
- keys that are each dictionary-coded or integer-valued with a live range
  small enough take the mixed/ranged path: an O(N) scatter into a
  mixed-radix table (``dense_grouped_scatter``), no sort, no overflow;
- everything else takes the sort-based ``grouped_aggregate``, which
  re-runs at a larger group capacity when the true group count overflows
  and remembers the capacity it learned.

Ungrouped aggregates take ``scalar_aggregate``.

Each path is a governed program under the JAX package's namespaces
(``agg.grouped``, ``agg.mixed``, ``agg.mstats``, ``agg.scalar``), with
the host reads between programs, as there: the mixed path's statistics
and the overflow retry's group count. ``_device_prologue`` runs inside
every one of them, so a fused stage (``fusion.FusedStageExec``) runs its
pipeline chain in the same program. Which path a batch takes is decided
on the host from the keys' dtypes and dictionaries, found by running the
prologue and key evaluation once on a few rows on the CPU
(``_key_probe``).

State layout: Partial emits "group columns + state columns" batches
(avg -> sum+count states), Final regroups the concatenated partial tables,
merges states, and finalizes (avg division in scaled int64 -> Decimal(6)).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from ..columnar import Column, ColumnBatch, round_capacity
from ..compile import fingerprint
from ..datatypes import DataType, Decimal, Field, Float64, Int64, Schema
from ..errors import ExecutionError, NotImplementedError_
from .. import expr as ex
from ..kernels.aggregate import (
    AggInput,
    avg_fixed,
    dense_grouped_aggregate,
    dense_grouped_scatter,
    grouped_aggregate,
    scalar_aggregate,
)
from ..kernels.expr_eval import Evaluator
from ..cache.donation import mark_transient
from .base import (PhysicalPlan, Partitioning, concat_batches,
                   donating_call)

# dictionary-coded group keys with product-of-cardinalities at or below
# this use the sort-free dense path
DENSE_GROUP_LIMIT = 256

DEFAULT_GROUP_CAPACITY = 1 << 12


_PROBE_ROWS = 8


def _probe_batch(batch: ColumnBatch) -> ColumnBatch:
    """A batch of ``_PROBE_ROWS`` live rows on the CPU with ``batch``'s
    schema, dtypes, dictionaries and validity masks, every value 1 (a
    divisor, a code and a date alike). Running the chain and the key
    evaluation on it tells the host which dtypes and dictionaries the
    grouping programs will see, without touching the card (the JAX
    package traces ``eval_shape``; meta tensors would do too, but their
    first use imports several seconds of torch's tracing machinery)."""

    def ones(t):
        if t is None:
            return None
        return torch.ones((_PROBE_ROWS,) + tuple(t.shape[1:]),
                          dtype=t.dtype)

    cols = [Column(ones(c.values), c.dtype, ones(c.validity), c.dictionary)
            for c in batch.columns]
    return ColumnBatch(batch.schema, cols,
                       torch.ones(_PROBE_ROWS, dtype=torch.bool),
                       torch.full((), _PROBE_ROWS, dtype=torch.int32))


def _state_ops(agg: ex.AggregateExpr):
    """[(state_suffix, op)] for one aggregate expr."""
    if agg.fn == "count":
        return [("count", "count")]
    if agg.fn == "sum":
        return [("sum", "sum")]
    if agg.fn == "avg":
        return [("sum", "sum"), ("count", "count")]
    if agg.fn in ("min", "max"):
        return [(agg.fn, agg.fn)]
    raise NotImplementedError_(f"aggregate fn {agg.fn}")


def _state_specs(agg: ex.AggregateExpr, idx: int, in_schema: Schema):
    """Partial mode: [(state_field_name, op, state_dtype)] typed from the
    original input schema."""
    if agg.fn == "count":
        return [(f"__s{idx}_count", "count", Int64)]
    dt = agg.expr.to_field(in_schema).dtype
    if agg.fn in ("sum", "avg"):
        if dt.is_integer:
            sum_t: DataType = Int64
        elif dt.kind == "decimal":
            sum_t = dt
        else:
            sum_t = Float64
        out = [(f"__s{idx}_sum", "sum", sum_t)]
        if agg.fn == "avg":
            out.append((f"__s{idx}_count", "count", Int64))
        return out
    return [(f"__s{idx}_{agg.fn}", agg.fn, dt)]


class HashAggregateExec(PhysicalPlan):
    """mode: 'partial' (per input partition) or 'final' (after merge)."""

    def __init__(
        self,
        mode: str,
        group_exprs: List[ex.Expr],
        agg_exprs: List[ex.Expr],  # AggregateExpr or Alias(AggregateExpr)
        child: PhysicalPlan,
        group_capacity: int = DEFAULT_GROUP_CAPACITY,
    ):
        assert mode in ("partial", "final")
        self.mode = mode
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        self.child = child
        self.group_capacity = group_capacity
        self._in_schema = child.output_schema()
        self._ev = Evaluator(self._in_schema)
        self._aggs = [
            (e.name(), ex.strip_alias(e)) for e in self.agg_exprs
        ]
        for name, a in self._aggs:
            if not isinstance(a, ex.AggregateExpr):
                raise ExecutionError(f"not an aggregate expression: {name}")
        self._ranged_rejected = False
        # (dictionary-length fingerprint, _key_probe result) or None
        self._probe_cache = None

    # -- schemas ------------------------------------------------------------

    def group_fields(self) -> List[Field]:
        if self.mode == "partial":
            return [e.to_field(self._in_schema) for e in self.group_exprs]
        # final mode: group columns are already materialized in the input
        return [self._in_schema.field(e.name()) for e in self.group_exprs]

    def state_fields(self) -> List[Tuple[str, str, DataType]]:
        """Flattened (name, op, dtype) of all aggregate states."""
        out = []
        for i, (_, a) in enumerate(self._aggs):
            if self.mode == "partial":
                out.extend(_state_specs(a, i, self._in_schema))
            else:
                # final mode: dtype comes from the partial output schema
                for suffix, op in _state_ops(a):
                    name = f"__s{i}_{suffix}"
                    out.append((name, op, self._in_schema.field(name).dtype))
        return out

    def output_schema(self) -> Schema:
        gf = self.group_fields()
        if self.mode == "partial":
            sf = [Field(n, dt, True) for n, _, dt in self.state_fields()]
            return Schema(gf + sf)
        af = []
        for name, a in self._aggs:
            f = self._agg_output_field(name, a)
            af.append(f)
        return Schema(gf + af)

    def _agg_output_field(self, name: str, a: ex.AggregateExpr) -> Field:
        # final output dtype must match logical Aggregate schema; state
        # dtypes live in the partial schema under __s{i}_* names
        if a.fn == "count":
            return Field(name, Int64, False)
        i = self._agg_index(name)
        if a.fn == "avg":
            sum_f = self._in_schema.field(f"__s{i}_sum")
            if sum_f.dtype.kind == "decimal" or sum_f.dtype.is_integer:
                return Field(name, Decimal(6), True)
            return Field(name, Float64, True)
        if a.fn == "sum":
            return Field(name, self._in_schema.field(f"__s{i}_sum").dtype, True)
        return Field(name, self._in_schema.field(f"__s{i}_{a.fn}").dtype, True)

    def _agg_index(self, name: str) -> int:
        for i, (n, _) in enumerate(self._aggs):
            if n == name:
                return i
        raise ExecutionError(name)

    def output_partitioning(self) -> Partitioning:
        if self.mode == "partial":
            return self.child.output_partitioning()
        # final mode: one output partition per input partition (1 after a
        # merge; N when the partial states were hash-shuffled on the
        # group keys, in which case groups are co-located per partition)
        return Partitioning(
            "unknown", self.child.output_partitioning().num_partitions
        )

    def children(self):
        return [self.child]

    def display(self) -> str:
        g = ", ".join(e.name() for e in self.group_exprs)
        a = ", ".join(n for n, _ in self._aggs)
        return f"HashAggregateExec: mode={self.mode} gby=[{g}] aggr=[{a}]"

    def with_new_children(self, children):
        return HashAggregateExec(
            self.mode, self.group_exprs, self.agg_exprs, children[0],
            self.group_capacity,
        )

    def _signature_parts(self) -> tuple:
        return (self.mode, fingerprint(self.group_exprs),
                fingerprint(self.agg_exprs), self._in_schema)

    # -- execution ----------------------------------------------------------

    def _device_prologue(self, batch: ColumnBatch) -> ColumnBatch:
        """Batch transform applied INSIDE every aggregation program, before
        key/input evaluation. Identity here; ``fusion.FusedStageExec``
        overrides it with the fused pipeline chain."""
        return batch

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        batches = list(self.child.execute(partition))
        if not batches:
            return
        batch = concat_batches(self._in_schema, batches)
        del batches  # the concat's inputs: not read past it
        if not self.group_exprs:
            out = self._exec_scalar(batch)
        else:
            out = self._exec_grouped(batch)
        # fresh program output, one downstream consumer: donatable
        mark_transient(out)
        yield out

    # grouped ---------------------------------------------------------------

    def _key_probe(self, batch: ColumnBatch):
        """(post-prologue batch, key evaluations) over ``_probe_batch``:
        the dtypes, dictionaries and validity masks the grouping programs
        will see, found on the host. None when the chain cannot run on
        the probe rows (the JAX package's unprobeable chain). Cached per
        dictionary-length fingerprint, as the JAX package caches its
        probes: the layouts read only the lengths."""
        fp = tuple(len(c.dictionary) if c.dictionary is not None else -1
                   for c in batch.columns)
        cached = self._probe_cache
        if cached is not None and cached[0] == fp:
            return cached[1]
        tw = self.trace_twin()
        try:
            post = tw._device_prologue(_probe_batch(batch))
            key_evals, _ = tw._inputs_and_keys(post)
            probe = (post, key_evals)
        except (NotImplementedError, RuntimeError):
            probe = None  # unprobeable: no static bound, no mixed layout
        self._probe_cache = (fp, probe)
        return probe

    def _agg_inputs_partial(self, batch: ColumnBatch) -> List[AggInput]:
        aggs: List[AggInput] = []
        for i, (_, a) in enumerate(self._aggs):
            specs = _state_specs(a, i, self._in_schema)
            for (_, op, dt) in specs:
                if op == "count":
                    if a.is_star or a.fn == "avg" and a.expr is None:
                        aggs.append(AggInput("count", None, None))
                    else:
                        r = self._ev.evaluate(a.expr, batch)
                        aggs.append(AggInput("count", None, r.validity))
                else:
                    r = self._ev.evaluate(a.expr, batch)
                    v = torch.broadcast_to(r.values, (batch.capacity,))
                    v = self._to_state_dtype(v, r.dtype, dt)
                    aggs.append(AggInput(op, v, r.validity))
        return aggs

    def _agg_inputs_final(self, batch: ColumnBatch) -> List[AggInput]:
        aggs: List[AggInput] = []
        for name, op, dt in self.state_fields():
            col = batch.column(name)
            # merging states: counts and sums add up; min/min, max/max
            merge_op = "sum" if op in ("count", "sum") else op
            aggs.append(AggInput(merge_op, col.values, col.validity))
        return aggs

    def _to_state_dtype(self, v, src: DataType, dst: DataType):
        if dst.kind == "decimal" or dst.is_integer:
            return v.to(torch.int64)
        return v.to(torch.float32)

    def _run_grouping(self, batch: ColumnBatch, key_evals, aggs, cap):
        """Dense (sort-free) grouping when every key has a known
        cardinality and their product fits, else sort-based grouping."""
        cards = []
        for r in key_evals:
            if r.dictionary is not None:
                cards.append(len(r.dictionary))
            elif r.dtype.kind == "boolean":
                cards.append(2)
            else:
                cards = None
                break
        if cards is not None:
            g_total = 1
            for r, card in zip(key_evals, cards):
                g_total *= card + (1 if r.validity is not None else 0)
            if 0 < g_total <= min(DENSE_GROUP_LIMIT, cap):
                gid = torch.zeros((batch.capacity,), dtype=torch.int32,
                                  device=batch.device)
                for r, card in zip(key_evals, cards):
                    slots = card + (1 if r.validity is not None else 0)
                    code = torch.broadcast_to(r.values.to(torch.int32),
                                              (batch.capacity,))
                    if r.validity is not None:
                        # NULL keys take the extra slot per key column
                        code = torch.where(r.validity, code, card)
                    gid = gid * slots + code
                return dense_grouped_aggregate(gid, batch.selection, aggs,
                                               g_total)
        keys = [torch.broadcast_to(r.values, (batch.capacity,))
                for r in key_evals]
        return grouped_aggregate(keys, batch.selection, aggs, cap,
                                 [r.validity for r in key_evals])

    def _static_group_bound(self, batch: ColumnBatch) -> Optional[int]:
        """Host-side upper bound on the group count when every group key
        is a plain column with known cardinality (dictionary/boolean) —
        the dense path's condition, read off the batch's columns. Such a
        grouping cannot overflow, so it skips the overflow check."""
        g = 1
        for e in self.group_exprs:
            if self.mode == "partial":
                base = ex.strip_alias(e)
                if not isinstance(base, ex.ColumnRef):
                    return None
                name = base.column
            else:
                name = e.name()
            if not batch.schema.has_field(name):
                return None
            col = batch.column(name)
            if col.dictionary is not None:
                card = len(col.dictionary)
            elif col.dtype.kind == "boolean":
                card = 2
            else:
                return None
            g *= card + (1 if col.validity is not None else 0)
        return g if g > 0 else None

    # Ranged/mixed dense grouping: when every group key is either
    # dictionary-coded (static cardinality) or integer-valued with a
    # live range fitting below these bounds, rows aggregate by O(N)
    # scatter into a mixed-radix [G] table — no sort, no overflow retry.
    # The range cap bounds table memory; the live-rows factor keeps
    # pathological sparse keys (hash-like ids) on the sort path. The
    # same limits as the JAX package, so each query takes the same path.
    _RANGED_DENSE_LIMIT = 1 << 23
    _RANGED_CAP_FACTOR = 16
    _RANGED_KINDS = ("int32", "int64", "decimal", "date32", "timestamp_ns")

    def _mixed_layout(self, key_evals):
        """Per group key: ("dict", slots) for dictionary/boolean keys or
        ("int", None) for integer-valued keys (expressions included, e.g.
        EXTRACT(YEAR ...)); None when any key is neither. The JAX package
        classifies by tracing the evaluator without compute; here the
        keys are already evaluated once for the whole grouping, and their
        dtypes and dictionaries classify them."""
        layout = []
        for r in key_evals:
            if r.dictionary is not None:
                layout.append(("dict", len(r.dictionary) + 1))  # +1 NULL slot
            elif r.dtype.kind == "boolean":
                layout.append(("dict", 3))
            elif r.dtype.kind in self._RANGED_KINDS:
                layout.append(("int", None))
            else:
                return None
        return layout

    def _mixed_stats(self, batch: ColumnBatch, layout):
        """(per-int-key (min, max) list, live rows): one governed program,
        then one host fetch of its stacked scalars."""

        def build():
            tw = self.trace_twin()

            def stats(b: ColumnBatch):
                b = tw._device_prologue(b)
                kes, _ = tw._inputs_and_keys(b)
                i64_max = torch.iinfo(torch.int64).max
                vals = []
                for (kind, _), r in zip(layout, kes):
                    if kind != "int":
                        continue
                    v = torch.broadcast_to(r.values,
                                           (b.capacity,)).to(torch.int64)
                    live = b.selection
                    if r.validity is not None:
                        live = live & r.validity
                    vals += [torch.where(live, v, i64_max).min(),
                             torch.where(live, v, -i64_max).max()]
                vals.append(b.selection.sum(dtype=torch.int64))
                return torch.stack(vals)

            return stats

        fn = self.governed_jit(("agg.mstats", tuple(layout)), build)
        host = fn(batch).tolist()  # the one host read, between programs
        return list(zip(host[:-1:2], host[1:-1:2])), host[-1]

    def _mixed_build(self, spans, layout):
        """Grouping program for mixed dict/ranged-int keys: mixed-radix gid
        over per-key slots (slot 0 of each radix = NULL), O(N) scatter
        aggregation, no sort and no overflow. The integer keys' bases are
        an argument, so batches whose ranges quantize to the same spans
        share one program. The table is padded to a power of two; gids
        stay below the exact product of the spans."""

        def build():
            tw = self.trace_twin()
            g_total = 1
            for sp in spans:
                g_total *= sp
            g = round_capacity(g_total)

            def run(b: ColumnBatch, bases):
                b = tw._device_prologue(b)
                key_evals, aggs = tw._inputs_and_keys(b)
                gid = torch.zeros((b.capacity,), dtype=torch.int64,
                                  device=b.device)
                bi = 0
                for (kind, _), span, r in zip(layout, spans, key_evals):
                    v = torch.broadcast_to(r.values,
                                           (b.capacity,)).to(torch.int64)
                    if kind == "dict":
                        c = v + 1
                    else:
                        c = v - bases[bi] + 1
                        bi += 1
                    if r.validity is not None:
                        c = torch.where(r.validity, c, 0)
                    gid = gid * span + c
                res = dense_grouped_scatter(gid.to(torch.int32), b.selection,
                                            aggs, g)
                return tw._assemble(b, key_evals, res, g), res.num_groups

            return run

        return build

    def _grouped_fn(self, cap: int):
        """The ``agg.grouped`` program at group capacity ``cap``: dense
        (the CUDA kernel's path) or sort-based grouping, picked inside
        from the keys' dictionaries."""

        def build():
            tw = self.trace_twin()  # don't pin the input subtree

            def run(b: ColumnBatch):
                b = tw._device_prologue(b)
                key_evals, aggs = tw._inputs_and_keys(b)
                res = tw._run_grouping(b, key_evals, aggs, cap)
                return tw._assemble(b, key_evals, res, cap), res.num_groups

            return run

        return self.governed_jit(("agg.grouped", cap), build)

    def _exec_grouped(self, batch: ColumnBatch) -> ColumnBatch:
        cap = self.group_capacity
        probe = self._key_probe(batch)
        bound = (self._static_group_bound(probe[0])
                 if probe is not None else None)
        if bound is not None and bound <= min(DENSE_GROUP_LIMIT, cap):
            # the dense path: cannot overflow, no sync needed; one call,
            # no retry: safe to donate the batch
            out, _ng = donating_call(self._grouped_fn(cap), batch)
            return out
        # rejected once (hash-like sparse ids / huge products) -> rejected
        # for the operator's lifetime: don't pay the stats fetch again
        layout = None if (self._ranged_rejected or probe is None) else \
            self._mixed_layout(probe[1])
        if layout is not None:
            mm, nlive = self._mixed_stats(batch, layout)
            if not any(lo > hi for lo, hi in mm):
                # (no live rows: the sort path handles the empty batch)
                spans, bases = [], []
                true_total = 1  # product of UNQUANTIZED spans
                it = iter(mm)
                for kind, slots in layout:
                    if kind == "dict":
                        spans.append(slots)
                        true_total *= slots
                    else:
                        lo, hi = next(it)
                        # +1 NULL slot; quantized as in the JAX package
                        spans.append(round_capacity(hi - lo + 2))
                        bases.append(lo)
                        true_total *= hi - lo + 2
                g_total = 1
                for sp in spans:
                    g_total *= sp
                # admission gates on LIVE rows, with the TRUE span
                # product; the quantized table must fit the absolute cap
                if (true_total <= self._RANGED_CAP_FACTOR * (nlive + 256)
                        and g_total <= self._RANGED_DENSE_LIMIT):
                    # the final call on this batch (the stats were read
                    # on the host already): donatable
                    fn = self.governed_jit(
                        ("agg.mixed", tuple(spans), tuple(layout)),
                        self._mixed_build(tuple(spans), layout))
                    out, _ng = donating_call(fn, batch, torch.tensor(
                        bases, dtype=torch.int64, device=batch.device))
                    return out  # gid < G by construction: no overflow
                self._ranged_rejected = True
        # sort path with the overflow retry
        while True:
            out, num_groups = self._grouped_fn(cap)(batch)
            ng = int(num_groups)  # between programs
            if ng <= cap:
                # persist the learned capacity: the operator is reused
                # across partitions and collects
                self.group_capacity = max(self.group_capacity, cap)
                return out
            cap = round_capacity(ng)

    def _inputs_and_keys(self, batch: ColumnBatch):
        """(key_evals, aggs) for the current mode."""
        if self.mode == "partial":
            key_evals = [self._ev.evaluate(e, batch) for e in self.group_exprs]
            aggs = self._agg_inputs_partial(batch)
        else:
            key_evals = [
                self._ev.evaluate(ex.ColumnRef(e.name()), batch)
                for e in self.group_exprs
            ]
            aggs = self._agg_inputs_final(batch)
        return key_evals, aggs

    def _assemble(self, batch: ColumnBatch, key_evals, res, cap: int):
        """GroupedResult -> output ColumnBatch."""
        out_cols: List[Column] = []
        gf = self.group_fields()
        idx = res.rep_indices.to(torch.int64)
        for f, r in zip(gf, key_evals):
            vals = torch.broadcast_to(r.values, (batch.capacity,))[idx]
            validity = r.validity[idx] if r.validity is not None else None
            out_cols.append(Column(vals, f.dtype, validity, r.dictionary))
        if self.mode == "partial":
            for (name, op, dt), arr, va in zip(
                self.state_fields(), res.aggregates, res.agg_valid
            ):
                out_cols.append(Column(arr, dt, va, None))
        else:
            out_cols.extend(self._finalize(res))
        return ColumnBatch(
            self.output_schema(), out_cols, res.group_valid,
            torch.clamp(res.num_groups, max=cap),
        )

    def _finalize(self, res) -> List[Column]:
        """final mode: merge states -> output aggregate columns."""
        cols: List[Column] = []
        state_arrays = res.aggregates
        si = 0
        for i, (name, a) in enumerate(self._aggs):
            ops = _state_ops(a)
            n_states = len(ops)
            arrs = state_arrays[si : si + n_states]
            dts = [
                self._in_schema.field(f"__s{i}_{suffix}").dtype
                for suffix, _ in ops
            ]
            si += n_states
            valids = res.agg_valid[si - n_states : si]
            out_f = self._agg_output_field(name, a)
            if a.fn == "count":
                cols.append(Column(arrs[0], Int64, None, None))
            elif a.fn == "avg":
                s, c = arrs[0], arrs[1]
                sum_dt = dts[0]
                if sum_dt.kind == "decimal" or sum_dt.is_integer:
                    scale = sum_dt.scale if sum_dt.kind == "decimal" else 0
                    val = avg_fixed(s, c, scale)
                    cols.append(Column(val, Decimal(6), c > 0, None))
                else:
                    val = s.to(torch.float32) / torch.clamp(c, min=1).to(torch.float32)
                    cols.append(Column(val, Float64, c > 0, None))
            else:  # sum/min/max: NULL when no valid input was seen
                cols.append(Column(arrs[0], out_f.dtype, valids[0], None))
        return cols

    # ungrouped -------------------------------------------------------------

    def _exec_scalar(self, batch: ColumnBatch) -> ColumnBatch:
        def build():
            tw = self.trace_twin()

            def run(b: ColumnBatch):
                b = tw._device_prologue(b)
                if tw.mode == "partial":
                    aggs = tw._agg_inputs_partial(b)
                else:
                    aggs = tw._agg_inputs_final(b)
                return scalar_aggregate(b.selection, aggs)

            return run

        # single call, batch never read again: donate when transient
        dev = batch.device
        vals, valids = donating_call(
            self.governed_jit(("agg.scalar",), build), batch)

        cap = 8

        def expand(v, valid, dt):
            arr = torch.zeros((cap,), dtype=dt.torch_dtype(), device=dev)
            arr[0] = v.to(dt.torch_dtype())
            validity = None
            if valid is not None:
                validity = torch.zeros((cap,), dtype=torch.bool, device=dev)
                validity[0] = valid
            return arr, validity

        cols: List[Column] = []
        schema = self.output_schema()
        if self.mode == "partial":
            for (name, op, dt), v, va in zip(self.state_fields(), vals, valids):
                arr, validity = expand(v, va, dt)
                cols.append(Column(arr, dt, validity, None))
        else:
            si = 0
            for i, (name, a) in enumerate(self._aggs):
                ops = _state_ops(a)
                arrs = vals[si : si + len(ops)]
                vas = valids[si : si + len(ops)]
                dts = [
                    self._in_schema.field(f"__s{i}_{suffix}").dtype
                    for suffix, _ in ops
                ]
                si += len(ops)
                out_f = self._agg_output_field(name, a)
                if a.fn == "avg":
                    s, c = arrs[0], arrs[1]
                    sum_dt = dts[0]
                    if sum_dt.kind == "decimal" or sum_dt.is_integer:
                        scale = sum_dt.scale if sum_dt.kind == "decimal" else 0
                        v = avg_fixed(s, c, scale)
                    else:
                        v = s.to(torch.float32) / torch.clamp(c, min=1).to(
                            torch.float32
                        )
                    arr, validity = expand(v, c > 0, out_f.dtype)
                    cols.append(Column(arr, out_f.dtype, validity, None))
                elif a.fn == "count":
                    arr, _ = expand(arrs[0], None, out_f.dtype)
                    cols.append(Column(arr, out_f.dtype, None, None))
                else:  # sum/min/max: NULL when no valid input
                    arr, validity = expand(arrs[0], vas[0], out_f.dtype)
                    cols.append(Column(arr, out_f.dtype, validity, None))
        sel = torch.zeros((cap,), dtype=torch.bool, device=dev)
        sel[0] = True
        return ColumnBatch(schema, cols, sel,
                           torch.ones((), dtype=torch.int32, device=dev))
