"""Mesh-fused shuffle aggregation and join: the in-mesh fast path for a
Repartition(hash) -> HashAggregate(final) stage pair and for a
co-partitioned join.

The port of the JAX package's ``physical/mesh_agg.py``. When one executor
owns a mesh of slots, materializing N^2 shuffle files through the host
data plane (reference model: rust/core/src/execution_plans/
shuffle_reader.rs:77-99, whole partitions over Arrow Flight) is wasted
work. These operators run the pair as ONE program over the mesh's
stacked slots instead (``parallel/mesh.py``):

  per slot: partial state rows -> hash destination ids
         -> row exchange between slots   (kernels.mesh_shuffle)
         -> per-slot final aggregation   (groups are now co-located)

The row -> destination hash is ``compute_partition_ids``, the function
the host shuffle uses, so the mesh path and the file path always agree
on row placement (utf8 keys hash their string values, never
producer-local codes). The per-slot final aggregate is the
``agg.grouped`` body (``HashAggregateExec._grouped_body``), so q1's
dictionary keys reach the CUDA kernel ``dense_grouped_sums`` once per
slot inside the mesh program.

The scheduler's fusion pass (``distributed/scheduler.py``) builds these
nodes from a shuffle stage and its consumer when the executors report a
mesh (``num_devices``). Display strings are the JAX package's, so fused
stage DAGs read the same in both packages.
"""

from __future__ import annotations

from typing import Iterator, List

import torch

from ..columnar import Column, ColumnBatch, round_capacity
from ..compile import MESH_NS_CAP, bucket_capacity, governed
from ..datatypes import Schema
from ..errors import ExecutionError
from .. import expr as ex
from ..kernels import join as join_k
from ..kernels import mesh_shuffle
from ..kernels.expr_eval import Evaluator
from ..parallel.mesh import Mesh, SlotAxis, make_mesh, slot, stack
from .aggregate import DEFAULT_GROUP_CAPACITY, HashAggregateExec
from .base import PhysicalPlan, Partitioning, SchemaLeaf
from .mesh_input import mesh_ns


def _shuffle_side(b: ColumnBatch, hash_exprs, ev: Evaluator,
                  axis: SlotAxis, n_dev: int, in_cap: int) -> ColumnBatch:
    """Hash a stacked batch's rows by ``hash_exprs`` and exchange them
    between slots; returns the stacked post-exchange batch (per-slot
    capacity ``n_dev * in_cap``). Validity masks that are absent stay
    absent."""
    dest = axis.map(lambda s: _partition_ids(s, hash_exprs, n_dev, ev), b)
    arrays = [c.values for c in b.columns] + [
        c.validity for c in b.columns if c.validity is not None]
    out_arrays, out_live, _counts = mesh_shuffle.all_to_all_rows(
        arrays, b.selection, dest, axis, n_dev, in_cap)
    nf = len(b.schema.fields)
    validities = iter(out_arrays[nf:])
    cols = [Column(v, f.dtype,
                   next(validities) if c.validity is not None else None,
                   c.dictionary)
            for v, f, c in zip(out_arrays[:nf], b.schema.fields, b.columns)]
    return ColumnBatch(b.schema, cols, out_live,
                       out_live.sum(dim=1, dtype=torch.int32))


def _host_visible(stacked, mesh: Mesh):
    """Make a stacked output sliceable by THIS process: under a
    multi-process mesh the other processes' slots are gathered first (the
    output is small); a single-process mesh passes through."""
    from ..parallel.multihost import replicate_stacked

    if not mesh.distributed:
        return stacked
    return replicate_stacked(stacked, mesh)


def _set_drop(dst: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """``dst.at[idx].set(src, mode="drop")``: writes whose index falls
    outside ``dst`` go to a trash slot that is cut off."""
    c = dst.shape[0]
    idx = torch.where((idx >= 0) & (idx < c), idx, c).to(torch.int64)
    ext = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    if not isinstance(src, torch.Tensor):  # a constant: made on the device
        src = torch.full(tuple(idx.shape) + tuple(dst.shape[1:]), src,
                         dtype=dst.dtype, device=dst.device)
    ext[idx] = src
    return ext[:c]


class MeshAggExec(PhysicalPlan):
    """One task that replaces a whole shuffle stage pair.

    ``producer`` is the shuffle stage's child (scan -> ... -> partial
    aggregate, P partitions); its output rows are laid out over an
    ``n_devices``-slot mesh on ``device`` and exchanged between slots.
    Output: a single partition holding every slot's final groups.
    """

    def __init__(self, producer: PhysicalPlan, group_exprs: List[ex.Expr],
                 agg_exprs: List[ex.Expr], hash_exprs: List[ex.Expr],
                 n_devices: int,
                 group_capacity: int = DEFAULT_GROUP_CAPACITY,
                 device="cuda"):
        self.producer = producer
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        self.hash_exprs = list(hash_exprs)
        self.n_devices = n_devices
        self.group_capacity = group_capacity
        self.device = torch.device(device)
        self._partial_schema = producer.output_schema()
        self._final = HashAggregateExec(
            "final", self.group_exprs, self.agg_exprs,
            SchemaLeaf(self._partial_schema), group_capacity,
        )
        self._ev = Evaluator(self._partial_schema)

    # -- plan plumbing -------------------------------------------------------

    def output_schema(self) -> Schema:
        return self._final.output_schema()

    def output_partitioning(self) -> Partitioning:
        return Partitioning("unknown", 1)

    def children(self):
        return [self.producer]

    def with_new_children(self, children):
        return MeshAggExec(children[0], self.group_exprs, self.agg_exprs,
                           self.hash_exprs, self.n_devices,
                           self.group_capacity, self.device)

    def display(self) -> str:
        g = ", ".join(e.name() for e in self.group_exprs)
        return (f"MeshAggExec: {self.n_devices}-device ICI all_to_all "
                f"shuffle + final agg gby=[{g}]")

    def _signature_parts(self) -> tuple:
        from ..compile import fingerprint

        return (fingerprint(self.group_exprs), fingerprint(self.agg_exprs),
                fingerprint(self.hash_exprs), self.n_devices,
                self._partial_schema)

    def _detach(self) -> None:
        # _final's child is already schema-only; only the producer
        # subtree (scans and their caches) must be severed
        self.producer = SchemaLeaf(self._partial_schema)

    # -- execution -----------------------------------------------------------

    def _spmd(self, stacked, mesh: Mesh, cap: int, in_cap: int):
        """(stacked batch) -> (stacked out batch, num_groups [n_local])."""
        n_dev = self.n_devices

        def build():
            tw = self.trace_twin()
            final_fn = tw._final._grouped_body(cap)

            def run(stacked_b):
                axis = SlotAxis(mesh)
                b2 = _shuffle_side(stacked_b, tw.hash_exprs, tw._ev, axis,
                                   n_dev, in_cap)
                return axis.map(final_fn, b2)

            return run

        key = (mesh_ns("mesh.agg_spmd", mesh), self.compile_signature(),
               mesh, cap, in_cap)
        return governed(key, build, cap=MESH_NS_CAP,
                        metrics=self.metrics())(stacked)

    def execute_stacked(self, mesh: Mesh) -> ColumnBatch:
        """Device-resident execution: the stacked ``[n_local, cap]``
        output, consumed directly by a chained fused stage or sliced per
        slot by ``execute``."""
        from ..parallel.multihost import host_max
        from .mesh_input import stacked_input

        stacked, in_cap = stacked_input(self.producer, self._partial_schema,
                                        mesh)
        cap = self.group_capacity
        while True:
            out_stacked, num_groups = self._spmd(stacked, mesh, cap, in_cap)
            ng = host_max(num_groups)  # after the program
            if ng <= cap:
                return out_stacked
            cap = round_capacity(ng)  # overflow: re-run at the exact cap

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        if partition != 0:
            raise ExecutionError("MeshAggExec has a single output partition")
        mesh = make_mesh(self.n_devices, self.device)
        out_stacked = _host_visible(self.execute_stacked(mesh), mesh)
        for q in range(out_stacked.selection.shape[0]):
            yield slot(out_stacked, q)


def _partition_ids(batch: ColumnBatch, hash_exprs, n_dev: int,
                   ev: Evaluator):
    from .operators import compute_partition_ids

    return compute_partition_ids(batch, hash_exprs, n_dev, 0, ev)


class MeshJoinExec(PhysicalPlan):
    """Mesh-fused co-partitioned join: BOTH join inputs are exchanged
    between slots (hashed on the join keys) and joined per slot in the
    same program, with zero shuffle files.

    Built by the scheduler's fusion pass from a partitioned JoinExec
    stage and its two hash-shuffle producer stages. Supports every host
    join type (inner/left/semi/anti/full): co-partitioning makes
    unmatched-row detection local to each slot, so outer rows are
    appended after the matched expansion in the same static output
    buffer (host semantics: physical/join.py). Key representation is raw
    values for one key column, the exact rank codec otherwise. Output: a
    single partition holding every slot's joined rows (adaptive output
    capacity with a whole-program retry on overflow, like MeshAggExec).
    """

    def __init__(self, build_producer: PhysicalPlan,
                 probe_producer: PhysicalPlan, on, how: str,
                 n_devices: int, null_aware: bool = False, device="cuda"):
        if how not in ("inner", "left", "semi", "anti", "full"):
            raise ExecutionError(f"MeshJoinExec join type {how}")
        self.null_aware = null_aware
        self.build_producer = build_producer
        self.probe_producer = probe_producer
        self.on = list(on)
        self.how = how
        self.n_devices = n_devices
        self.device = torch.device(device)
        from .join import JoinExec

        # schema/key helpers only; never executed
        self._join = JoinExec(
            SchemaLeaf(build_producer.output_schema()),
            SchemaLeaf(probe_producer.output_schema()),
            self.on, how,
        )
        self._build_ev = Evaluator(build_producer.output_schema())
        self._probe_ev = Evaluator(probe_producer.output_schema())

    # -- plan plumbing -------------------------------------------------------

    def output_schema(self) -> Schema:
        return self._join.output_schema()

    def output_partitioning(self) -> Partitioning:
        return Partitioning("unknown", 1)

    def children(self):
        return [self.build_producer, self.probe_producer]

    def with_new_children(self, children):
        return MeshJoinExec(children[0], children[1], self.on, self.how,
                            self.n_devices, self.null_aware, self.device)

    def release(self) -> None:
        self._join.release()

    def display(self) -> str:
        on = ", ".join(f"{l}={r}" for l, r in self.on)
        return (f"MeshJoinExec: {self.n_devices}-device ICI all_to_all "
                f"join how={self.how} on=[{on}]")

    def _signature_parts(self) -> tuple:
        return (self.how, tuple(self.on), self.null_aware, self.n_devices,
                self.build_producer.output_schema(),
                self.probe_producer.output_schema())

    def _detach(self) -> None:
        self.build_producer = SchemaLeaf(self.build_producer.output_schema())
        self.probe_producer = SchemaLeaf(self.probe_producer.output_schema())
        # _join's children are already schema-only, but execute_stacked
        # fills its _remap_cache with per-query dictionaries: take its
        # own (cache-cleared) twin so the governed entry pins none
        self._join = self._join.trace_twin()

    # -- execution -----------------------------------------------------------

    def _slot_keys(self, b2: ColumnBatch, p2: ColumnBatch, remaps):
        """One slot's (build keys, build live, probe keys, probe live):
        raw values for a single key column, the rank codec otherwise."""
        join = self._join
        bcols = [b for b, _ in self.on]
        pcols = [p for _, p in self.on]
        if len(self.on) == 1:
            c = b2.column(bcols[0])
            bk = c.values.to(torch.int64)
            blive = b2.selection
            if c.validity is not None:
                blive = blive & c.validity
            pk, pvalid = join._probe_col_values(p2, pcols[0], remaps[0])
            plive = p2.selection
            if pvalid is not None:
                plive = plive & pvalid
            return bk, blive, pk, plive
        bk, blive, (tables, nlive) = join._codec_build(b2, bcols)
        pk, plive = join._probe_keys(p2, "codec", (tables, nlive), remaps)
        return bk, blive, pk, plive

    def _slot_membership(self, p2, pk, plive, table, bnull_any):
        """semi/anti: the probe-aligned output of one slot."""
        matched = join_k.probe_semi(table, pk, plive)
        if self.how == "semi":
            return p2.with_selection(p2.selection & matched)
        sel = p2.selection & ~matched
        if self.null_aware:
            # SQL NOT IN: a null key ANYWHERE in the build side (any
            # slot) makes the predicate never true; null-key probe rows
            # are dropped too
            for _, pcol in self.on:
                vv = p2.column(pcol).validity
                if vv is not None:
                    sel = sel & vv
            sel = sel & ~bnull_any
        return p2.with_selection(sel)

    def _slot_expand(self, b2, p2, bk, blive, pk, plive, table,
                     out_cap: int):
        """inner/left/full: one slot's joined rows at ``out_cap``, with
        outer rows appended after the matches; (batch, rows needed)."""
        out_schema = self.output_schema()
        probe_schema = self.probe_producer.output_schema()
        prows, brows, olive, total = join_k.probe_expand(table, pk, plive,
                                                         out_cap)
        need = total
        C = out_cap
        # outer rows: co-partitioning makes unmatched detection local;
        # they go after the matches in the same static buffer (overflow
        # rides the same retry as matches)
        sidx_p = sidx_b = None
        n_up = torch.zeros((), dtype=torch.int64, device=pk.device)
        if self.how in ("left", "full"):
            counts = join_k.probe_counts(table, pk)
            un_p = p2.selection & (~plive | (counts == 0))
            rank_p = torch.cumsum(un_p.to(torch.int64), 0) - un_p.to(
                torch.int64)
            n_up = un_p.sum(dtype=torch.int64)
            sidx_p = torch.where(un_p, total + rank_p, C)  # C drops
            need = need + n_up
        if self.how == "full":
            pt = join_k.build_lookup(pk, plive)
            _, bmat = join_k.probe_unique(pt, bk, blive)
            un_b = b2.selection & ~(blive & bmat)
            rank_b = torch.cumsum(un_b.to(torch.int64), 0) - un_b.to(
                torch.int64)
            sidx_b = torch.where(un_b, total + n_up + rank_b, C)
            need = need + un_b.sum(dtype=torch.int64)

        live = olive
        if sidx_p is not None:
            live = _set_drop(live, sidx_p, True)
        if sidx_b is not None:
            live = _set_drop(live, sidx_b, True)

        cols = []
        for f in out_schema.fields:
            from_probe = probe_schema.has_field(f.name)
            src = p2 if from_probe else b2
            rows = prows if from_probe else brows
            c = src.column(f.name)
            vals = join_k._gather(c.values, rows)
            validity = (join_k._gather(c.validity, rows)
                        if c.validity is not None else None)
            src_valid = c.validity if c.validity is not None else True
            if from_probe:
                if sidx_p is not None:
                    vals = _set_drop(vals, sidx_p, c.values)
                    if validity is not None:
                        validity = _set_drop(validity, sidx_p, src_valid)
                if sidx_b is not None:  # probe cols null on build-only rows
                    if validity is None:
                        validity = torch.ones((C,), dtype=torch.bool,
                                              device=live.device)
                    validity = _set_drop(validity, sidx_b, False)
            else:
                if sidx_p is not None:  # build cols null on probe-only rows
                    if validity is None:
                        validity = torch.ones((C,), dtype=torch.bool,
                                              device=live.device)
                    validity = _set_drop(validity, sidx_p, False)
                if sidx_b is not None:
                    vals = _set_drop(vals, sidx_b, c.values)
                    validity = _set_drop(validity, sidx_b, src_valid)
            cols.append(Column(vals, f.dtype, validity, c.dictionary))
        out = ColumnBatch(out_schema, cols, live, live.sum(dtype=torch.int32))
        return out, need

    def _spmd(self, stacked_b, stacked_p, mesh: Mesh, remaps, out_cap: int,
              b_cap: int, p_cap: int):
        def build():
            # on a governed cache hit none of this work runs
            n_dev = self.n_devices
            bhash = [ex.ColumnRef(b) for b, _ in self.on]
            phash = [ex.ColumnRef(p) for _, p in self.on]
            tw = self.trace_twin()

            def run(sb, sp, remaps):
                axis = SlotAxis(mesh)
                b2s = _shuffle_side(sb, bhash, tw._build_ev, axis, n_dev,
                                    b_cap)
                p2s = _shuffle_side(sp, phash, tw._probe_ev, axis, n_dev,
                                    p_cap)
                pairs = [(slot(b2s, q), slot(p2s, q))
                         for q in range(axis.n_local)]
                keys = [tw._slot_keys(b2, p2, remaps) for b2, p2 in pairs]
                tables = [join_k.build_lookup(bk, blive)
                          for bk, blive, _, _ in keys]
                if tw.how in ("semi", "anti"):
                    # membership only: probe-aligned output, no expansion
                    bnull_any = None
                    if tw.how == "anti" and tw.null_aware:
                        bnull = torch.stack([b2.selection & ~blive
                                             for (b2, _), (_, blive, _, _)
                                             in zip(pairs, keys)])
                        bnull_any = axis.pmax(bnull)
                    outs = [tw._slot_membership(p2, pk, plive, t, bnull_any)
                            for (_, p2), (_, _, pk, plive), t
                            in zip(pairs, keys, tables)]
                    need = torch.zeros((axis.n_local,), dtype=torch.int64,
                                       device=mesh.device)
                    return stack(outs), need
                res = [tw._slot_expand(b2, p2, bk, blive, pk, plive, t,
                                       out_cap)
                       for (b2, p2), (bk, blive, pk, plive), t
                       in zip(pairs, keys, tables)]
                return (stack([o for o, _ in res]),
                        torch.stack([n for _, n in res]))

            return run

        key = (mesh_ns("mesh.join_spmd", mesh), self.compile_signature(),
               mesh, out_cap, b_cap, p_cap)
        return governed(key, build, cap=MESH_NS_CAP,
                        metrics=self.metrics())(stacked_b, stacked_p,
                                                remaps)

    def execute_stacked(self, mesh: Mesh) -> ColumnBatch:
        """Device-resident execution: both inputs laid out over the mesh
        (or taken straight from chained fused producers), joined in one
        program; the stacked ``[n_local, out_cap]`` output stays on the
        device."""
        from ..parallel.multihost import host_max
        from .mesh_input import stacked_input

        sb, b_cap = stacked_input(
            self.build_producer, self.build_producer.output_schema(), mesh)
        sp, p_cap = stacked_input(
            self.probe_producer, self.probe_producer.output_schema(), mesh)
        remaps = self._join._remaps_for(sb, sp)
        out_cap = self.n_devices * p_cap  # post-exchange probe rows/slot
        if self.how == "full":  # + room for unmatched build rows
            out_cap = bucket_capacity(out_cap + self.n_devices * b_cap)
        while True:
            out_stacked, totals = self._spmd(sb, sp, mesh, remaps, out_cap,
                                             b_cap, p_cap)
            t = host_max(totals)  # after the program
            if t <= out_cap:
                return out_stacked
            out_cap = bucket_capacity(t)  # duplicate-heavy keys: retry

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        if partition != 0:
            raise ExecutionError("MeshJoinExec has a single output partition")
        from .base import maybe_compact

        mesh = make_mesh(self.n_devices, self.device)
        out_stacked = _host_visible(self.execute_stacked(mesh), mesh)
        for q in range(out_stacked.selection.shape[0]):
            # selective joins (semi/anti especially) leave mostly-dead
            # slices; shrink them as the host join does before handing
            # batches to downstream host operators
            yield maybe_compact(slot(out_stacked, q))
