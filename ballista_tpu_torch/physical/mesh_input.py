"""Device-resident input assembly for mesh-fused stages.

The port of the JAX package's ``physical/mesh_input.py``. A fused
stage's producer partitions are executed on the mesh's device, laid out
into uniform per-slot batches there (dictionary remap, concat and
compaction are device gathers) and stacked into one ``[n_slots, cap]``
batch (``parallel/mesh.py``). Row data never round-trips host memory;
only the per-slot live-row counts are read, to pick the uniform
capacity.

Chaining: when a fused stage's producer is itself a mesh-fused operator
(or a projection/filter/partial aggregate over one), the producer's
stacked output feeds the consumer's program directly: a stage boundary
that stays in device memory (``STATS["chained_stages"]``).

The capacity floor of stacked compaction (``_maybe_compact_stacked``)
is the bucket ladder's floor (``compile/buckets.py``, 1024 rows by
default), the same rung every other compaction of the port lands on,
and not the 8 rows the JAX package's ``max(..., 8)`` suggests but its
ladder never reaches. A smaller target would only shrink the exchange
buffers of an already sparse stage below ``n^2 x 1024`` rows per column
(512 KiB of int64 at 8 slots), while every distinct capacity is another
program signature, and on a card another captured graph, of each mesh
program downstream.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..columnar import Column, ColumnBatch, Dictionary, empty_batch
from ..compile import MESH_NS_CAP, bucket_capacity, governed
from ..datatypes import Schema
from ..parallel.mesh import Mesh, SlotAxis, capacity

# Instrumentation (tests assert the device path actually ran):
#   slot_assemblies — producer outputs laid out over the mesh on device;
#   chained_stages  — stage inputs taken straight from a fused producer's
#                     stacked output (no re-assembly at all).
STATS = {"slot_assemblies": 0, "chained_stages": 0}


def reset_stats() -> None:
    STATS["slot_assemblies"] = 0
    STATS["chained_stages"] = 0


def mesh_ns(name: str, mesh: Mesh) -> str:
    """A mesh program's namespace: ``name`` in one process, where its
    programs capture on a card (``compile.governor.CAPTURE``), and
    ``name.group`` across processes, whose collectives run eagerly."""
    return name + ".group" if mesh.distributed else name


# ---------------------------------------------------------------------------
# dictionary unification (host metadata only; code remap is a device gather)
# ---------------------------------------------------------------------------


def _union_dicts(schema: Schema, batches: List[ColumnBatch]):
    """Per field: one shared dictionary for every batch + per-batch int32
    remap tables (None where codes are already in the shared space).
    Only dictionary VALUES (host metadata) are touched; row data stays on
    the device."""
    n_fields = len(schema.fields)
    remaps = [[None] * n_fields for _ in batches]
    dicts: List[Optional[Dictionary]] = []
    for i in range(n_fields):
        ds = [b.columns[i].dictionary for b in batches]
        d0 = next((d for d in ds if d is not None), None)
        if d0 is None:
            dicts.append(None)
            continue
        if all(d is None or d is d0 for d in ds):
            dicts.append(d0)
            continue
        from ..observability import trace_span
        from .. import columnar_registry

        with trace_span("host.dictionary", site="mesh.union",
                        column=schema.fields[i].name, n_dicts=len(ds)):
            ud, rms = columnar_registry.unify(ds)
            for bi, r in enumerate(rms):
                if r is not None:
                    remaps[bi][i] = r
        dicts.append(ud)
    return dicts, remaps


def _apply_remaps(schema: Schema, b: ColumnBatch, remap_row, dicts
                  ) -> ColumnBatch:
    """Rebind a batch to the shared dictionaries (a device-side code
    gather, clamped as JAX's ``take(mode="clip")``); also normalizes the
    schema object so every slot shares one structure."""
    from ..columnar_registry import remap_codes

    cols = []
    for col, r, ud in zip(b.columns, remap_row, dicts):
        d = col.dictionary
        vals = col.values
        if ud is not None:
            if r is not None and d is not ud:
                vals = remap_codes(vals, r)
            d = ud
        cols.append(Column(vals, col.dtype, col.validity, d))
    return ColumnBatch(schema, cols, b.selection, b.num_rows)


# ---------------------------------------------------------------------------
# per-slot layout: compact live rows into a uniform fixed capacity
# ---------------------------------------------------------------------------


def _compact_impl(big: ColumnBatch, cap: int) -> ColumnBatch:
    """Gather live rows to the front of a [cap] batch (validity
    materialized so every slot shares one structure)."""
    from .base import compact_perm

    n = big.capacity
    dev = big.device
    perm = compact_perm(big.selection, min(cap, n)).to(torch.int64)
    if cap > n:
        perm = torch.cat([perm, torch.zeros((cap - n,), dtype=torch.int64,
                                            device=dev)])
    live = torch.arange(cap, dtype=torch.int32, device=dev) < big.num_rows
    cols = []
    for col in big.columns:
        vals = col.values[perm]
        validity = (col.validity[perm] if col.validity is not None
                    else torch.ones((cap,), dtype=torch.bool, device=dev))
        cols.append(Column(vals, col.dtype, validity & live,
                           col.dictionary))
    return ColumnBatch(big.schema, cols, live,
                       big.num_rows.to(torch.int32))


def _compact_to(big: ColumnBatch, cap: int) -> ColumnBatch:
    """The governed :func:`_compact_impl` at a static capacity."""
    return governed(
        ("mesh.compact_to", cap),
        lambda: lambda b: _compact_impl(b, cap),
    )(big)


# ---------------------------------------------------------------------------
# mesh assembly
# ---------------------------------------------------------------------------


def stack_to_mesh(slot_batches: List[ColumnBatch], mesh: Mesh):
    """Per-slot batches -> one stacked batch whose leaves are ``[n_slots,
    ...]`` tensors on the mesh's device. The single-process alias of
    ``multihost.stack_local_to_global`` (where local slots = all)."""
    from ..parallel.multihost import stack_local_to_global

    return stack_local_to_global(slot_batches, mesh)


def assemble_over_mesh(producer, schema: Schema, mesh: Mesh
                       ) -> Tuple[ColumnBatch, int]:
    """Execute ``producer``'s partitions, partition p feeding slot ``p %
    n``, and lay the output over the mesh: per-slot dictionary remap,
    concat and compaction all run as device gathers; only live-row
    counts are read on the host. Producers with fewer partitions than
    slots are ROW-split instead (windows of the compacted whole), so a
    1-partition dimension table does not put every row in one slot and
    inflate the uniform capacity n-fold.

    Multi-process meshes: each process executes only the partitions of
    its own slots, and the uniform capacity is agreed through a global
    max. utf8 dictionaries must then be content-identical across
    processes, as table-wide dictionaries of a scan are.
    Returns (stacked batch, per-slot capacity)."""
    from ..parallel import multihost

    n_dev = mesh.size
    multi = mesh.distributed
    local_slots = list(mesh.local_slots)
    nparts = producer.output_partitioning().num_partitions
    row_split = nparts < n_dev
    slots: List[List[ColumnBatch]] = [[] for _ in range(n_dev)]
    for p in range(nparts):
        slot_i = p % n_dev
        if multi and not row_split and slot_i not in local_slots:
            continue  # another process owns this slot
        slots[slot_i].extend(b.wait_upload() for b in producer.execute(p))
    for i in local_slots:
        if not slots[i] and not row_split:
            slots[i].append(empty_batch(schema, mesh.device))

    flat = [b for s in slots for b in s]
    dicts, remap_rows = _union_dicts(schema, flat)

    from .base import concat_batches

    slot_bigs: dict = {}
    i = 0
    for idx in range(n_dev):
        s = slots[idx]
        if not s:
            continue
        rows = remap_rows[i: i + len(s)]
        i += len(s)
        remapped = [_apply_remaps(schema, b, r, dicts)
                    for b, r in zip(s, rows)]
        slot_bigs[idx] = (remapped[0] if len(remapped) == 1
                          else concat_batches(schema, remapped))

    STATS["slot_assemblies"] += 1
    if row_split:
        # every process reads the whole (small) producer and slices its
        # local windows: duplicated work, but globally consistent
        bigs = [slot_bigs[k] for k in sorted(slot_bigs)]
        if not bigs:  # producer emitted nothing (e.g. an empty table)
            bigs = [empty_batch(schema, mesh.device)]
        big = bigs[0] if len(bigs) == 1 else concat_batches(schema, bigs)
        n = int(big.num_rows)  # scalar read only
        cap = bucket_capacity(max(-(-n // n_dev), 1))
        packed = _compact_to(big, n_dev * cap)
        slot_batches = [
            _window_slot(packed, d * cap, cap, min(max(n - d * cap, 0), cap))
            for d in local_slots
        ]
        return multihost.stack_local_to_global(slot_batches, mesh), cap

    from ..observability.tracing import trace_span

    # ONE batched read for all slot counts
    with trace_span("device.block", site="mesh.input_counts",
                    n=len(local_slots)):
        counts = torch.stack([slot_bigs[i].num_rows.to(mesh.device)
                              for i in local_slots])
    cap = bucket_capacity(max(multihost.host_max(counts), 1))
    slot_batches = [_compact_to(slot_bigs[i], cap) for i in local_slots]
    return multihost.stack_local_to_global(slot_batches, mesh), cap


def _window_slot(packed: ColumnBatch, start: int, cap: int,
                 count: int) -> ColumnBatch:
    """Rows [start, start+cap) of a front-compacted batch as a slot batch
    (device-side slices; ``count`` live rows at the front)."""
    dev = packed.device
    cols = [
        Column(c.values[start: start + cap], c.dtype,
               (c.validity[start: start + cap] if c.validity is not None
                else torch.ones((cap,), dtype=torch.bool, device=dev)),
               c.dictionary)
        for c in packed.columns
    ]
    live = packed.selection[start: start + cap]
    return ColumnBatch(packed.schema, cols, live,
                       torch.full((), count, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# chaining: fused producer -> fused consumer without leaving the device
# ---------------------------------------------------------------------------


def _maybe_compact_stacked(stacked: ColumnBatch, mesh: Mesh,
                           shrink_factor: int = 4) -> ColumnBatch:
    """Shrink a sparse stacked batch with one per-slot compaction (a
    host read of the ``[n]`` live counts, int32s, not data). The target
    capacity lands on the bucket ladder (module doc)."""
    from ..parallel.multihost import host_max

    cap = capacity(stacked)
    new_cap = bucket_capacity(host_max(stacked.num_rows))
    if new_cap * shrink_factor > cap:
        return stacked

    def build():
        def run(st):
            return SlotAxis(mesh).map(lambda b: _compact_impl(b, new_cap),
                                      st)

        return run

    key = (mesh_ns("mesh.compact", mesh), mesh, cap, new_cap)
    return governed(key, build, cap=MESH_NS_CAP)(stacked)


def _chain_pipeline(plan, chain, inner: ColumnBatch, mesh: Mesh
                    ) -> ColumnBatch:
    """Apply a PipelineOp chain per slot over a stacked input."""

    def build():
        # twins: don't pin the producer subtree in the governed entry
        twins = [op.trace_twin() for op in chain]

        def one(b):
            for op in twins:
                b = op.device_transform(b)
            return b

        def run(st):
            return SlotAxis(mesh).map(one, st)

        return run

    key = (mesh_ns("mesh.chain", mesh),
           tuple(op.compile_signature() for op in chain), mesh,
           capacity(inner))
    return governed(key, build, cap=MESH_NS_CAP,
                    metrics=plan.metrics())(inner)


def _chain_partial_agg(agg, inner: ColumnBatch, mesh: Mesh) -> ColumnBatch:
    """Run a partial HashAggregate per slot over a stacked input
    (adaptive group capacity with a whole-program retry, like the final
    aggregate inside MeshAggExec). A fused aggregate applies its chain
    inside, as its ``_device_prologue``."""
    from ..columnar import round_capacity
    from ..parallel.multihost import host_max

    in_cap = capacity(inner)
    cap = agg.group_capacity
    while True:
        def build(_cap=cap):
            fn = agg.trace_twin()._grouped_body(_cap)

            def run(st):
                return SlotAxis(mesh).map(fn, st)

            return run

        key = (mesh_ns("mesh.partial_agg", mesh), agg.compile_signature(),
               mesh, in_cap, cap)
        out_stacked, ngs = governed(key, build, cap=MESH_NS_CAP,
                                    metrics=agg.metrics())(inner)
        ng = host_max(ngs)
        if ng <= cap:
            return out_stacked
        cap = round_capacity(ng)


def _try_chain(plan, mesh: Mesh) -> Optional[ColumnBatch]:
    """Stacked per-slot output for plans rooted in a mesh-fused operator
    (possibly under projection/filter/partial-aggregate wrappers, fused
    or not), or None when the plan must be assembled from its
    partitions."""
    from .aggregate import HashAggregateExec
    from .base import PipelineOp
    from .fusion import FusedStageExec
    from .mesh_agg import MeshAggExec, MeshJoinExec

    if isinstance(plan, (MeshAggExec, MeshJoinExec)):
        if plan.n_devices != mesh.size:
            return None
        return plan.execute_stacked(mesh)
    if isinstance(plan, PipelineOp):
        chain, source = plan._pipeline_chain()
        inner = _try_chain(source, mesh)
        if inner is None:
            return None
        return _chain_pipeline(plan, chain, inner, mesh)
    if isinstance(plan, HashAggregateExec) and plan.mode == "partial" \
            and plan.group_exprs:
        # a fused aggregate reads RAW source batches and runs its chain
        # inside its program; a plain one reads its child's output
        src = plan.source if isinstance(plan, FusedStageExec) else plan.child
        inner = _try_chain(src, mesh)
        if inner is None:
            return None
        return _chain_partial_agg(plan, inner, mesh)
    return None


def stacked_input(producer, schema: Schema, mesh: Mesh
                  ) -> Tuple[ColumnBatch, int]:
    """The mesh-fused operator input contract: ``producer``'s rows as a
    stacked ``[n_local, cap]`` batch on the mesh's device, + cap. Chains
    in device memory when the producer is itself mesh-fused; never
    round-trips row data through the host either way."""
    chained = _try_chain(producer, mesh)
    if chained is not None:
        STATS["chained_stages"] += 1
        chained = _maybe_compact_stacked(chained, mesh)
        return chained, capacity(chained)
    return assemble_over_mesh(producer, schema, mesh)

