"""Optional prewarm pass: run the scan-side programs' first calls while
the scan parses.

The port of the JAX package's ``compile/prewarm.py``. With the bucket
ladder, the capacity a scan will emit is predictable from its estimated
row count before any byte is parsed, so a background thread can run the
first call of each scan-side program (fused aggregate stages, bare
pipeline chains) at the predicted capacity concurrently with parse and
upload. The targets and capacities are the JAX package's.

What a first call is differs: a JAX prewarm lowers and compiles abstract
values and runs nothing. Here there is nothing to trace or lower; a
program's first call is its eager warm-up on the card's side stream and
its capture as a CUDA graph (``compile/governor.py``), and that needs
real tensors. So the pass runs ``GovernedFunction.warm`` on a
placeholder batch that is safe to run: zero-filled tensors at the
predicted capacity on the scan's device, every row dead (``selection``
all false, ``num_rows`` 0), no validity, and a one-entry placeholder
``Dictionary`` per utf8 column, so a gather indexed by a code stays in
bounds (a device-side assert would poison the card's context for the
rest of the process). The result is thrown away.

What it can save: the governor keys a program on each column's
``Dictionary`` identity, so a graph warmed for a stage over utf8 columns
could never be replayed by the real call (q1's partial ``agg.grouped``
groups by two utf8 columns). For such a target the pass runs the eager
warm-up only and keeps no program (``warm(..., keep=False)``): a kept
graph would hold its static input buffers at the full predicted
capacity in the entry for as long as the entry lives, one more for every
new plan. What that warm-up saves is the first call's one-time costs:
CUDA's lazy module loading and the hand-written kernel's library load,
overlapped with the parse. A numeric or date stage at the predicted
capacity (q6's scalar stage) is warmed up and captured, and its real
call replays that graph and captures nothing more.

Gated by ``BALLISTA_PREWARM`` (default off, as in the JAX package). A
failure never fails the query: it is logged and counted in
``compile_stats()["prewarm_failures"]``.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import List, Optional, Tuple

import torch

from .buckets import bucket_capacity
from .governor import _STATS

log = logging.getLogger("ballista.compile.prewarm")


def prewarm_enabled() -> bool:
    return os.environ.get("BALLISTA_PREWARM", "").lower() in (
        "1", "on", "true")


def placeholder_batch(schema, cap: int, device):
    """A ``ColumnBatch`` of ``schema`` at capacity ``cap`` on ``device``
    that every program can run safely (module doc)."""
    from ..columnar import Column, ColumnBatch, Dictionary

    cols = []
    for f in schema.fields:
        shape = (cap, f.dtype.length) if f.dtype.kind == "list" else (cap,)
        cols.append(Column(
            torch.zeros(shape, dtype=f.dtype.torch_dtype(), device=device),
            f.dtype, None,
            Dictionary([""]) if f.dtype.kind == "utf8" else None,
        ))
    return ColumnBatch(
        schema, cols,
        torch.zeros((cap,), dtype=torch.bool, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def _inner_source(source):
    """The scanner under caching decorators (``io/cache.py``)."""
    inner = source
    while not hasattr(inner, "_capacity") and hasattr(inner, "inner"):
        inner = inner.inner
    return inner


def _scan_estimate(source) -> "Optional[Tuple[int, int]]":
    """(predicted per-partition emit capacity, estimated per-partition
    rows) of a table source, or None when it cannot be estimated —
    estimation may probe file metadata, so callers needing both figures
    share one call. Mirrors the quantization the sources apply at emit
    time (io/text.py / io/parquet.py)."""
    est = None
    try:
        est = source.estimated_rows()
    except Exception:  # noqa: BLE001 - estimation is best-effort
        return None
    if not est:
        return None
    nparts = max(source.num_partitions(), 1)
    per_part = max(est // nparts, 1)
    cap = bucket_capacity(per_part)
    # the emit cap lives on the inner scanner
    limit = getattr(_inner_source(source), "_capacity", None)
    if isinstance(limit, int) and limit > 0:
        cap = min(cap, limit)
    return cap, per_part


def _scan_capacity_hint(source) -> Optional[int]:
    hint = _scan_estimate(source)
    return hint[0] if hint is not None else None


def _fused_capacity_hint(source) -> Optional[int]:
    """Predicted capacity of a fused stage's CONCATENATED scan input.
    A chunked scan emits full chunks at the scanner's capacity limit
    plus one remainder rung; the fused stage concats them (exact sum —
    see base.concat_batches). Best-effort like everything here."""
    hint = _scan_estimate(source)
    if hint is None:
        return None
    per_part, rows = hint
    if rows <= per_part:
        return per_part
    chunks, rem = divmod(rows, per_part)
    return chunks * per_part + (bucket_capacity(rem) if rem else 0)


def collect_targets(phys) -> List[Tuple[object, object]]:
    """(governed fn, placeholder input batch) for every program whose
    first call currently waits for parse + upload to finish: fused
    aggregate stages rooted on a table scan (the whole-stage-fusion
    shape — prewarm and fusion share one key space), plus any bare
    pipeline chain still rooted on a scan (e.g. join build sides)."""
    from ..physical.base import PipelineOp
    from ..physical.fusion import FusedDistinctCountExec, FusedStageExec
    from ..physical.operators import ScanExec

    targets: List[Tuple[object, object]] = []
    seen = set()

    def scan_batch(source: ScanExec, fused: bool):
        cap = (_fused_capacity_hint(source.source) if fused
               else _scan_capacity_hint(source.source))
        device = getattr(_inner_source(source.source), "device", None)
        if cap is None or device is None:
            return None
        try:
            return placeholder_batch(source.output_schema(), cap, device)
        except Exception:  # noqa: BLE001 - exotic schema
            return None

    def walk(node, parent_is_pipeline: bool) -> None:
        if isinstance(node, (FusedStageExec, FusedDistinctCountExec)) \
                and id(node) not in seen:
            seen.add(id(node))
            if isinstance(node.source, ScanExec):
                batch = scan_batch(node.source, fused=True)
                if batch is not None:
                    if isinstance(node, FusedDistinctCountExec):
                        fn = node._get_fn(node.group_capacity)
                    elif node.group_exprs:
                        fn = node._grouped_fn(node.group_capacity)
                    else:
                        fn = node._scalar_fn()
                    targets.append((fn, batch))
            for c in node.children():
                walk(c, False)
            return
        is_pipe = isinstance(node, PipelineOp)
        if is_pipe and not parent_is_pipeline and id(node) not in seen:
            seen.add(id(node))
            chain, source = node._pipeline_chain()
            if isinstance(source, ScanExec):
                batch = scan_batch(source, fused=False)
                if batch is not None:
                    targets.append((node._fused_governed(), batch))
        for c in node.children():
            walk(c, is_pipe)

    walk(phys, False)
    return targets


def maybe_prewarm(phys) -> Optional[threading.Thread]:
    """Start the first calls of ``phys``'s scan-side programs on the
    daemon thread ``ballista-prewarm`` (once per plan instance). Returns
    the thread, or None when disabled / nothing to warm. A racing
    foreground first call of the same signature waits for the capture
    and replays it (``GovernedFunction.call_with``)."""
    if not prewarm_enabled() or getattr(phys, "_prewarmed", False):
        return None
    try:
        phys._prewarmed = True
    except AttributeError:  # exotic root without a __dict__
        return None
    try:
        targets = collect_targets(phys)
    except Exception:  # noqa: BLE001 - prewarm must never break a query
        log.exception("prewarm: collecting targets failed")
        _STATS["prewarm_failures"] += 1
        return None
    if not targets:
        return None

    def run() -> None:
        for fn, batch in targets:
            # a placeholder dictionary: no real call has this signature
            keep = all(c.dictionary is None for c in batch.columns)
            try:
                fn.warm(batch, keep=keep)
            except Exception:  # noqa: BLE001 - never the query's failure
                log.exception("prewarm: warming %r failed",
                              getattr(getattr(fn, "gf", fn), "key",
                                      ("?",))[0])
                _STATS["prewarm_failures"] += 1

    t = threading.Thread(target=run, name="ballista-prewarm", daemon=True)
    t.start()
    return t
