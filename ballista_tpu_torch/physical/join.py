"""Join physical operator.

The port of the JAX package's ``physical/join.py``. The build (left)
child is materialized once (a merged join's build partitions produced
concurrently through ``ingest.iter_partitions``) and tabled
(``kernels/join.py``): a dense direct-index table for near-dense
integer keys, else a sorted one. Probe batches stream through the
probe, which appends gathered build columns. FK->PK joins (unique
build keys) take the no-expansion path; duplicate build keys take the
expanding probe, whose output capacity grows on overflow.

Join types: inner, left (preserves the PROBE side — the planner picks
which logical side becomes the probe accordingly), semi, anti (also the
null-aware anti join behind ``NOT IN``), and full (a probe-preserving
pass plus one batch of unmatched build rows).

The probe side runs as governed programs under the JAX package's
namespaces (``join.stats``, ``join.unique``, ``join.expand``,
``join.unmatched``, ``join.mark``), captured as CUDA graphs on a card; the
build tables are eager torch ops, once per build. Only host scalars cross
to the host, between programs: the build statistics (one fetch), the
uniqueness and duplicate flags, and the expanding probe's match totals
(one fetch per window of batches). Whole-stage fusion (``fusion.py``)
may hand the join a ``probe_chain``: the Filter/Projection chain that fed
its probe side, applied inside every probe program, with
``probe_key_raw`` naming each probe key's column before the chain.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import torch

from ..columnar import (Column, ColumnBatch, Dictionary, empty_batch,
                        remap_between, round_capacity)
from ..compile import bucket_capacity
from ..datatypes import Schema
from ..errors import ExecutionError, NotImplementedError_
from ..ingest import KeyedLocks
from ..kernels import join as join_k
from .base import PhysicalPlan, Partitioning, concat_batches, maybe_compact

JOIN_TYPES = ("inner", "left", "semi", "anti", "full")

_I64_MAX = torch.iinfo(torch.int64).max


def _and(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    """Conjunction of two optional masks (None = all true)."""
    if a is None:
        return b
    if b is None:
        return a
    return torch.logical_and(a, b)


class JoinExec(PhysicalPlan):
    """build = left child (merged to 1 partition), probe = right child."""

    def __init__(
        self,
        build: PhysicalPlan,
        probe: PhysicalPlan,
        on: List[Tuple[str, str]],  # (build_col, probe_col)
        how: str = "inner",
        null_aware: bool = False,
        partitioned: bool = False,
        device=None,
        adaptive_note: Optional[str] = None,
        probe_chain: Optional[List] = None,
        probe_key_raw: Optional[dict] = None,
    ):
        if how not in JOIN_TYPES:
            raise NotImplementedError_(f"join type {how}")
        if not on:
            raise NotImplementedError_("joins require at least one key")
        self.build = build
        self.probe = probe
        self.on = list(on)
        self.how = how
        self.null_aware = null_aware  # SQL NOT IN anti-join semantics
        # partitioned: both children are hash-partitioned on the join keys
        # with the SAME partition count/hash (the planner wraps them in
        # RepartitionExec), so partition p joins build[p] x probe[p]
        self.partitioned = partitioned
        # where an empty hash partition's all-dead build batch is made
        self.device = torch.device(device) if device is not None else None
        # set when the adaptive pass rewrote this join (``display``)
        self.adaptive_note = adaptive_note
        # whole-stage fusion: the Filter/Projection chain that used to feed
        # the probe side, applied INSIDE every probe program. When set,
        # ``probe`` is the chain's SOURCE; ``probe_key_raw`` maps each
        # post-chain probe key column to its raw source column (for the
        # host-side dictionary remap).
        self.probe_chain = tuple(probe_chain or ())
        self.probe_key_raw = dict(probe_key_raw or {})
        # partition -> (table, batch, unique, has_null, key mode,
        #               codec tables, build keys, build live)
        self._build_data = {}
        # one build per key even when partitions run concurrently on the
        # ingest pool (ingest.iter_partitions)
        self._build_locks = KeyedLocks()
        self._remap_cache = {}
        self._expand_cap_floor = 0

    def _signature_parts(self) -> tuple:
        # partitioned/adaptive_note steer HOST orchestration only — no
        # governed closure reads them. A fused probe chain runs inside the
        # programs, so its signatures ride the key.
        return (self.how, tuple(self.on), self.null_aware,
                self.build.output_schema(), self._probe_out_schema(),
                tuple(op.compile_signature() for op in self.probe_chain))

    def _probe_out_schema(self) -> Schema:
        """Schema of probe batches AFTER the fused chain (the probe
        child's schema when nothing is fused)."""
        if self.probe_chain:
            return self.probe_chain[-1].output_schema()
        return self.probe.output_schema()

    def _probe_prologue(self, pb: ColumnBatch) -> ColumnBatch:
        """Fused probe-side chain (innermost first), inside programs."""
        for op in self.probe_chain:
            pb = op.device_transform(pb)
        return pb

    def _detach(self) -> None:
        from .base import SchemaLeaf

        self.build = SchemaLeaf(self.build.output_schema())
        self.probe = SchemaLeaf(self.probe.output_schema())
        self.probe_chain = tuple(op.trace_twin() for op in self.probe_chain)
        self._build_data = {}   # materialized build-side device buffers
        self._remap_cache = {}  # per-query dictionaries

    # -- composite keys ------------------------------------------------------
    #
    # Three representations, picked at build materialization:
    #   "raw"    1 key column: its int64 values, exact.
    #   "packed" 2 key columns within 31/32-bit ranges: (a << 32) | b.
    #   "codec"  anything else: each key column is iteratively RANKED
    #            against the (sorted) build side and packed with the
    #            running code, which is re-ranked back under the build
    #            capacity — exact for any number/width of key columns.
    #            Probe rows ride the same tables; a probe value absent
    #            from the build fails its exactness check and can never
    #            collide into a live build code.

    def _key_of(self, batch: ColumnBatch, cols: List[str]):
        """raw/packed representations (codec handled separately)."""
        first = batch.column(cols[0])
        keys = first.values.to(torch.int64)
        live_ext = first.validity
        if len(cols) == 2:
            second = batch.column(cols[1])
            keys = (keys << 32) | (second.values.to(torch.int64)
                                   & 0xFFFFFFFF)
            live_ext = _and(live_ext, second.validity)
        return keys, live_ext

    # Dense direct-index mode limits: table entries are int32 rows; cap
    # the table at 16M entries (64 MB) and at 8x the build capacity so
    # pathological sparse keys (e.g. hash-like ids) stay on the sorted
    # path.
    _DENSE_MAX_SIZE = 1 << 24
    _DENSE_FACTOR = 8

    def _build_stats(self, bb: ColumnBatch, cols: List[str]):
        """(host scalars, device live mask): per-col min/max over selected
        rows, live-key min/max for the first col, null-key flag — one
        program, then one fetch of its stacked scalars. The combined live
        mask stays on the device for the build to reuse."""
        names = ["has_null", "nlive"]
        for i in range(len(cols)):
            names += [f"sel_min_{i}", f"sel_max_{i}"]
        names += ["live_min", "live_max"]

        def build():
            tw = self.trace_twin()

            def stats(bb: ColumnBatch):
                live_ext = tw._key_live_ext(bb, cols)
                live = _and(bb.selection, live_ext)
                if live_ext is not None:
                    has_null = torch.any(bb.selection & ~live_ext)
                else:
                    has_null = torch.zeros((), dtype=torch.bool,
                                           device=bb.device)
                vals = [has_null.to(torch.int64),
                        live.sum(dtype=torch.int64)]
                for c in cols:
                    v = bb.column(c).values.to(torch.int64)
                    vals += [torch.where(bb.selection, v, _I64_MAX).min(),
                             torch.where(bb.selection, v, -_I64_MAX).max()]
                v0 = bb.column(cols[0]).values.to(torch.int64)
                vals += [torch.where(live, v0, _I64_MAX).min(),
                         torch.where(live, v0, -_I64_MAX).max()]
                return torch.stack(vals), live

            return stats

        scalars, live = self.governed_jit(("join.stats",), build)(bb)
        host = scalars.tolist()  # ONE sync, between programs
        return dict(zip(names, host)), live

    def _pick_mode(self, stats, ncols: int) -> str:
        if ncols == 1:
            return "raw"
        if ncols > 2:
            return "codec"  # codec handles any column count
        amin, amax = stats["sel_min_0"], stats["sel_max_0"]
        bmin, bmax = stats["sel_min_1"], stats["sel_max_1"]
        if amin > amax:
            return "packed"  # no selected rows: any representation works
        packable = (max(abs(amin), abs(amax)) < (1 << 31)
                    and bmin >= 0 and bmax < (1 << 32) - 1)
        return "packed" if packable else "codec"

    def _key_live_ext(self, batch: ColumnBatch, cols: List[str]):
        live_ext = None
        for c in cols:
            live_ext = _and(live_ext, batch.column(c).validity)
        return live_ext

    def _codec_build(self, bb: ColumnBatch, cols: List[str]):
        """(codes, live, tables) for the build side."""
        live = _and(bb.selection, self._key_live_ext(bb, cols))
        nlive = live.sum(dtype=torch.int64)
        cap = bb.capacity
        tables = []
        code = None
        for c in cols:
            v = bb.column(c).values.to(torch.int64)
            sv = torch.sort(torch.where(live, v, _I64_MAX)).values
            r = torch.searchsorted(sv, v)
            if code is None:
                code = r
                tables.append((sv, None))
            else:
                combined = code * (cap + 1) + r
                sc = torch.sort(torch.where(live, combined, _I64_MAX)).values
                code = torch.searchsorted(sc, combined)
                tables.append((sv, sc))
        return code, live, (tuple(tables), nlive)

    def _codec_probe(self, vals, tables, nlive):
        """(codes, exact mask) for probe key value arrays using the
        build's rank tables."""
        exact = torch.ones(vals[0].shape, dtype=torch.bool,
                           device=vals[0].device)
        cap = tables[0][0].shape[0]
        code = None
        for v, (sv, sc) in zip(vals, tables):
            r = torch.searchsorted(sv, v)
            hit = sv[r.clamp(max=cap - 1)] == v
            exact = exact & (r < nlive) & hit
            if code is None:
                code = r
            else:
                combined = code * (cap + 1) + r
                rc = torch.searchsorted(sc, combined)
                hitc = sc[rc.clamp(max=cap - 1)] == combined
                exact = exact & (rc < nlive) & hitc
                code = rc
        return code, exact

    # -- schema -------------------------------------------------------------

    def output_schema(self) -> Schema:
        bs, ps = self.build.output_schema(), self._probe_out_schema()
        if self.how in ("semi", "anti"):
            return ps
        seen = {f.name for f in bs.fields}
        extra = [f for f in ps.fields if f.name not in seen]
        return Schema(list(bs.fields) + extra)

    def estimated_rows(self):
        """Semi/anti joins emit a SUBSET of the probe side — the base
        sum-of-children over-estimate would also count the membership
        list, inflating a pruned side enough to flip cost-based
        orientation the wrong way."""
        if self.how in ("semi", "anti"):
            return self.probe.estimated_rows()
        return super().estimated_rows()

    def output_partitioning(self) -> Partitioning:
        if self.how == "full":
            # one task streams every probe partition and appends the
            # unmatched build rows (needs the global build-hit bitmap)
            return Partitioning("unknown", 1)
        return self.probe.output_partitioning()

    def children(self):
        return [self.build, self.probe]

    def with_new_children(self, children):
        return JoinExec(children[0], children[1], self.on, self.how,
                        self.null_aware, self.partitioned, self.device,
                        self.adaptive_note, list(self.probe_chain),
                        self.probe_key_raw)

    def release(self) -> None:
        self._build_data = {}
        self._remap_cache = {}

    def display(self) -> str:
        on = ", ".join(f"{l}={r}" for l, r in self.on)
        part = " partitioned" if self.partitioned else ""
        note = f" [adaptive: {self.adaptive_note}]" if self.adaptive_note \
            else ""
        fused = ""
        if self.probe_chain:
            ops = "→".join(type(op).__name__.replace("Exec", "")
                           for op in self.probe_chain)
            fused = f" [fused probe: {ops}]"
        return f"JoinExec: how={self.how} on=[{on}]{part}{note}{fused}"

    # -- execution ----------------------------------------------------------

    def _materialize_build(self, partition: int = 0):
        key = partition if self.partitioned else 0
        if key in self._build_data:  # fast path: no lock once built
            return self._build_data[key]
        with self._build_locks.get(key):
            if key not in self._build_data:
                self._build_data[key] = self._build_side(partition)
        return self._build_data[key]

    def _build_side(self, partition: int):
        if self.partitioned:
            batches = list(self.build.execute(partition))
        else:
            from ..ingest import iter_partitions

            # the build's partitions produce concurrently on the ingest
            # pool, in partition order (partition 0 inline)
            batches = list(iter_partitions(
                self.build,
                range(self.build.output_partitioning().num_partitions)))
        if not batches:
            if not self.partitioned or self.device is None:
                raise ExecutionError("join build side produced no batches")
            # a hash partition may be empty
            batches = [empty_batch(self.build.output_schema(), self.device)]
        bb = concat_batches(self.build.output_schema(), batches)
        bcols = [b for b, _ in self.on]
        stats, live = self._build_stats(bb, bcols)
        has_null_key = bool(stats["has_null"])
        nlive = stats["nlive"]
        mode = self._pick_mode(stats, len(bcols))
        if mode in ("raw", "packed"):
            keys, _ = self._key_of(bb, bcols)
            key_tables = ()
        else:
            keys, live, key_tables = self._codec_build(bb, bcols)
        table = None
        unique = True
        if mode == "raw" and nlive > 0:
            base = stats["live_min"]
            size = stats["live_max"] - base + 1
            if 0 < size <= min(self._DENSE_MAX_SIZE,
                               self._DENSE_FACTOR * bb.capacity):
                # quantized as in the JAX package; padding slots stay -1
                size = round_capacity(size)
                rows, dup = join_k.build_dense(keys, live, base, size)
                if not bool(dup):
                    # 0-d tensors, not Python ints: a probe program takes
                    # them as arguments, so every partition's build shares
                    # one program
                    table = join_k.BuildTable(
                        sorted_keys=None, order=None,
                        num_live=torch.full((), nlive, dtype=torch.int64,
                                            device=bb.device),
                        dense_rows=rows,
                        dense_base=torch.full((), base, dtype=torch.int64,
                                              device=bb.device))
        if table is None:
            table, uniq = join_k.build_sorted_with_unique(keys, live)
            unique = bool(uniq)
        return (table, bb, unique, has_null_key, mode, key_tables, keys,
                live)

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        (table, build_batch, unique, has_null_key, mode, key_tables,
         bkeys, blive) = self._materialize_build(partition)
        if self.how == "full":
            if partition != 0:
                raise ExecutionError("full outer join has a single partition")
            yield from self._execute_full(table, build_batch, unique,
                                          mode, key_tables, bkeys, blive)
            return
        if self.how == "anti" and self.null_aware and has_null_key:
            # SQL NOT IN with a NULL in the subquery: predicate is never
            # true -> empty result
            if self.probe_chain:
                # raw probe batches carry the SOURCE schema; emit one
                # all-dead batch of the (post-chain) output schema
                yield empty_batch(self.output_schema(),
                                  build_batch.device)
                return
            for pb in self.probe.execute(partition):
                yield pb.with_selection(torch.zeros_like(pb.selection))
            return
        if unique or self.how in ("semi", "anti"):
            # membership only for semi/anti: the unique probe works
            # regardless of build duplicates. Selective joins strand few
            # live rows in large batches; compacting shrinks every
            # downstream operator
            for pb in self.probe.execute(partition):
                remaps = self._remaps_for(build_batch, pb)
                yield maybe_compact(self._probe_unique_batch(
                    table, build_batch, pb, mode, key_tables, remaps))
        else:
            yield from self._probe_expand_stream(
                table, build_batch, self.probe.execute(partition), mode,
                key_tables)

    # full outer ------------------------------------------------------------

    def _execute_full(self, table, build_batch, unique, mode, key_tables,
                      bkeys, blive):
        """Probe-preserving (left) pass over every probe partition while
        accumulating which build rows matched, then one extra batch of
        unmatched build rows with null probe columns."""
        hit = torch.zeros_like(build_batch.selection)
        nparts = self.probe.output_partitioning().num_partitions
        for p in range(nparts):
            for pb in self.probe.execute(p):
                remaps = self._remaps_for(build_batch, pb)
                if unique:
                    yield self._probe_unique_batch(table, build_batch, pb,
                                                   mode, key_tables, remaps)
                else:
                    yield from self._probe_expand_stream(
                        table, build_batch, iter([pb]), mode, key_tables)
                hit |= self._mark_hits(pb, mode, key_tables, remaps,
                                       bkeys, blive)
        # selection, not blive: build rows with NULL join keys can never
        # match but SQL still emits them with null probe columns
        yield self._unmatched_build_batch(build_batch,
                                          build_batch.selection & ~hit)

    def _mark_hits(self, pb, mode, key_tables, remaps, bkeys, blive):
        """bool [build_cap]: build rows whose key appears among this probe
        batch's live keys (reverse membership probe; duplicates fine)."""

        def build():
            tw = self.trace_twin()

            def run(pb, key_tables, remaps, bkeys, blive):
                pb = tw._probe_prologue(pb)
                pkeys, plive = tw._probe_keys(pb, mode, key_tables, remaps)
                pt = join_k.build_lookup(pkeys, plive)
                _, matched = join_k.probe_unique(pt, bkeys, blive)
                return blive & matched

            return run

        fn = self.governed_jit(("join.mark", mode), build)
        return fn(pb, key_tables, remaps, bkeys, blive)

    def _unmatched_build_batch(self, bb: ColumnBatch,
                               unmatched) -> ColumnBatch:
        schema = self.output_schema()
        ps = self._probe_out_schema()
        cols = []
        for f in schema.fields:
            if bb.schema.has_field(f.name):
                cols.append(bb.column(f.name))
            else:  # probe-only column: all-NULL
                dt = ps.field(f.name).dtype
                d = Dictionary([]) if dt.kind == "utf8" else None
                cols.append(Column(
                    torch.zeros((bb.capacity,), dtype=dt.torch_dtype(),
                                device=bb.device),
                    dt, torch.zeros_like(unmatched), d))
        return ColumnBatch(schema, cols, unmatched,
                           unmatched.sum(dtype=torch.int32))

    # fast path: unique build keys ------------------------------------------

    def _probe_col_values(self, pb: ColumnBatch, pcol: str, remap):
        """Probe key column as int64 values + validity; utf8 codes are
        remapped into the BUILD dictionary's code space (codes are
        producer-local). Probe strings absent from the build dictionary
        map to -1 -> invalid (they cannot match anything)."""
        c = pb.column(pcol)
        v = c.values.to(torch.int64)
        valid = c.validity
        if remap is not None:
            v2 = join_k._gather(remap, v)
            miss = v2 < 0
            valid = _and(valid, ~miss)
            v = torch.where(miss, 0, v2)
        return v, valid

    def _probe_keys(self, pb: ColumnBatch, mode: str, key_tables, remaps):
        vals = []
        valid_all = None
        for (_, pcol), remap in zip(self.on, remaps):
            v, valid = self._probe_col_values(pb, pcol, remap)
            vals.append(v)
            valid_all = _and(valid_all, valid)
        plive = _and(pb.selection, valid_all)
        if mode == "codec":
            tables, nlive = key_tables
            pkeys, exact = self._codec_probe(vals, tables, nlive)
            return pkeys, plive & exact
        if mode == "raw":
            return vals[0], plive
        # packed: probe keys outside the packable range cannot equal any
        # (in-range) build key — mask them out instead of aliasing
        a, b = vals
        in_range = (torch.abs(a) < (1 << 31)) & (b >= 0) & (b < (1 << 32) - 1)
        keys = (a << 32) | (b & 0xFFFFFFFF)
        return keys, plive & in_range

    def _remaps_for(self, build_batch: ColumnBatch, pb: ColumnBatch):
        """Per key column: probe-code -> build-code remap tensor (or None
        when no dictionary translation is needed). Host-computed once per
        (key column, probe dictionary), exact via sorted-dict search."""
        out = []
        for bcol, pcol in self.on:
            bd = build_batch.column(bcol).dictionary
            # with a fused probe chain, pb is a RAW source batch: read the
            # key column under its pre-chain name (fusion guarantees probe
            # keys pass through the chain as plain references)
            pd_ = pb.column(self.probe_key_raw.get(pcol, pcol)).dictionary
            if bd is None and pd_ is None:
                out.append(None)
                continue
            if bd is None or pd_ is None:
                raise ExecutionError(
                    f"join key {bcol}={pcol} mixes utf8 and non-utf8 columns"
                )
            if bd is pd_:
                out.append(None)  # shared dictionary: codes comparable
                continue
            # keyed per column, identity-compared on hit, so at most one
            # pair per key column stays pinned
            cached = self._remap_cache.get(bcol)
            if cached is None or cached[0] is not bd or cached[1] is not pd_:
                remap = remap_between(pd_, bd)
                if len(remap) == 0:
                    remap = [-1]
                cached = (bd, pd_, torch.as_tensor(
                    remap, dtype=torch.int64, device=pb.device))
                self._remap_cache[bcol] = cached
            out.append(cached[2])
        return tuple(out)

    def _probe_unique_batch(self, table, build_batch, pb: ColumnBatch,
                            mode: str, key_tables, remaps) -> ColumnBatch:
        def build():
            tw = self.trace_twin()

            def run(table, bb, pb, key_tables, remaps):
                pb = tw._probe_prologue(pb)
                pkeys, plive = tw._probe_keys(pb, mode, key_tables, remaps)
                build_rows, matched = join_k.probe_unique(table, pkeys, plive)
                return tw._assemble(bb, pb, build_rows, matched,
                                    pb.selection)

            return run

        fn = self.governed_jit(("join.unique", mode), build)
        return fn(table, build_batch, pb, key_tables, remaps)

    # general path: expanding probe -----------------------------------------

    def _expand_run(self, table, build_batch, pb, mode, key_tables, remaps,
                    out_cap: int):
        """One expanding probe at a fixed output capacity. Returns
        (out_batch, total_matches 0-d tensor) without syncing."""

        def build():
            tw = self.trace_twin()

            def run(table, bb, pb, key_tables, remaps):
                pb = tw._probe_prologue(pb)
                pkeys, plive = tw._probe_keys(pb, mode, key_tables, remaps)
                prows, brows, olive, total = join_k.probe_expand(
                    table, pkeys, plive, out_cap)
                return tw._assemble_expanded(bb, pb, prows, brows,
                                             olive), total

            return run

        fn = self.governed_jit(("join.expand", mode, out_cap), build)
        return fn(table, build_batch, pb, key_tables, remaps)

    def _unmatched_batch(self, table, build_batch, pb, mode, key_tables,
                         remaps) -> ColumnBatch:
        """left/full: preserved probe rows with no match, null build
        columns. No sync."""

        def build():
            tw = self.trace_twin()

            def run(table, bb, pb, key_tables, remaps):
                pb = tw._probe_prologue(pb)
                pkeys, plive = tw._probe_keys(pb, mode, key_tables, remaps)
                counts = join_k.probe_counts(table, pkeys)
                unmatched = pb.selection & (~plive | (counts == 0))
                zero = torch.zeros((pb.capacity,), dtype=torch.int32,
                                   device=pb.device)
                return tw._assemble(bb, pb, zero,
                                    torch.zeros_like(unmatched), unmatched)

            return run

        fn = self.governed_jit(("join.unmatched", mode), build)
        return fn(table, build_batch, pb, key_tables, remaps)

    def _probe_expand_stream(self, table, build_batch, probe_iter,
                             mode: str, key_tables) -> Iterator[ColumnBatch]:
        """Expanding probe over a batch stream. The match totals of a
        window of batches are fetched in ONE sync; only overflowed
        batches re-run, at a ladder capacity, and the capacity learned
        becomes the floor for later batches."""
        if self.how not in ("inner", "left", "full"):
            raise NotImplementedError_(
                f"{self.how} join with duplicate build keys"
            )
        window = max(int(os.environ.get("BALLISTA_JOIN_SYNC_WINDOW", 8)), 1)
        # the window also bounds the BYTES held on the device (probe and
        # expanded output buffers stay live until their totals are read)
        window_bytes = int(os.environ.get(
            "BALLISTA_JOIN_SYNC_WINDOW_BYTES", str(1 << 30)))
        row_bytes = sum(
            f.dtype.device_dtype().itemsize * (getattr(f.dtype, "length", 0)
                                               or 1)
            for f in list(self.output_schema().fields)
            + list(self._probe_out_schema().fields))
        pend: list = []
        pend_bytes = 0

        def flush():
            nonlocal pend_bytes
            pend_bytes = 0
            if not pend:
                return
            totals = torch.stack([p[-1] for p in pend]).tolist()  # ONE sync
            for (pb, remaps, out, out_cap, _), t in zip(pend, totals):
                while t > out_cap:  # rare: re-run at a ladder capacity
                    self.metrics().add_counter("expand_reruns")
                    out_cap = bucket_capacity(t)
                    out, tot = self._expand_run(
                        table, build_batch, pb, mode, key_tables, remaps,
                        out_cap)
                    t = int(tot)
                    self._expand_cap_floor = max(self._expand_cap_floor,
                                                 out_cap)
                yield maybe_compact(out, known_rows=min(t, out_cap))
                if self.how in ("left", "full"):
                    yield self._unmatched_batch(table, build_batch, pb,
                                                mode, key_tables, remaps)
            pend.clear()

        for pb in probe_iter:
            remaps = self._remaps_for(build_batch, pb)
            out_cap = max(pb.capacity, self._expand_cap_floor)
            out, total = self._expand_run(table, build_batch, pb, mode,
                                          key_tables, remaps, out_cap)
            pend.append((pb, remaps, out, out_cap, total))
            pend_bytes += (pb.capacity + out_cap) * row_bytes
            if len(pend) >= window or pend_bytes >= window_bytes:
                yield from flush()
        yield from flush()

    # assembly --------------------------------------------------------------

    def _assemble(self, bb, pb, build_rows, matched, probe_sel):
        """Probe-aligned output (no expansion)."""
        if self.how == "semi":
            return pb.with_selection(probe_sel & matched)
        if self.how == "anti":
            sel = probe_sel & ~matched
            if self.null_aware:
                # NULL NOT IN (...) is unknown, not true: drop null keys
                for _, pcol in self.on:
                    sel = _and(sel, pb.column(pcol).validity)
            return pb.with_selection(sel)
        if self.how == "inner":
            sel = probe_sel & matched
        else:  # left (probe-preserving outer)
            sel = probe_sel
        schema = self.output_schema()
        cols = []
        ps = pb.schema
        for f in schema.fields:
            if ps.has_field(f.name):
                cols.append(pb.column(f.name))
            else:
                c = bb.column(f.name)
                vals = join_k._gather(c.values, build_rows)
                validity = (join_k._gather(c.validity, build_rows)
                            if c.validity is not None
                            else torch.ones_like(matched))
                cols.append(Column(vals, c.dtype, validity & matched,
                                   c.dictionary))
        return ColumnBatch(schema, cols, sel, sel.sum(dtype=torch.int32))

    def _assemble_expanded(self, bb, pb, prows, brows, olive):
        schema = self.output_schema()
        cols = []
        ps = pb.schema
        for f in schema.fields:
            if ps.has_field(f.name):
                c, rows = pb.column(f.name), prows
            else:
                c, rows = bb.column(f.name), brows
            vals = join_k._gather(c.values, rows)
            validity = (join_k._gather(c.validity, rows)
                        if c.validity is not None else None)
            cols.append(Column(vals, c.dtype, validity, c.dictionary))
        return ColumnBatch(schema, cols, olive, olive.sum(dtype=torch.int32))
