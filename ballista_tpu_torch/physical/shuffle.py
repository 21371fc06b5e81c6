"""Distributed shuffle operators.

The port of the JAX package's ``physical/shuffle.py``. A
``ShuffleReaderExec`` has an explicit device, where its batches land
(``ipc.batches_from_parts``); on a card the uploads run on the loading
thread's own upload stream (``side_stream_uploads``, never a stream a
concurrent capture records on) and each batch reaches the consumer
through ``wait_upload``.

Equivalents of the reference's shuffle trio (reference:
rust/core/src/execution_plans/{query_stage.rs,shuffle_reader.rs,
unresolved_shuffle.rs}):

- ``QueryStageExec`` marks a stage boundary; the executor runs its child for
  one partition and materializes the (hash-partitioned) output;
- ``UnresolvedShuffleExec`` is the planner's placeholder for inputs whose
  producing stages haven't completed; it refuses to execute;
- ``ShuffleReaderExec`` reads completed stage partitions: from the local
  filesystem when the producer shares it, else over the data-plane socket.
"""

from __future__ import annotations

import os
import threading
from contextlib import nullcontext
from typing import Iterator, List, Optional

import torch

from ..columnar import ColumnBatch, DeviceLike, side_stream_uploads
from ..datatypes import Schema
from ..errors import ExecutionError
from ..distributed.types import PartitionLocation
from .base import PhysicalPlan, Partitioning


class QueryStageExec(PhysicalPlan):
    """Stage boundary marker (reference: query_stage.rs:29-85). Execution
    (materializing output) is driven by the executor task runner, which
    also applies the hash partitioning for the consuming stage when
    ``shuffle_hash_exprs``/``shuffle_output_partitions`` are set."""

    def __init__(self, job_id: str, stage_id: int, child: PhysicalPlan,
                 shuffle_hash_exprs=None, shuffle_output_partitions: int = 0):
        self.job_id = job_id
        self.stage_id = stage_id
        self.child = child
        self.shuffle_hash_exprs = shuffle_hash_exprs
        self.shuffle_output_partitions = shuffle_output_partitions

    def output_schema(self) -> Schema:
        return self.child.output_schema()

    def output_partitioning(self) -> Partitioning:
        return self.child.output_partitioning()

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return QueryStageExec(self.job_id, self.stage_id, children[0],
                              self.shuffle_hash_exprs,
                              self.shuffle_output_partitions)

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        yield from self.child.execute(partition)

    def display(self) -> str:
        return f"QueryStageExec: job={self.job_id} stage={self.stage_id}"


class UnresolvedShuffleExec(PhysicalPlan):
    """Placeholder input (reference: unresolved_shuffle.rs:34-91)."""

    def __init__(self, query_stage_ids: List[int], schema: Schema,
                 partition_count: int):
        self.query_stage_ids = list(query_stage_ids)
        self._schema = schema
        self.partition_count = partition_count

    def output_schema(self) -> Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning("unknown", self.partition_count)

    def with_new_children(self, children):
        return self

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        raise ExecutionError(
            "UnresolvedShuffleExec cannot execute; the scheduler must "
            "resolve it into a ShuffleReaderExec first"
        )

    def display(self) -> str:
        return (
            f"UnresolvedShuffleExec: stages={self.query_stage_ids} "
            f"parts={self.partition_count}"
        )


class ShuffleReaderExec(PhysicalPlan):
    """Reads completed shuffle partitions (reference:
    shuffle_reader.rs:33-100).

    Three layouts:
    - merge-style stages: output partition i maps 1:1 to location i;
    - hash-shuffled stages (locations carry ``shuffle_output``): output
      partition q reads the shuffle-q file of EVERY producer partition;
    - adaptive (``read_partitions``): output partition i reads the file
      ranges the re-planner selected — coalesced spans of whole hash
      buckets and/or producer subranges of a skew-split bucket.
    """

    # tests flip this to exercise the cross-host (socket) path even when
    # producer and consumer share a filesystem
    FORCE_REMOTE = False

    def __init__(self, partition_locations: List[PartitionLocation],
                 schema: Schema, read_partitions=None,
                 hash_columns=(), original_partitions: int = 0, *,
                 device: DeviceLike):
        self.partition_locations = list(partition_locations)
        self._schema = schema
        self.device = torch.device(device)
        self._cache = {}
        # ingest read-ahead: group index -> in-flight Future loading it
        # behind the consumer (see execute()). _group_locks serialize a
        # group's load so a read-ahead racing a direct consumer never
        # fetches the same files twice; _served gates read-ahead to
        # instances that actually iterate multiple partitions (a cluster
        # task deserializes its own plan and executes exactly ONE
        # partition — read-ahead there would fetch a neighbour task's
        # group into a cache that dies with this task)
        from ..ingest import KeyedLocks

        self._inflight = {}
        self._inflight_lock = threading.Lock()
        self._group_locks = KeyedLocks()
        self._served = False
        # read_partitions: List[List[(out_lo, out_hi, prod_lo, prod_hi)]],
        # producer_hi == 0 selecting all producers (adaptive/rules.py)
        self.read_partitions = (
            [[tuple(r) for r in ranges] for ranges in read_partitions]
            if read_partitions else None
        )
        # columns the producing stage hash-partitioned on: lets the
        # in-task planner (and AQE join demotion) trust co-partitioning
        # instead of seeing Partitioning("unknown", n)
        self.hash_columns = tuple(hash_columns or ())
        self.original_partitions = original_partitions
        shuffled = [
            l for l in self.partition_locations if l.shuffle_output is not None
        ]
        if shuffled and self.read_partitions:
            self._groups = [
                [
                    l for l in shuffled
                    if any(
                        olo <= l.shuffle_output < ohi
                        and (phi == 0 or plo <= l.partition_id < phi)
                        for olo, ohi, plo, phi in ranges
                    )
                ]
                for ranges in self.read_partitions
            ]
        elif shuffled:
            n_out = max(l.shuffle_output for l in shuffled) + 1
            self._groups: List[List[PartitionLocation]] = [
                [l for l in shuffled if l.shuffle_output == q]
                for q in range(n_out)
            ]
        else:
            self._groups = [[l] for l in self.partition_locations]

    def _has_splits(self) -> bool:
        from ..adaptive.rules import layout_has_splits

        return bool(self.read_partitions) and \
            layout_has_splits(self.read_partitions)

    def output_schema(self) -> Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        n = max(len(self._groups), 1)
        # coalesced groups are unions of whole hash buckets, so the hash
        # property survives; producer-level skew splits break it
        if self.hash_columns and not self._has_splits():
            return Partitioning("hash", n, self.hash_columns)
        return Partitioning("unknown", n)

    def estimated_rows(self) -> Optional[int]:
        """EXACT row count from the producers' write-time PartitionStats
        (carried in every PartitionLocation) — consumers planning over
        shuffle input (e.g. the partitioned-join threshold) get real
        numbers, not scan-size guesses. Hash-shuffled stages fan each
        producer out into one location PER consumer partition, all
        carrying that producer's TOTAL stats, so counting distinct
        producers once is what is exact."""
        seen = {}
        # metadata walk over location stats, no per-iteration IO
        # ballista: ignore[cancel-coverage]
        for loc in self.partition_locations:
            n = (loc.stats or {}).get("num_rows")
            if n is None:
                return None
            seen[(loc.stage_id, loc.partition_id)] = int(n)
        return sum(seen.values())

    def with_new_children(self, children):
        return self

    def _load_location(self, loc: PartitionLocation):
        """Fetch+decode ONE shuffle file (local filesystem or data-plane
        socket). Runs on ingest pool workers when a group has several
        producers — the fetches overlap instead of serializing one
        network round-trip per producer. Local reads decode the
        memory-mapped stream file incrementally; remote fetches stream
        bounded chunks through the governed ChunkBuffer (disk spill past
        the budget watermark). Metric increments from worker threads
        ride the usual benign-race policy."""
        from ..io import ipc

        m = self.metrics()
        if not self.FORCE_REMOTE and loc.path and os.path.exists(loc.path):
            m.add_counter("bytes_read", os.path.getsize(loc.path))
            m.add_counter("local_reads")
            _, arrays, nulls, dicts, _ = ipc.read_partition_arrays(loc.path)
        else:
            arrays, nulls, dicts = self._fetch_with_retry(loc)
        return arrays, nulls, dicts

    def _load_group(self, q: int) -> List[ColumnBatch]:
        """Fetch only THIS output partition's files (a consumer task reads
        its own group, not the whole shuffle), producers fetched
        concurrently on the ingest pool. Per-group locking: a read-ahead
        racing the direct consumer loads once, the loser serves from the
        cache. utf8 dictionaries are unioned within the group;
        cross-group concat is handled by concat_batches' dictionary
        unification."""
        if q in self._cache:  # fast path once loaded
            return self._cache[q]
        with self._group_locks.get(q):
            if q in self._cache:
                return self._cache[q]
            import time

            from ..io import ipc
            from ..ingest import parallel_map

            t0 = time.perf_counter()
            parts = parallel_map(self._load_location, self._groups[q])
            with side_stream_uploads() if self.device.type == "cuda" \
                    else nullcontext():
                batches = ipc.batches_from_parts(self._schema, parts,
                                                 device=self.device)
            # the port's read timer: fetch, decode and upload of one group
            self.metrics().add_time("elapsed_read", time.perf_counter() - t0)
            self._cache[q] = batches
            return batches

    def _take_group(self, q: int) -> List[ColumnBatch]:
        """Serve group ``q``, joining a read-ahead future if one is in
        flight (its exceptions surface here, on the consumer). The
        cancel-or-inline rule applies: a future the pool never started
        is cancelled and loaded inline — blocking on it from a pool
        worker (readers execute on ingest producers under MergeExec)
        would deadlock an exhausted pool."""
        with self._inflight_lock:
            fut = self._inflight.pop(q, None)
        if fut is not None and not fut.cancel():
            return fut.result()
        return self._load_group(q)

    def _bg_load(self, q: int) -> List[ColumnBatch]:
        """Read-ahead body: load, then drop the inflight registration
        (an unconsumed future must not pin itself forever)."""
        try:
            return self._load_group(q)
        finally:
            with self._inflight_lock:
                self._inflight.pop(q, None)

    def _read_ahead(self, q: int) -> None:
        """Start loading group ``q`` behind the consumer (merge-style
        multi-partition readers: partition N+1 fetches while N's rows
        are being joined/aggregated). Only fires once this INSTANCE has
        demonstrably served more than one partition — a cluster task's
        single-partition reader must not fetch a neighbour task's
        group. Best-effort and bounded by the shared ingest pool."""
        from ..ingest import ingest_pool, prefetch_batches

        if (not self._served or prefetch_batches() <= 0
                or q >= len(self._groups) or q in self._cache):
            return
        with self._inflight_lock:
            if q in self._inflight:
                return
            self._inflight[q] = ingest_pool().submit(self._bg_load, q)

    def _fetch_with_retry(self, loc: PartitionLocation):
        """Streaming fetch+decode of one producer file with one quick
        retry for transient hiccups; a persistent failure (producer
        executor dead mid-stream, data lost, truncated wire or spill
        bytes, or no known address) raises a tagged ShuffleFetchError
        the scheduler can act on by re-queueing the producer partition —
        recovery works from a half-consumed stream because the attempt's
        partial buffers are released and the re-run refetches whole."""
        import time as _time

        from ..errors import QueryCancelled, ShuffleFetchError
        from ..lifecycle import check_cancel
        from ..observability import trace_span
        from ..testing.faults import fault_point

        if not loc.host or not loc.port:
            raise ShuffleFetchError(
                loc.stage_id, [loc.partition_id], loc.executor_id,
                "producer executor address unknown (lease expired?)",
            )
        last = None
        for attempt in range(2):
            # a cancelled task must stop fetching, not ride out retries
            check_cancel()
            try:
                # 10s covers connect and each recv (not the whole
                # transfer); a dead-but-backlogged peer fails fast
                with trace_span("shuffle.fetch", host=loc.host,
                                stage=loc.stage_id,
                                partition=loc.partition_id,
                                attempt=attempt):
                    # per-attempt: an injected failure is retried like a
                    # real transport hiccup, then surfaces as the tagged
                    # ShuffleFetchError the scheduler re-queues on
                    fault_point("shuffle.fetch", stage=loc.stage_id,
                                partition=loc.partition_id,
                                attempt=attempt)
                    return self._fetch_stream_once(loc, attempt)
            except QueryCancelled:
                raise  # chunk-level cancel is terminal, never retried
            except Exception as e:  # noqa: BLE001 - any transport failure
                last = e
                if attempt == 0:
                    _time.sleep(1.0)
        raise ShuffleFetchError(
            loc.stage_id, [loc.partition_id], loc.executor_id,
            f"{type(last).__name__}: {last}",
        )

    def _fetch_stream_once(self, loc: PartitionLocation, attempt: int):
        """One streaming fetch attempt: wire chunks land in a governed
        ChunkBuffer (RAM within the budget, size-rotated spill files
        past the watermark — never a blocking wait), then decode replays
        them incrementally. The cancel token is checked at EVERY chunk
        boundary on both the receive and decode loops, so
        ``ctx.cancel()``/deadlines abort in-flight transfers within one
        chunk."""
        from ..distributed.dataplane import fetch_partition_chunks
        from ..distributed.spill import ChunkBuffer
        from ..io import ipc
        from ..lifecycle import check_cancel
        from ..testing.faults import fault_point

        m = self.metrics()
        buf = ChunkBuffer()
        try:
            for chunk in fetch_partition_chunks(
                    loc.host, loc.port, loc.job_id, loc.stage_id,
                    loc.partition_id, shuffle_output=loc.shuffle_output,
                    timeout=10.0):
                check_cancel()
                fault_point("shuffle.stream.chunk", stage=loc.stage_id,
                            partition=loc.partition_id, attempt=attempt)
                buf.put(chunk)
            _, arrays, nulls, dicts, _ = \
                ipc.read_partition_arrays_from_chunks(buf.chunks())
        finally:
            buf.close()
        m.add_counter("bytes_read", buf.total_bytes)
        m.add_counter("remote_fetches")
        if buf.spilled_bytes:
            m.add_counter("spilled_bytes", buf.spilled_bytes)
        return arrays, nulls, dicts

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        batches = self._take_group(partition)
        self._read_ahead(partition + 1)
        self._served = True
        for b in batches:
            yield b.wait_upload()

    def release(self) -> None:
        """Drop the loaded groups (a repeated collect reads again)."""
        self._cache = {}

    def display(self) -> str:
        out = f"ShuffleReaderExec: {len(self.partition_locations)} partitions"
        if self.read_partitions:
            from ..adaptive.rules import describe_layout

            n_before = self.original_partitions or len(self.read_partitions)
            out += f" [adaptive: {describe_layout(n_before, self.read_partitions)}]"
        return out
