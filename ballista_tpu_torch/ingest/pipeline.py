"""The pipeline engine: shared bounded pool + prefetch handles.

The port of the JAX package's ``ingest/pipeline.py``. One addition: a
handle binds its creator's cancel token (``lifecycle``) on the producer
thread, so a cancelled query's producers stop at their next chunk
instead of parsing on until the collect's ``cancel_plan``.

Deadlock-freedom invariant: nothing that runs ON a pool worker ever
*blocks* on a pool task that hasn't started. Both primitives here keep
it by construction —

- :class:`PrefetchHandle` consumers that are THEMSELVES pool workers
  try ``Future.cancel()`` immediately; other consumers poll the queue
  and retry the cancel whenever it stays empty — either way a
  producer the pool genuinely never started is taken inline instead
  of waited on (see ``__iter__`` for why both halves matter);
- :func:`parallel_map` runs the first item on the caller and, for each
  submitted future, cancels-and-runs-inline anything the pool hasn't
  started before waiting on it.

So an exhausted pool degrades to serial execution, never to a hang.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent import futures
from typing import Callable, Dict, Iterable, List, Optional

from .. import lifecycle
from ..observability import tracing
from ..observability.tracing import trace_event, trace_span
from . import phases
from .config import ingest_threads, prefetch_batches

_pool_lock = threading.Lock()
_pool: Optional[futures.ThreadPoolExecutor] = None


def ingest_pool() -> futures.ThreadPoolExecutor:
    """The process-wide bounded ingest pool (``BALLISTA_INGEST_THREADS``
    workers). Shared by scan priming and partition production, so total
    ingest concurrency has ONE bound."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = futures.ThreadPoolExecutor(
                max_workers=ingest_threads(),
                thread_name_prefix="ballista-ingest",
            )
        return _pool


def _reset_pool() -> None:
    global _pool
    with _pool_lock:
        p, _pool = _pool, None
    if p is not None:
        p.shutdown(wait=False)


def pool_queue_depth() -> int:
    """Work items queued on the ingest pool but not yet started — the
    pool's backpressure gauge. 0 when the pool was never created (no
    ingest ran yet)."""
    with _pool_lock:
        p = _pool
    if p is None:
        return 0
    try:
        return p._work_queue.qsize()
    except Exception:  # noqa: BLE001 - executor internals drifted
        return 0


class KeyedLocks:
    """One lazily-created lock per key behind a single guard — the
    double-checked per-key materialization pattern shared by
    CacheSource keys and JoinExec build sides: take ``get(key)``,
    re-check the cache inside it, compute
    once. Locks persist for the owner's lifetime (bounded by its key
    space), so invalidating a cache must NOT drop them — a builder
    mid-flight still holds one."""

    __slots__ = ("_guard", "_locks")

    def __init__(self):
        self._guard = threading.Lock()
        self._locks: Dict = {}

    def get(self, key) -> threading.Lock:
        with self._guard:
            return self._locks.setdefault(key, threading.Lock())


def _on_ingest_pool() -> bool:
    """True when the calling thread is an ingest pool worker (they are
    name-prefixed) — the only context where blocking on a not-yet-
    started pool task could deadlock."""
    return threading.current_thread().name.startswith("ballista-ingest")


# sentinels carried through the queue alongside batches
_DONE = object()
_ERROR = object()


class PrefetchHandle:
    """One scan's bounded producer/consumer pipe.

    A pool worker drives the batch generator — parse AND the H2D issue
    happen on the producer thread (``ColumnBatch.from_numpy`` uploads
    as it builds; a scan's producer uploads on its own stream, see
    ``ScanExec.prime``), so by the time the consumer takes a batch its
    transfer is already in flight — pushing into a queue of at most
    ``depth`` batches (the memory bound: at most ``depth`` parsed
    batches exist ahead of the consumer, double-buffered by default).

    Lifecycle: iterate to drain; ``cancel()`` stops the producer and
    empties the queue (safe at any point — consumers abandoning the
    stream early, e.g. under LimitExec, cancel from their ``finally``).
    Producer exceptions re-raise at the consumer, preserving serial
    error semantics."""

    __slots__ = ("_factory", "_depth", "_q", "_closed", "_future",
                 "_recorder", "_flow", "_token", "label", "max_occupancy")

    def __init__(self, factory: Callable[[], Iterable], depth: int,
                 label: str = "", recorder=None, pool=None):
        self._factory = factory
        self._depth = max(int(depth), 1)
        self._q: queue.Queue = queue.Queue(self._depth)
        self._closed = threading.Event()
        self._recorder = recorder
        # flow correlation: capture the creator thread's job/stage/task
        # attrs so producer spans on the pool worker stay attributable
        # to the query that primed them
        self._flow = tracing.current_flow()
        # the creator's cancel token: a cancelled query's producer stops
        # at its next check_cancel (scan chunk) with QueryCancelled
        self._token = lifecycle.current_token()
        self.label = label
        # high-water mark of batches simultaneously queued (tests pin
        # it against the configured depth)
        self.max_occupancy = 0
        self._future = (pool or ingest_pool()).submit(self._produce)

    # -- producer (pool worker) ---------------------------------------------

    def _produce(self) -> None:
        with tracing.flow(**self._flow), \
                lifecycle.bind_token(self._token), \
                trace_span("ingest.prefetch", label=self.label):
            try:
                with phases.bind(self._recorder):
                    for batch in self._factory():
                        if not self._put((batch, None)):
                            return  # cancelled while blocked on a full queue
            except BaseException as e:  # noqa: BLE001 - re-raised at consumer
                self._put((_ERROR, e))
                return
        self._put((_DONE, None))

    def _put(self, item) -> bool:
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.05)
            except queue.Full:
                continue
            if item[0] is not _DONE and item[0] is not _ERROR:
                self.max_occupancy = max(self.max_occupancy,
                                         self._q.qsize())
            return True
        return False

    # -- consumer -----------------------------------------------------------

    def __iter__(self):
        # Pool-worker consumers cancel-or-inline IMMEDIATELY: blocking
        # there on a not-yet-started task can deadlock an exhausted
        # pool. Other consumers must NOT insta-cancel — one that
        # iterates right after priming would always win the race
        # against worker startup and degrade every scan to a serial
        # pull — but they can't block unboundedly either: primed
        # producers can outnumber workers, and a worker whose queue is
        # full holds its slot until ITS consumer arrives, which may be
        # behind THIS get. So: poll, and if the producer still hasn't
        # started, take the scan inline (cancel() succeeding proves
        # nothing was produced, so nothing can be duplicated).
        rec = self._recorder
        if _on_ingest_pool() and self._future.cancel():
            yield from phases.bound_iter(iter(self._factory()), rec)
            return
        waited = 0.0
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    kind, err = self._q.get(timeout=0.05)
                except queue.Empty:
                    waited += time.perf_counter() - t0
                    if self._future.cancel():
                        yield from phases.bound_iter(
                            iter(self._factory()), rec)
                        return
                    if self._future.done() and self._q.empty():
                        # producer exited without a sentinel: only
                        # possible after an external cancel() — end the
                        # stream rather than poll forever
                        return
                    continue
                waited += time.perf_counter() - t0
                if kind is _DONE:
                    return
                if kind is _ERROR:
                    raise err
                if rec is not None:
                    rec.count_prefetched()
                yield kind
        finally:
            if rec is not None:
                rec.add_wait(waited)
            self.cancel()

    def cancel(self) -> None:
        """Stop the producer (idempotent) and drop queued batches."""
        self._closed.set()
        self._future.cancel()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def parallel_map(fn: Callable, items: Iterable) -> List:
    """``[fn(x) for x in items]`` fanned across the ingest pool,
    order-preserving and deadlock-free (see module docstring). Serial
    when the pool is width-1 or the pipeline is gated off."""
    items = list(items)
    if len(items) <= 1 or ingest_threads() <= 1 or prefetch_batches() <= 0:
        return [fn(x) for x in items]
    pool = ingest_pool()
    pending = [(x, pool.submit(fn, x)) for x in items[1:]]
    done = 0
    try:
        out = [fn(items[0])]
        for x, fut in pending:
            out.append(fn(x) if fut.cancel() else fut.result())
            done += 1
        return out
    finally:
        # an item that raised must not leave the rest running unobserved
        # on the shared pool (fetches burning network after the query
        # already failed); running futures finish, pending ones cancel
        for _, fut in pending[done:]:
            fut.cancel()


def iter_partitions(plan, partitions) -> "Iterable":
    """Yield ``plan.execute(p)``'s batches for each partition IN ORDER,
    with the partitions produced concurrently on the ingest pool — the
    pipelined replacement for the serial multi-partition pull loop (the
    collect, ``MergeExec``, a repartition's input, a merged join's
    build). Each partition subtree runs whole on its producer thread
    (scan, joins, partial aggregation), buffered behind the usual
    bounded queue. Yield order is partition order then batch order,
    identical to the serial loop — byte-identical results.

    Requires the consumed operators to tolerate concurrent partition
    execution: the two instance-level materializations shared ACROSS
    partitions — JoinExec's build, RepartitionExec's parts — take per-
    instance locks, and the governor serializes captures of CUDA
    graphs (``compile/governor.py``)."""
    from ..lifecycle import check_cancel

    parts = list(partitions)
    if prefetch_batches() <= 0 or ingest_threads() <= 1 or len(parts) <= 1:
        for p in parts:
            for batch in plan.execute(p):
                # cooperative cancellation at the batch boundary (the
                # consumer thread carries the token; producers are
                # unparked by cancel_plan once this raises)
                check_cancel()
                yield batch
        return
    # STAGGERED: partition 0 runs inline first, so every governed
    # program in the subtree is warmed up and captured once on this
    # thread; the remaining partitions then overlap with the programs
    # warm, where their calls are replays.
    for batch in plan.execute(parts[0]):
        check_cancel()
        yield batch
    handles = [
        PrefetchHandle(lambda p=p: plan.execute(p), prefetch_batches(),
                       label=f"partition[{p}]")
        for p in parts[1:]
    ]
    try:
        for h in handles:
            for batch in h:
                check_cancel()
                yield batch
    finally:
        for h in handles:
            h.cancel()


# -- plan-level priming -------------------------------------------------------


def _iter_scans(phys):
    from ..physical.operators import ScanExec

    stack = [phys]
    while stack:
        node = stack.pop()
        if isinstance(node, ScanExec):
            yield node
        stack.extend(node.children())


def prime_plan(phys, partitions: Optional[List[int]] = None) -> int:
    """Start background parse+H2D for every leaf scan of ``phys`` (all
    partitions, or just ``partitions``) — the cross-table overlap axis.
    Memory-resident sources are skipped (nothing to overlap). Handles
    ride on the ScanExec instances; :func:`cancel_plan` cleanly drops
    whatever an early exit left unconsumed."""
    if prefetch_batches() <= 0:
        return 0
    from ..io.memory import MemTableSource
    from ..lifecycle import check_cancel

    n = 0
    for scan in _iter_scans(phys):
        if isinstance(scan.source, MemTableSource):
            continue
        nparts = scan.source.num_partitions()
        parts = range(nparts) if partitions is None else [
            p for p in partitions if 0 <= p < nparts
        ]
        for p in parts:
            # an already-cancelled query must not fan out N prefetches
            check_cancel()
            if scan.prime(p) is not None:
                n += 1
    if n:
        trace_event("ingest.prime", handles=n)
    return n


def cancel_plan(phys) -> None:
    """Cancel every unconsumed primed handle under ``phys`` (no-op for
    fully drained plans — consumed handles self-cancel)."""
    for scan in _iter_scans(phys):
        scan.cancel_primed()
