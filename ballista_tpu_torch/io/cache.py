"""Caching table source: materialize scanned batches once, serve them
from memory afterwards (the Spark ``.cache()`` analogue). The port of
the JAX package's ``io/cache.py``."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..cache.residency import batch_device_bytes
from ..datatypes import Schema
from ..ingest import KeyedLocks
from ..logical import TableSource
from ..observability import memory as obs_memory


class CacheSource(TableSource):
    """Thread-safe: parallel ingest (and self-joins) scan the same
    (partition, projection) key concurrently, so materialization takes a
    PER-KEY lock — exactly one inner scan runs, late arrivals wait for
    it and serve from the cache (an unlocked dict would materialize the
    inner scan once per racer and interleave the insert)."""

    def __init__(self, inner: TableSource):
        self.inner = inner
        self._cache: Dict[Tuple[int, Optional[Tuple[str, ...]]], List] = {}
        self._key_locks = KeyedLocks()
        # cache occupancy (observability/memory): guarded by its own
        # lock — concurrent materializations of DIFFERENT keys hold
        # different per-key locks, so an unguarded += could lose an
        # update and leave bytes leaked after invalidate()
        self._size_lock = threading.Lock()
        self._tracked_bytes = 0

    def table_schema(self) -> Schema:
        return self.inner.table_schema()

    def num_partitions(self) -> int:
        return self.inner.num_partitions()

    def content_signature(self):
        """Result-cache identity is the INNER data's identity — this
        wrapper adds replay, not different rows."""
        return self.inner.content_signature()

    def estimated_rows(self):
        return self.inner.estimated_rows()

    def is_materialized(self, partition: int,
                        projection: Optional[Sequence[str]] = None) -> bool:
        """True when this (partition, projection) is already served from
        memory — the ingest pipeline then skips its prefetch queue (no
        parse/H2D left to overlap; keeps the warm path overhead-free)."""
        key = (partition, tuple(projection) if projection is not None else None)
        return key in self._cache

    def scan(self, partition: int, projection: Optional[Sequence[str]] = None):
        key = (partition, tuple(projection) if projection is not None else None)
        if key not in self._cache:  # fast path: no lock once populated
            with self._key_locks.get(key):
                if key not in self._cache:
                    batches = list(self.inner.scan(partition, projection))
                    # replayed every query: a transient mark from the
                    # inner scan would let the first consumer donate
                    # batches later replays still serve
                    for b in batches:
                        b._transient = False
                    n = sum(batch_device_bytes(b) for b in batches)
                    obs_memory.record_host_bytes("cache", n)
                    with self._size_lock:
                        self._tracked_bytes += n
                    self._cache[key] = batches
        yield from self._cache[key]

    def invalidate(self):
        # locks are NOT dropped: a materialization mid-flight still
        # holds one, and dropping it would let a post-invalidate scan
        # run a second concurrent inner scan against it
        self._cache.clear()
        self._release_tracked()

    def _release_tracked(self):
        with self._size_lock:
            n, self._tracked_bytes = self._tracked_bytes, 0
        obs_memory.release_host_bytes("cache", n)

    def __del__(self):
        # a CacheSource dropped without invalidate() must not leak its
        # bytes in the accounting gauges
        try:
            self._release_tracked()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
