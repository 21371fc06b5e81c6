"""Device-resident table cache: pin hot scan outputs across queries.

The port of the JAX package's ``cache/residency.py``, tier (a) of the
warm-path cache subsystem. A scan's expensive work is parse (file ->
host arrays) and H2D (host -> device upload); its OUTPUT — post-parse,
post-upload, bucketed-capacity ``ColumnBatch`` lists — is keyed
entirely by on-disk content. This module keeps those outputs resident
on the device so a warm repeat scan is a dictionary lookup instead of a
re-ingest.

Torch tensors are mutable where JAX arrays are not: a pinned batch is
shared by every later query, so nothing in the engine may write into a
tensor it did not allocate (the tests hold each pinned tensor's
``_version`` and checksum across queries), and pinned batches are never
donated.

Invalidation is by construction: every key embeds the partition file's
``(basename, size, mtime_ns)`` signature taken AT LOOKUP TIME (and the
text sources add every file of the table, see ``io/text.py``). A
rewritten or appended file mints a different key; the stale entry
simply stops being reachable and ages out of the LRU.

Memory is governed by :class:`DeviceMemoryGovernor`, one budget per
device: charge on insert, refuse past the watermark, evict the same
device's coldest entries first — NEVER block.
A refused fill degrades to the plain streaming scan (the batches are
yielded either way); eviction under pressure degrades a later query to
re-ingest, never fails it.

Fill protocol (:meth:`DeviceTableCache.begin_fill`): scan sources add
batches as they are emitted and ``commit()`` only after the partition
completed — a partial entry (abandoned generator, mid-scan cancel,
budget refusal) is aborted and released, because serving a truncated
partition would be a correctness bug, not a cache miss.

Knobs (read at call time): ``BALLISTA_TABLE_CACHE`` (default on),
``BALLISTA_TABLE_CACHE_BUDGET_MB`` (default 512, per device),
``BALLISTA_TABLE_CACHE_WATERMARK`` (default 0.9).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Iterable, List, Optional

_OFF = ("off", "0", "false", "no")


def table_cache_enabled() -> bool:
    """``BALLISTA_TABLE_CACHE``: keep scan outputs device-resident
    across queries and sessions (default on)."""
    return os.environ.get("BALLISTA_TABLE_CACHE", "on").lower() not in _OFF


def table_cache_budget_bytes() -> int:
    """``BALLISTA_TABLE_CACHE_BUDGET_MB``: byte budget for pinned scan
    outputs on each device (default 512 MiB)."""
    try:
        mb = int(os.environ.get("BALLISTA_TABLE_CACHE_BUDGET_MB", "")
                 or 512)
    except ValueError:
        mb = 512
    return max(mb, 1) << 20


def table_cache_watermark() -> float:
    """``BALLISTA_TABLE_CACHE_WATERMARK``: fraction of the budget past
    which inserts refuse/evict (default 0.9)."""
    try:
        v = float(os.environ.get("BALLISTA_TABLE_CACHE_WATERMARK", "")
                  or 0.9)
    except ValueError:
        return 0.9
    return min(max(v, 0.01), 1.0)


def file_signature(path: str) -> tuple:
    """(basename, size, mtime_ns) of one partition file, taken NOW —
    the invalidation signal. Unstatable paths get a per-call unique
    token so they can never alias a cached entry."""
    try:
        return (os.path.basename(path), os.path.getsize(path),
                os.stat(path).st_mtime_ns)
    except OSError:
        return (path, -1, time.monotonic_ns())


def scan_key(kind: str, path: str, partition: int,
             projection, extra: tuple = ()) -> tuple:
    """Cache key for one (source file, partition, projection, format)
    scan. The file signature is re-stat'd per call, so file changes
    invalidate by construction."""
    proj = tuple(projection) if projection is not None else None
    return (kind, os.path.abspath(path), file_signature(path),
            int(partition), proj) + tuple(extra)


def batch_tensors(batch) -> list:
    """Every tensor a batch holds: column values and validity masks,
    the selection and the row count."""
    out = []
    for c in batch.columns:
        out.append(c.values)
        if c.validity is not None:
            out.append(c.validity)
    out.append(batch.selection)
    out.append(batch.num_rows)
    return out


def batch_device_bytes(batch) -> int:
    """Device bytes a batch pins (all its tensors)."""
    return int(sum(t.numel() * t.element_size()
                   for t in batch_tensors(batch)))


class DeviceMemoryGovernor:
    """Accountant for the bytes the table cache pins, one budget per
    device: the JAX package's process has one device, so its budget is
    that device's; the port's process may hold card and CPU contexts,
    and filling one must not evict the other's entries. Charge/release
    pairs are locked (a lost update leaks budget forever);
    budget/watermark read the environment at call time so one instance
    serves any knob configuration. ``try_charge`` NEVER blocks: a
    refusal means the caller skips pinning (or evicts and retries).
    ``resident_bytes``, ``peak_resident_bytes`` and ``denials`` are the
    process totals; ``stats()["per_device"]`` breaks them down."""

    def __init__(self):
        self._lock = threading.Lock()
        self._resident: dict = {}
        self._peak: dict = {}
        self._denials: dict = {}
        self.peak_resident_bytes = 0

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(self._resident.values())

    @property
    def denials(self) -> int:
        with self._lock:
            return sum(self._denials.values())

    def try_charge(self, nbytes: int, dev: str) -> bool:
        """Charge ``nbytes`` to device ``dev`` (``str`` of a torch
        device), or refuse past its watermark."""
        n = int(nbytes)
        if n <= 0:
            return True
        limit = int(table_cache_budget_bytes() * table_cache_watermark())
        with self._lock:
            held = self._resident.get(dev, 0)
            if held + n > limit:
                self._denials[dev] = self._denials.get(dev, 0) + 1
                return False
            self._resident[dev] = held + n
            self._peak[dev] = max(self._peak.get(dev, 0), held + n)
            self.peak_resident_bytes = max(self.peak_resident_bytes,
                                           sum(self._resident.values()))
        return True

    def release(self, nbytes: int, dev: str) -> None:
        n = int(nbytes)
        if n <= 0:
            return
        with self._lock:
            self._resident[dev] = max(0, self._resident.get(dev, 0) - n)

    def stats(self) -> dict:
        with self._lock:
            devs = sorted(set(self._resident) | set(self._peak)
                          | set(self._denials))
            return {
                "resident_bytes": sum(self._resident.values()),
                "peak_resident_bytes": self.peak_resident_bytes,
                "denials": sum(self._denials.values()),
                "budget_bytes": table_cache_budget_bytes(),
                "per_device": {d: {
                    "resident_bytes": self._resident.get(d, 0),
                    "peak_resident_bytes": self._peak.get(d, 0),
                    "denials": self._denials.get(d, 0),
                } for d in devs},
            }

    def reset_stats(self) -> None:
        """Re-baseline the peaks (bench phases, tests); resident bytes
        are live accounting and are NOT reset."""
        with self._lock:
            self._peak = dict(self._resident)
            self.peak_resident_bytes = sum(self._resident.values())
            self._denials = {}


class _Entry:
    __slots__ = ("batches", "nbytes", "device", "hits", "filled_at",
                 "last_access")

    def __init__(self, batches: List, nbytes: int, device: str):
        self.batches = batches
        self.nbytes = nbytes
        self.device = device
        self.hits = 0
        self.filled_at = time.time()
        self.last_access = self.filled_at


class _Filler:
    """One in-progress fill: charges the governor per added batch and
    publishes the entry only on ``commit()`` after every batch landed.
    ``add`` returning False means the budget refused even after
    evicting everything colder — the fill is dead, remaining batches
    stay un-pinned (and donation-eligible)."""

    def __init__(self, cache: "DeviceTableCache", key: tuple):
        self._cache = cache
        self._key = key
        self._batches: List = []
        self._charged = 0
        self._device = None  # str of the first batch's device
        self._dead = False
        self._done = False

    def add(self, batch) -> bool:
        if self._dead:
            return False
        n = batch_device_bytes(batch)
        if self._device is None:
            self._device = str(batch.device)
        if not self._cache._charge_evicting(n, self._device):
            self.abort()
            return False
        self._charged += n
        self._batches.append(batch)
        return True

    def commit(self) -> bool:
        """Publish the complete entry; False when the fill died or was
        already finalized."""
        if self._dead or self._done:
            return False
        self._done = True
        return self._cache._publish(self._key, self._batches, self._charged,
                                    self._device)

    def abort(self) -> None:
        """Release whatever was charged; the entry is never published.
        Idempotent — safe from a generator's ``finally``."""
        if self._done or self._dead:
            return
        self._dead = True
        self._cache._gov.release(self._charged, self._device)
        self._batches = []
        self._charged = 0


class DeviceTableCache:
    """LRU map of scan keys -> pinned batch lists, bounded by the
    device memory governor. Lookups are O(1) under one lock; entries
    are whole partitions (all batches or nothing)."""

    def __init__(self, governor: Optional[DeviceMemoryGovernor] = None):
        self._gov = governor or DeviceMemoryGovernor()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.evictions = 0
        self.refusals = 0

    @property
    def governor(self) -> DeviceMemoryGovernor:
        return self._gov

    def lookup(self, key: Optional[tuple]) -> Optional[List]:
        """The pinned batch list for ``key``, or None. A hit refreshes
        LRU order; the returned list is a copy (callers iterate and
        may drop it mid-stream)."""
        if key is None or not table_cache_enabled():
            return None
        from ..observability import trace_span

        # spanned so a trace sees every probe, hit or miss
        with trace_span("cache.lookup", tier="table"):
            with self._lock:
                e = self._entries.get(key)
                if e is None:
                    self.misses += 1
                    return None
                self._entries.move_to_end(key)
                e.hits += 1
                e.last_access = time.time()
                self.hits += 1
                return list(e.batches)

    def pinned_batches(self, device=None) -> List:
        """Every batch the cache pins now (on ``device`` only, when
        given), coldest entry first."""
        with self._lock:
            batches = [b for e in self._entries.values() for b in e.batches]
        if device is None:
            return batches
        return [b for b in batches if b.device == device]

    def contains(self, key: Optional[tuple]) -> bool:
        """Membership probe WITHOUT touching hit/miss counters or LRU
        order (prefetch-routing decisions, tests)."""
        if key is None or not table_cache_enabled():
            return False
        with self._lock:
            return key in self._entries

    def begin_fill(self, key: Optional[tuple]) -> Optional[_Filler]:
        """A filler for ``key``, or None when the tier is off, the key
        is uncacheable, or the entry already exists."""
        if key is None or not table_cache_enabled():
            return None
        with self._lock:
            if key in self._entries:
                return None
        return _Filler(self, key)

    def _charge_evicting(self, nbytes: int, device: str) -> bool:
        """Charge ``device``'s budget, evicting that device's coldest
        entries while the governor refuses. Returns False once the
        device has nothing left to evict. Never blocks."""
        while not self._gov.try_charge(nbytes, device):
            with self._lock:
                victim = next((k for k, e in self._entries.items()
                               if e.device == device), None)
                if victim is None:
                    self.refusals += 1
                    return False
                e = self._entries.pop(victim)
                self.evictions += 1
            self._gov.release(e.nbytes, device)
        return True

    def _publish(self, key: tuple, batches: List, nbytes: int,
                 device: str) -> bool:
        with self._lock:
            if key in self._entries:
                # a concurrent scan won the fill race: keep theirs
                dup = True
            else:
                self._entries[key] = _Entry(batches, nbytes, device)
                self.fills += 1
                dup = False
        if dup:
            self._gov.release(nbytes, device)
        return not dup

    def invalidate(self, key: Optional[tuple] = None) -> None:
        """Drop one entry (or everything) and release its budget.
        File-change invalidation needs no call here — changed files
        mint different keys — this is for explicit resets (tests, runs
        that start from an empty cache)."""
        with self._lock:
            if key is not None:
                dropped = [self._entries.pop(key)] \
                    if key in self._entries else []
            else:
                dropped = list(self._entries.values())
                self._entries.clear()
        for e in dropped:
            self._gov.release(e.nbytes, e.device)

    def stats(self) -> dict:
        with self._lock:
            out = {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "fills": self.fills,
                "evictions": self.evictions,
                "refusals": self.refusals,
            }
        out.update(self._gov.stats())
        out["enabled"] = table_cache_enabled()
        return out

    def reset_stats(self) -> None:
        with self._lock:
            self.hits = self.misses = self.fills = 0
            self.evictions = self.refusals = 0
        self._gov.reset_stats()


_cache_lock = threading.Lock()
_cache: Optional[DeviceTableCache] = None


def process_table_cache() -> DeviceTableCache:
    """The process-wide device table cache (shared by every source and
    session; keys name the device, so a CPU and a card context never
    share an entry)."""
    global _cache
    with _cache_lock:
        if _cache is None:
            _cache = DeviceTableCache()
        return _cache


def _reset_for_tests() -> None:
    global _cache
    with _cache_lock:
        c, _cache = _cache, None
    if c is not None:
        c.invalidate()


def serve_or_fill(key: Optional[tuple], produce, outcome_sink=None
                  ) -> Iterable:
    """The ONE scan-side integration point: yield cached batches on a
    hit, else stream ``produce()`` through a fill attempt. Batches that
    end up pinned are NOT donation-eligible; refused/unpinned ones are
    marked transient. ``outcome_sink(outcome)`` (optional) receives
    ``"hit" | "filled" | "miss"`` for the scan's metrics annotation."""
    from .donation import mark_transient

    cache = process_table_cache()
    cached = cache.lookup(key)
    if cached is not None:
        if outcome_sink is not None:
            outcome_sink("hit")
        for batch in cached:
            yield batch
        return
    filler = cache.begin_fill(key)
    committed = False
    try:
        for batch in produce():
            if filler is not None and filler.add(batch):
                pass  # pinned: never donation-eligible
            else:
                mark_transient(batch)
            yield batch
        if filler is not None:
            committed = filler.commit()
    finally:
        if filler is not None and not committed:
            # abandoned mid-stream (limit, cancel) or budget-refused:
            # a partial entry must never be served
            filler.abort()
    if outcome_sink is not None:
        outcome_sink("filled" if committed else "miss")
