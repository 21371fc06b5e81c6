"""Plan-fingerprint result cache: repeated queries skip execution.

The port of the JAX package's ``cache/results.py``, tier (c) of the
warm-path cache subsystem. A standalone collect whose physical plan,
input data, device and semantics-affecting settings all match a
previous run returns that run's result without executing anything.

The key is the ONE invalidation signal, composed:

- the ``compile_signature()`` of EVERY node of the fused physical plan,
  in tree order with each node's number of children — operators,
  expressions, schemas and capacities. (The JAX package keys on the
  root's signature alone, which holds the root's own expressions and
  its input schema but not the operators below it: two plans that
  differ only below the root would share a key there.)
- per-leaf ``content_signature()`` of every scan source, re-stat'd at
  lookup time (file sizes + mtimes) — a rewritten or appended file
  misses by construction;
- the context settings, minus identity-only keys (``session.id``), and
  the context's device — conservatively EVERYTHING else is treated as
  semantics-affecting, so a knob flip can fragment the cache but never
  serve a wrong result.

A plan with any un-signable leaf (memtables, raw sources without
``content_signature``) is uncacheable: ``plan_key`` returns None and the
collect executes normally.

Results are stored as HOST dicts of numpy arrays (the port has no
pandas), accounted under the ``cache`` host-memory category,
LRU-bounded by ``BALLISTA_RESULT_CACHE_BUDGET_MB``. Both fill and hit
copy the columns — a caller mutating its result must never corrupt the
cache, and vice versa.

Opt-in: ``BALLISTA_RESULT_CACHE`` defaults OFF (result reuse changes
observable execution side effects like metrics). The
``result_cache.enabled`` context setting overrides the environment per
session.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import List, Optional

import numpy as np

from ..observability.memory import record_host_bytes, release_host_bytes

_OFF = ("off", "0", "false", "no")
_ON = ("on", "1", "true", "yes")


def result_cache_enabled(settings: Optional[dict] = None) -> bool:
    """``BALLISTA_RESULT_CACHE`` (default off; opt-in), overridable per
    context via the ``result_cache.enabled`` setting."""
    if settings is not None:
        v = str(settings.get("result_cache.enabled", "")).lower()
        if v in _ON:
            return True
        if v in _OFF and v:
            return False
    return os.environ.get("BALLISTA_RESULT_CACHE", "off").lower() in _ON


def result_cache_budget_bytes() -> int:
    """``BALLISTA_RESULT_CACHE_BUDGET_MB``: host-byte budget for cached
    result sets (default 64 MiB)."""
    try:
        mb = int(os.environ.get("BALLISTA_RESULT_CACHE_BUDGET_MB", "")
                 or 64)
    except ValueError:
        mb = 64
    return max(mb, 1) << 20


# identity-only settings that never affect results
_IDENTITY_SETTINGS = ("session.id",)


def plan_key(phys, settings: Optional[dict] = None,
             device=None) -> Optional[tuple]:
    """Cache key for a planned (post-fusion) physical tree on ``device``
    (a card's float sums may differ from the CPU's in the last digits),
    or None when any leaf cannot sign its content."""
    leaf_sigs: List[tuple] = []
    node_sigs: List[tuple] = []

    def walk(node) -> bool:
        kids = node.children()
        node_sigs.append((node.compile_signature(), len(kids)))
        if kids:
            return all(walk(c) for c in kids)
        src = getattr(node, "source", None)
        sig_fn = getattr(src, "content_signature", None)
        if sig_fn is None:
            return False
        try:
            sig = sig_fn()
        except OSError:  # a file vanished: unsignable, uncacheable
            return False
        if sig is None:
            return False
        leaf_sigs.append(sig)
        return True

    if not walk(phys):
        return None
    plan_sig = tuple(node_sigs)
    try:
        hash(plan_sig)
    except TypeError:  # a signature part without a value hash
        return None
    setting_items = tuple(sorted(
        (str(k), str(v)) for k, v in (settings or {}).items()
        if k not in _IDENTITY_SETTINGS))
    return (plan_sig, tuple(leaf_sigs), setting_items, str(device))


def _copy_pydict(data: dict) -> dict:
    out = {}
    for k, v in data.items():
        if isinstance(v, np.ndarray):
            out[k] = v.copy()
        else:
            out[k] = list(v)
    return out


def _pydict_nbytes(data: dict) -> int:
    total = 0
    for v in data.values():
        if isinstance(v, np.ndarray):
            total += int(v.nbytes)
        else:
            total += 64 * len(v)  # object rows: rough per-cell charge
    return total


class _Entry:
    __slots__ = ("data", "nbytes", "hits", "filled_at", "last_access")

    def __init__(self, data: dict, nbytes: int):
        self.data = data
        self.nbytes = nbytes
        self.hits = 0
        self.filled_at = time.time()
        self.last_access = self.filled_at


class ResultCache:
    """LRU plan-fingerprint -> host result store, byte-bounded."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.evictions = 0

    def lookup(self, key: Optional[tuple]) -> Optional[dict]:
        if key is None:
            return None
        from ..observability import trace_span

        # spanned so a trace sees every probe, hit or miss
        with trace_span("cache.lookup", tier="result"):
            with self._lock:
                e = self._entries.get(key)
                if e is None:
                    self.misses += 1
                    return None
                self._entries.move_to_end(key)
                e.hits += 1
                e.last_access = time.time()
                self.hits += 1
                data = e.data
            return _copy_pydict(data)

    def fill(self, key: Optional[tuple], data: dict) -> bool:
        if key is None:
            return False
        stored = _copy_pydict(data)
        n = _pydict_nbytes(stored)
        budget = result_cache_budget_bytes()
        if n > budget:
            return False  # one oversized result must not flush the LRU
        dropped: List[_Entry] = []
        with self._lock:
            if key in self._entries:
                return False  # concurrent identical query won the fill
            while self._bytes + n > budget and self._entries:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                self.evictions += 1
                dropped.append(old)
            self._entries[key] = _Entry(stored, n)
            self._bytes += n
            self.fills += 1
        for old in dropped:
            release_host_bytes("cache", old.nbytes)
        record_host_bytes("cache", n)
        return True

    def invalidate(self) -> None:
        with self._lock:
            dropped = list(self._entries.values())
            self._entries.clear()
            self._bytes = 0
        for e in dropped:
            release_host_bytes("cache", e.nbytes)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "fills": self.fills,
                "evictions": self.evictions,
                "budget_bytes": result_cache_budget_bytes(),
            }

    def reset_stats(self) -> None:
        with self._lock:
            self.hits = self.misses = self.fills = self.evictions = 0


_cache_lock = threading.Lock()
_cache: Optional[ResultCache] = None


def process_result_cache() -> ResultCache:
    global _cache
    with _cache_lock:
        if _cache is None:
            _cache = ResultCache()
        return _cache


def _reset_for_tests() -> None:
    global _cache
    with _cache_lock:
        c, _cache = _cache, None
    if c is not None:
        c.invalidate()
