"""Process-wide dictionary registry: device-resident string encodings.

The port's copy of the JAX package's ``columnar_registry.py``. Host
numpy throughout; its one device-side step, applying an int32 remap
table to a column's codes, is :func:`remap_codes` (an ``index_select``
on the codes' device). In the port the Parquet scan interns its
dictionaries here, Arrow IPC shuffle reads resolve or adopt theirs here
(so equal content read twice gives the same ``Dictionary`` object, and
a governed program's signature, which holds dictionary identity, does
not change), and ``concat_batches`` unifies through :func:`unify`. The
port's text scan keeps its own per-source dictionaries (``io/text.py``).

The engine keeps utf8 columns dictionary-encoded end-to-end (codes on
device, values on host — columnar.py). Before this module, every place
where two differently-encoded columns met rebuilt a sorted union with
``np.unique`` over *object arrays* and re-derived remap tables with
per-call ``.astype(str)`` casts — the ``host.dictionary`` profiler lane:
GIL-bound numpy string work that re-ran on every shuffle read group,
every concat of mixed batches and every join probe chain, and that
ROADMAP item 1 flags as the lane that caps string-heavy queries at
scale.

This registry makes dictionary identity a managed resource, the way
``compile/`` made jit compilation one:

- **Interning**: producers (text/parquet scans) intern their sorted
  value sets per (table files, column) entry, so every scan of one
  table — across source instances, re-scans, executor tasks in one
  process — shares ONE ``Dictionary`` instance and codes are comparable
  by construction (unify degenerates to an identity check).
- **Versioned entries**: when an entry sees new values it appends a new
  *version* (sorted superset union) and records an int32 *step remap*
  (old code -> new code). Any two versions of one entry then remap
  through pure integer composition — no string comparison at all — and
  sites apply the table as a device-side gather (:func:`remap_codes`).
- **Content epochs**: every registered dictionary carries an *epoch* —
  a vectorized content fingerprint (``values_fingerprint``). Epochs are
  the cross-process currency: shuffle writers stamp them into Arrow IPC
  field metadata so readers resolve the SAME in-process instance (or
  adopt one, once, per epoch) instead of rebuilding values from the
  wire.
- **Cached remaps/unions**: cross-entry pairs (join keys from different
  tables) and multi-producer unions are built once per
  (fingerprint, fingerprint) pair — C-level searchsorted over the
  cached ``values_str()`` views, never per invocation, never over
  object arrays — and served from bounded process-wide caches.

The JAX package's ``BALLISTA_DICT_REGISTRY=off`` switch is not ported:
the port always runs through the registry.

Invariants:

- dictionary values are ALWAYS sorted + duplicate-free — comparison
  kernels translate string ordering to code ordering and
  ``searchsorted`` boundaries (kernels/expr_eval.py) rely on it;
- versions of one entry form a superset chain (version k's value set
  contains version j's for k >= j), so step remaps are strictly
  increasing injections and inverses are well-defined;
- a ``Dictionary`` never mutates after registration; appends mint new
  instances.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .columnar import Dictionary

# bounds: entries/epochs/remaps are tiny next to the dictionaries they
# index, but nothing here may grow without limit in a long-lived server
_MAX_VERSIONS = 64        # per entry; past it, interns return unstamped
_MAX_ENTRIES = 256        # table entries (LRU; evicted entries degrade
#                           their members to pairwise remaps, never wrong)
_MAX_EPOCHS = 512         # process-wide interned instances (LRU)
_MAX_REMAPS = 256         # cached pairwise remap tables (LRU)
_MAX_UNIONS = 64          # cached multi-producer unions (LRU)


# ---------------------------------------------------------------------------
# vectorized content fingerprints (the "epoch" of a value set)
# ---------------------------------------------------------------------------


def _obj_lens(values) -> np.ndarray:
    """Per-value codepoint lengths of the ORIGINAL values (numpy's
    fixed-width unicode representation silently drops trailing U+0000,
    so ``np.char.str_len`` over a str view cannot see them)."""
    return np.fromiter((len(str(v)) for v in values), dtype=np.int64,
                       count=len(values))


def values_fingerprint(sv: np.ndarray,
                       lens: Optional[np.ndarray] = None) -> str:
    """sha1 of a sorted str array's content, vectorized (no per-value
    Python loop): the raw fixed-width UCS4 buffer (a memcpy, no utf-8
    re-encode) plus a per-value length plane. Collision-free over value
    sets: two sets sharing a buffer can only differ in trailing NULs,
    which the length plane separates (pass ``lens`` from the original
    objects when they might carry trailing NULs). Byte order rides in
    the digest so a fingerprint never crosses endianness silently."""
    h = hashlib.sha1()
    h.update(f"{len(sv)}:{sys.byteorder}:".encode())
    if len(sv):
        if lens is None:
            lens = np.char.str_len(sv)
        h.update(np.ascontiguousarray(lens.astype("<i8")).tobytes())
        h.update(np.ascontiguousarray(sv).tobytes())
    return h.hexdigest()


def fingerprint(d: Dictionary) -> str:
    """Content fingerprint of any dictionary, cached on the instance.
    Registry members carry it from registration; others compute it
    once, vectorized. The object-length plane keeps a trailing-NUL value
    set (which the registry refuses to intern) from aliasing its
    stripped twin."""
    fp = d._reg_epoch
    if fp is None:
        fp = d._reg_epoch = values_fingerprint(d.values_str(),
                                               _obj_lens(d.values))
    return fp


def _nul_tails(values, sv: np.ndarray) -> bool:
    """True when any value is corrupted by the str view (trailing
    U+0000): such sets stay OUTSIDE the registry — object-array
    semantics apply, exactness over speed."""
    return len(sv) > 0 and not np.array_equal(_obj_lens(values),
                                              np.char.str_len(sv))


def _str_view_exact(d: Dictionary) -> bool:
    """Whether ``d.values_str()`` represents the values losslessly
    (no trailing-NUL values). Cached per instance; registry members
    are exact by construction (intern/adopt refuse the rest)."""
    exact = d._str_exact
    if exact is None:
        exact = d._str_exact = not _nul_tails(d.values, d.values_str())
    return exact


def file_entry_key(kind: str, path: str, files: Sequence[str]) -> tuple:
    """Table-scoped entry-key base for file sources: same files (path +
    sizes + mtimes) -> same entry, so every source instance over this
    data shares interned dictionaries; regenerated data changes the
    signature and can never alias a stale entry. Column name is
    appended by the caller per dictionary."""
    try:
        sig = tuple((os.path.basename(f), os.path.getsize(f),
                     os.stat(f).st_mtime_ns) for f in files)
    except OSError:
        # unstatable source: a process-unique private entry (sharing
        # would risk aliasing data we cannot identify)
        with _key_seq_lock:
            _KEY_SEQ[0] += 1
            sig = (("unstatable", _KEY_SEQ[0]),)
    return (kind, os.path.abspath(path), sig)


_KEY_SEQ = [0]
_key_seq_lock = threading.Lock()


# ---------------------------------------------------------------------------
# registry entries
# ---------------------------------------------------------------------------


class RegistryEntry:
    """One table-scoped dictionary namespace: a chain of sorted-superset
    versions plus the int32 step remaps between them."""

    __slots__ = ("key", "entry_id", "lock", "versions", "steps",
                 "_composed")

    def __init__(self, key: tuple):
        self.key = key
        self.entry_id = hashlib.sha1(repr(key).encode()).hexdigest()[:16]
        self.lock = threading.Lock()
        self.versions: List[Dictionary] = []
        self.steps: List[np.ndarray] = []  # steps[i]: v_i codes -> v_{i+1}
        self._composed: Dict[Tuple[int, int], np.ndarray] = {}

    def compose(self, u: int, t: int) -> np.ndarray:
        """Composed remap: version-u codes -> version-t codes (u < t).
        Pure integer gathers over the recorded steps; cached."""
        r = self._composed.get((u, t))
        if r is None:
            r = self.steps[u]
            for i in range(u + 1, t):
                r = self.steps[i][r]
            self._composed[(u, t)] = r
        return r


class DictionaryRegistry:
    """Process-wide singleton (module-level ``REGISTRY``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, RegistryEntry]" = OrderedDict()
        self._by_id: Dict[str, RegistryEntry] = {}
        self._by_epoch: "OrderedDict[str, Dictionary]" = OrderedDict()
        self._remaps: "OrderedDict[Tuple[str, str], np.ndarray]" = \
            OrderedDict()
        self._unions: "OrderedDict[tuple, Dictionary]" = OrderedDict()

    # -- bookkeeping --------------------------------------------------------

    def _entry(self, key: tuple) -> RegistryEntry:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = RegistryEntry(key)
                self._by_id[e.entry_id] = e
                # bound the table set: a long-lived executor scanning
                # many datasets (file signatures mint fresh keys per
                # regeneration) must not pin stale version chains
                # forever. Evicted members degrade to pairwise remaps.
                while len(self._entries) > _MAX_ENTRIES:
                    _k, old = self._entries.popitem(last=False)
                    self._by_id.pop(old.entry_id, None)
            else:
                self._entries.move_to_end(key)
            return e

    def _intern_epoch(self, fp: str, d: Dictionary) -> Dictionary:
        """Exactly one live instance per content epoch (LRU-bounded);
        identity sharing is what turns downstream unify into a no-op."""
        with self._lock:
            cur = self._by_epoch.get(fp)
            if cur is not None:
                self._by_epoch.move_to_end(fp)
                return cur
            self._by_epoch[fp] = d
            while len(self._by_epoch) > _MAX_EPOCHS:
                self._by_epoch.popitem(last=False)
            return d

    def _stamp(self, d: Dictionary, entry: Optional[RegistryEntry],
               version: Optional[int], fp: str) -> Dictionary:
        if entry is not None:
            d._reg_entry_id = entry.entry_id
            d._reg_version = version
        d._reg_epoch = fp
        return self._intern_epoch(fp, d)

    # -- producer API -------------------------------------------------------

    def intern(self, key: tuple, values) -> Dictionary:
        """Sorted-unique ``values`` -> the shared Dictionary for this
        entry. Returns the current version when values are a subset of
        it (callers encode against the RETURNED dictionary's values);
        otherwise appends a superset union version and records the step
        remap. Trailing-NUL values -> plain unstamped Dictionary."""
        sv = _as_str(values)
        if _nul_tails(values, sv):
            return Dictionary(values)
        entry = self._entry(key)
        with entry.lock:
            if not entry.versions:
                d = _with_str_cache(Dictionary(sv), sv)
                d = self._stamp(d, entry, 0, values_fingerprint(sv))
                entry.versions.append(d)
                return d
            cur = entry.versions[-1]
            cs = cur.values_str()
            if len(sv) == len(cs) and np.array_equal(sv, cs):
                return cur
            fp = values_fingerprint(sv)
            known = self._by_epoch.get(fp)
            if known is not None:  # an older version / adopted twin
                return known
            union = np.unique(np.concatenate([cs, sv])) if len(sv) else cs
            if len(union) == len(cs):  # subset: current covers it
                return cur
            if len(entry.versions) >= _MAX_VERSIONS:
                d = _with_str_cache(Dictionary(sv), sv)
                d._reg_epoch = fp
                return self._intern_epoch(fp, d)
            step = np.searchsorted(union, cs).astype(np.int32)
            nd = _with_str_cache(Dictionary(union), union)
            nd = self._stamp(nd, entry, len(entry.versions),
                             values_fingerprint(union))
            entry.steps.append(step)
            entry.versions.append(nd)
            return nd

    def lookup(self, key: tuple) -> Optional[Dictionary]:
        """Current version for an entry key, if any — lets a fresh
        source instance skip rebuilding values it already paid for."""
        with self._lock:
            e = self._entries.get(key)
        if e is None:
            return None
        with e.lock:
            return e.versions[-1] if e.versions else None

    # -- cross-process stamps (Arrow IPC metadata, AOT output protos) ------

    def stamp_of(self, d: Optional[Dictionary]) -> Optional[str]:
        if d is None or d._reg_epoch is None:
            return None
        if d._reg_entry_id is None:
            # entry-less registered dictionaries (unify unions, plain
            # adoptions) still ship their epoch: resolution is by
            # epoch, so readers get the same 3.4us fast path
            return f"-:-:{d._reg_epoch}"
        return f"{d._reg_entry_id}:{d._reg_version}:{d._reg_epoch}"

    def resolve(self, stamp: Optional[str]) -> Optional[Dictionary]:
        """Stamp -> the live in-process instance, or None (caller falls
        back to the shipped values). Resolution is BY CONTENT EPOCH, so
        a stale or foreign stamp can never alias a different value set."""
        if not stamp:
            return None
        epoch = stamp.rsplit(":", 1)[-1]
        with self._lock:
            d = self._by_epoch.get(epoch)
            if d is not None:
                self._by_epoch.move_to_end(epoch)
            return d

    def adopt(self, stamp: Optional[str], values) -> Dictionary:
        """Values received from another process (shuffle read, loaded
        AOT artifact) -> ONE shared instance per content epoch. The
        stamp's epoch is verified against the actual values before any
        entry identity is trusted. Repeat adoptions of known content
        return the interned instance BEFORE building a Dictionary (the
        value-index construction dominates adoption cost)."""
        sv = _as_str(values)
        lens = _obj_lens(values)
        if len(sv) and not np.array_equal(lens, np.char.str_len(sv)):
            return Dictionary(values)
        fp = values_fingerprint(sv, lens)
        with self._lock:
            cur = self._by_epoch.get(fp)
            if cur is not None:
                self._by_epoch.move_to_end(fp)
                return cur
        d = _with_str_cache(Dictionary(sv), sv)
        if stamp:
            parts = stamp.split(":")
            if len(parts) == 3 and parts[2] == fp:
                d._reg_entry_id = parts[0]
                try:
                    d._reg_version = int(parts[1])
                except ValueError:
                    d._reg_entry_id = None
        d._reg_epoch = fp
        return self._intern_epoch(fp, d)

    # -- remap / unify ------------------------------------------------------

    def _chain_remap(self, src: Dictionary, dst: Dictionary
                     ) -> Optional[np.ndarray]:
        """Same-entry fast path: pure integer composition (or inverse).
        None when not on one chain OR when src is dst-coded already."""
        eid = src._reg_entry_id
        if eid is None or eid != dst._reg_entry_id:
            return None
        u, t = src._reg_version, dst._reg_version
        if u is None or t is None or u == t:
            return None
        with self._lock:
            entry = self._by_id.get(eid)
        if entry is None:
            return None
        with entry.lock:
            if max(u, t) >= len(entry.versions) or \
                    entry.versions[u] is not src or \
                    entry.versions[t] is not dst:
                return None  # adopted twins without a local chain
            if u < t:
                return entry.compose(u, t)
            fwd = entry.compose(t, u)  # dst codes -> src codes
        inv = np.full(len(src), -1, np.int32)
        inv[fwd] = np.arange(len(dst), dtype=np.int32)
        return inv

    def remap_between(self, src: Dictionary, dst: Dictionary
                      ) -> Optional[np.ndarray]:
        """int32 table: src codes -> dst codes (-1 where the value is
        absent from dst). None means the codings are identical (no
        remap needed). Built once per (content, content) pair —
        integer composition within an entry, one C-level sorted search
        across entries — and cached process-wide."""
        if src is dst:
            return None
        if not (_str_view_exact(src) and _str_view_exact(dst)):
            # trailing-NUL values: the str views are lossy, so such
            # pairs must not enter the content-keyed cache (their
            # fingerprints carry the object-length plane, their views
            # do not)
            return _searchsorted_remap(src.values_str(), dst.values_str())
        sfp, dfp = fingerprint(src), fingerprint(dst)
        if sfp == dfp:
            return None
        key = (sfp, dfp)
        with self._lock:
            r = self._remaps.get(key)
            if r is not None:
                self._remaps.move_to_end(key)
                return r
        r = self._chain_remap(src, dst)
        if r is None:
            r = _searchsorted_remap(src.values_str(), dst.values_str())
        with self._lock:
            self._remaps[key] = r
            while len(self._remaps) > _MAX_REMAPS:
                self._remaps.popitem(last=False)
        return r

    def unify(self, dicts: Sequence[Optional[Dictionary]]
              ) -> Tuple[Optional[Dictionary], List[Optional[np.ndarray]]]:
        """Shared target dictionary for a set of batches' dictionaries +
        per-input int32 remap (None = codes already valid in the
        target). Empty/None inputs pass codes through unchanged. Never
        returns -1s: the target always covers every input."""
        present = [d for d in dicts if d is not None and len(d)]
        if not present:
            return next((d for d in dicts if d is not None), None), \
                [None] * len(dicts)
        if not all(_str_view_exact(d) for d in present):
            # a member carries trailing-NUL values the str views cannot
            # represent: the object-array union is the only lossless path
            return self._object_union(dicts)
        # one distinct content -> that instance, no remaps at all
        fps = [fingerprint(d) for d in present]
        first = present[0]
        if all(fp == fps[0] for fp in fps):
            return first, [None] * len(dicts)
        # one entry -> the max version present covers every member —
        # but only trust it when the remaps prove it: an adopted twin
        # stamped by a sibling process whose chain diverged from ours
        # can carry a higher version WITHOUT being a superset, and a
        # -1 in a unify remap would clip to code 0 downstream
        # (silently wrong values). Any miss falls through to the union.
        eids = {d._reg_entry_id for d in present}
        if len(eids) == 1 and None not in eids:
            target = max(present,
                         key=lambda d: d._reg_version
                         if d._reg_version is not None else -1)
            if target._reg_version is not None:
                remaps = self._remaps_to(dicts, target)
                if all(r is None or (r >= 0).all() for r in remaps):
                    return target, remaps
        # cross-entry / unstamped: cached union keyed by the member set
        ukey = tuple(sorted(set(fps)))
        with self._lock:
            target = self._unions.get(ukey)
            if target is not None:
                self._unions.move_to_end(ukey)
        if target is None:
            union = np.unique(np.concatenate(
                [d.values_str() for d in present]))
            target = _with_str_cache(Dictionary(union), union)
            target = self._stamp(target, None, None,
                                 values_fingerprint(union))
            with self._lock:
                self._unions[ukey] = target
                while len(self._unions) > _MAX_UNIONS:
                    self._unions.popitem(last=False)
        return target, self._remaps_to(dicts, target)

    def _remaps_to(self, dicts, target) -> List[Optional[np.ndarray]]:
        return [None if (d is None or len(d) == 0 or d is target)
                else self.remap_between(d, target) for d in dicts]

    def _object_union(self, dicts):
        """Sorted union over OBJECT arrays + per-member searchsorted
        remaps, for members whose str views are lossy."""
        union = np.unique(np.concatenate(
            [np.asarray(d.values, dtype=object) for d in dicts
             if d is not None and len(d)]
        ))
        union_str = union.astype(str)
        out: List[Optional[np.ndarray]] = []
        for d in dicts:
            if d is None or len(d) == 0:
                out.append(None)
                continue
            out.append(np.searchsorted(
                union_str, d.values_str()).astype(np.int32))
        return Dictionary(union), out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "versions": sum(len(e.versions)
                                for e in self._entries.values()),
                "epochs": len(self._by_epoch),
                "remaps": len(self._remaps),
                "unions": len(self._unions),
            }


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _as_str(values) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype.kind == "U":
        return arr
    return arr.astype(str)


def _with_str_cache(d: Dictionary, sv: np.ndarray) -> Dictionary:
    d._cache_str_view(sv)
    d._str_exact = True  # registry members passed the NUL-tail guard
    return d


def _searchsorted_remap(sv: np.ndarray, dv: np.ndarray) -> np.ndarray:
    """src values -> positions in dst values (-1 where absent); one
    C-level sorted search over the cached str views."""
    if len(dv) == 0:
        return np.full(max(len(sv), 1), -1, np.int32)
    idx = np.searchsorted(dv, sv)
    idx_c = np.minimum(idx, len(dv) - 1)
    ok = dv[idx_c] == sv
    return np.where(ok, idx_c, -1).astype(np.int32)


REGISTRY = DictionaryRegistry()


def remap_codes(codes: torch.Tensor, remap: np.ndarray) -> torch.Tensor:
    """Apply an int32 remap table to dictionary codes on their device
    (codes clamped into the table, as the JAX package's ``jnp.take(...,
    mode="clip")``); int32 out."""
    table = torch.from_numpy(np.ascontiguousarray(remap, dtype=np.int32)
                             ).to(codes.device)
    idx = codes.to(torch.int64).clamp(0, max(len(remap) - 1, 0))
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(codes.shape)


# convenience wrappers (call-site ergonomics; see the class docstrings)

def intern(key: tuple, values) -> Dictionary:
    return REGISTRY.intern(key, values)


def unify(dicts) -> Tuple[Optional[Dictionary], List[Optional[np.ndarray]]]:
    return REGISTRY.unify(dicts)


def remap_between(src: Dictionary, dst: Dictionary) -> Optional[np.ndarray]:
    return REGISTRY.remap_between(src, dst)


def unify_parts(
    parts: List[Tuple[np.ndarray, Union[Dictionary, np.ndarray]]]
) -> Tuple[Dictionary, List[np.ndarray]]:
    """Shuffle-read variant: [(codes, Dictionary-or-raw-values)] ->
    (target, remapped codes per part). Raw value arrays (legacy wire
    format) are adopted first so equal producers still collapse to one
    instance."""
    dicts: List[Optional[Dictionary]] = [
        dv if isinstance(dv, Dictionary) else REGISTRY.adopt(None, dv)
        for _codes, dv in parts]
    target, remaps = REGISTRY.unify(dicts)
    if target is None:
        target = Dictionary([])
    out_codes = []
    for (codes, _dv), remap in zip(parts, remaps):
        if remap is None:
            out_codes.append(codes)
        else:
            out_codes.append(remap[codes].astype(np.int32))
    return target, out_codes
