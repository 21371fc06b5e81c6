"""Process-wide program cache and its observability: the compile governor.

The port's counterpart of the JAX package's ``compile/governor.py``, with
the same surface and names. ``governed(key, build)`` returns the
process-wide entry for ``key``: the first caller's ``build()`` supplies
the Python function, and every later caller with an equal key (an equal
operator signature, see ``keys.py``) shares the entry, so re-planning and
fresh operator instances reuse it.

What an entry does with a call depends on the device of its tensors:

- **CPU**: the built function runs eagerly. This is the path the tests
  take.
- **CUDA**: the entry specializes on the *call signature*, the part of
  its arguments a JAX trace cache re-specializes on: each tensor's shape
  and dtype, the batch structure (which validity masks are present) and
  the identity of each column's ``Dictionary``. The identity matters
  because a string literal resolves to a dictionary code on the host
  (``Evaluator._compare_codes_literal``): a graph captured for one
  dictionary would replay another dictionary's code. For a new signature
  the entry runs the function once eagerly on a side stream (the warm-up,
  whose result the caller gets) and captures it as one
  ``torch.cuda.CUDAGraph``; from then on a call copies its tensors into
  the graph's static input buffers, replays the graph with a single
  launch and hands out copies of the static outputs, so results stay
  valid after the next replay overwrites them. Graphs share one memory
  pool per card: with outputs copied out right after each replay, every
  replay on one stream and one replay queued at a time (its copy-in,
  replay and copies out under one process-wide lock, since partitions
  replay from ingest-pool threads), no graph reads pool memory another
  graph wrote.

``CAPTURE`` declares which namespaces capture; the others run eagerly on
a card too. A capture that fails raises ``CaptureError``; it never falls
back to eager execution. Warm-ups and captures hold one process-wide
lock: partitions may run on ingest-pool threads
(``ingest.iter_partitions``), and the shared side stream must carry one
capture at a time. Other threads keep replaying, and scan producers keep
uploading on their own streams, while a capture runs: the capture's
``thread_local`` mode forbids unsafe calls on the capturing thread only.

A donating call (``call_donating``, see ``cache/donation.py``) hands the
program a batch that gives up its tensors: on a replay right after they
are copied into the graph's static input buffers, before the replay and
the copies out; on the first call and eagerly, once the program returns.

A graph replays every kernel it holds but none of the Python around
them, so two things that the eager run does on the host are carried
over explicitly: constant tables uploaded from host arrays
(``device_constant``: the warm-up uploads them, the capture reuses those
buffers, the program keeps them alive) and per-launch bookkeeping of
hand-written kernels (``on_replay``: e.g. ``dense_sums.launch_count``).

Observability keeps the reference's counters (``entries_built``,
``entry_hits``, ``governed_calls``) and, per signature, the first call's
seconds as ``compile_count``/``elapsed_compile`` on the caller's
``MetricsSet``. The JAX ``backend_compiles``/``compile_seconds`` become
``graph_captures``/``capture_seconds`` (timed around the capture
directly), beside ``graph_replays``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import warnings
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..errors import ExecutionError

__all__ = [
    "CAPTURE",
    "MESH_NS_CAP",
    "CaptureError",
    "GovernedFunction",
    "CompileGovernor",
    "capturing",
    "compile_stats",
    "device_constant",
    "governed",
    "governor",
    "on_replay",
    "reset_compile_stats",
]

_PERF = time.perf_counter

# LRU bound for mesh-path namespaces, as in the JAX package (the mesh
# modules are not ported yet; the bound is kept for them).
MESH_NS_CAP = 32

# Namespaces whose programs are captured as CUDA graphs on a card. Every
# program below keeps its host reads outside: the overflow retries, the
# join totals, the repartition counts and the aggregate statistics read
# their 0-d results only after the program returned. A namespace that is
# not listed runs eagerly on a card as well.
CAPTURE: Dict[str, bool] = {
    "pipeline.fused": True,   # an unfused Filter/Projection chain
    "batch.compact": True,    # front-compaction to a ladder capacity
    "sort.run": True,
    "limit.take": True,
    "repart.sort_by_pid": True,
    "repart.take": True,
    "agg.grouped": True,      # dense (CUDA kernel) or sort-based grouping
    "agg.mixed": True,
    "agg.mstats": True,
    "agg.scalar": True,
    "agg.distinct": True,
    "join.stats": True,
    "join.mark": True,
    "join.unique": True,
    "join.expand": True,
    "join.unmatched": True,
}

# process-wide totals (plain ints/floats under the GIL — the same
# benign-race policy as the operator metrics)
_STATS: Dict[str, Any] = {
    "governed_calls": 0,     # calls through governed functions
    "entry_hits": 0,         # governed-key lookups that found an entry
    "entries_built": 0,      # governed-key lookups that built one
    "programs_built": 0,     # first calls of a (entry, signature) pair
    "graph_captures": 0,     # CUDA graphs captured
    "capture_seconds": 0.0,  # time inside those captures
    "graph_replays": 0,      # CUDA graph replays
    "program_evictions": 0,  # per-entry programs dropped by the LRU bound
}

_tls = threading.local()


class CaptureError(ExecutionError):
    """A governed program could not be captured as a CUDA graph."""


# ---------------------------------------------------------------------------
# the call signature: flattening arguments into tensors + static structure
# ---------------------------------------------------------------------------

_TENSOR = "t"


def _flatten(obj, leaves: List[torch.Tensor]):
    """Static spec of ``obj`` with its tensors appended to ``leaves``.
    The spec is hashable and holds every non-tensor part by value, or by
    identity for ``Dictionary`` objects (their hash is their identity,
    and holding them keeps an id from being reused)."""
    from ..columnar import Column, ColumnBatch

    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return _TENSOR
    if isinstance(obj, ColumnBatch):
        return ("batch", obj.schema,
                tuple(_flatten(c, leaves) for c in obj.columns),
                _flatten(obj.selection, leaves),
                _flatten(obj.num_rows, leaves))
    if isinstance(obj, Column):
        return ("col", obj.dtype, obj.dictionary,
                _flatten(obj.values, leaves),
                _flatten(obj.validity, leaves))
    if isinstance(obj, tuple):
        return ("tuple",) + tuple(_flatten(x, leaves) for x in obj)
    if isinstance(obj, list):
        return ("list",) + tuple(_flatten(x, leaves) for x in obj)
    if isinstance(obj, dict):
        keys = tuple(obj)
        return ("dict", keys) + tuple(_flatten(obj[k], leaves) for k in keys)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = tuple(f.name for f in dataclasses.fields(obj))
        return ("dc", type(obj), fields) + tuple(
            _flatten(getattr(obj, f), leaves) for f in fields)
    return ("static", obj)


def _unflatten(spec, leaves):
    """Inverse of ``_flatten`` over an iterator of tensors."""
    from ..columnar import Column, ColumnBatch

    if spec is _TENSOR:
        return next(leaves)
    kind = spec[0]
    if kind == "batch":
        _, schema, cols, sel, nrows = spec
        cols = [_unflatten(c, leaves) for c in cols]
        return ColumnBatch(schema, cols, _unflatten(sel, leaves),
                           _unflatten(nrows, leaves))
    if kind == "col":
        _, dtype, dictionary, values, validity = spec
        return Column(_unflatten(values, leaves), dtype,
                      _unflatten(validity, leaves), dictionary)
    if kind == "tuple":
        return tuple(_unflatten(s, leaves) for s in spec[1:])
    if kind == "list":
        return [_unflatten(s, leaves) for s in spec[1:]]
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2:])}
    if kind == "dc":
        return spec[1](**{f: _unflatten(s, leaves)
                          for f, s in zip(spec[2], spec[3:])})
    return spec[1]


def _signature(args: tuple):
    """(hashable call signature, tensor leaves) of a call's arguments."""
    leaves: List[torch.Tensor] = []
    spec = _flatten(args, leaves)
    shapes = tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)
    return (spec, shapes), leaves


# ---------------------------------------------------------------------------
# capture state: constants and per-launch bookkeeping
# ---------------------------------------------------------------------------


def capturing() -> bool:
    """True while this thread captures a governed program (host reads
    and host uploads are illegal then)."""
    return getattr(_tls, "capture", None) is not None


def device_constant(array: np.ndarray, device) -> torch.Tensor:
    """Tensor on ``device`` holding the host array ``array`` (a lookup
    table derived from a dictionary or a literal). Inside a governed
    program on a card, the warm-up uploads it into the program's arena
    and the capture reuses that buffer, since a graph cannot hold an
    upload; the arena lives as long as the program. Elsewhere it is a
    plain upload."""
    device = torch.device(device)
    arena = getattr(_tls, "arena", None)
    if arena is None:
        return torch.from_numpy(np.array(array, copy=True)).to(device)
    arr = np.ascontiguousarray(array)
    key = (str(device), arr.dtype.str, arr.shape, arr.tobytes())
    t = arena.get(key)
    if t is None:
        if capturing():
            raise CaptureError(
                "a host constant first appeared during capture: the "
                "program's constants depend on more than its signature")
        t = arena[key] = torch.from_numpy(arr.copy()).to(device)
    return t


def on_replay(fn: Callable[[], None]) -> None:
    """Register ``fn`` to run after every replay of the program being
    captured (a hand-written kernel's launch count, a test's observer).
    Raises outside a governed capture."""
    cap = getattr(_tls, "capture", None)
    if cap is None:
        raise CaptureError("on_replay outside a governed capture")
    cap.append(fn)


class _CaptureScope:
    """Sets this thread's capture flag (with its replay-hook list) and
    constants arena for the duration of a ``with``."""

    def __init__(self, arena: Optional[dict], hooks: Optional[list]):
        self.arena, self.hooks = arena, hooks

    def __enter__(self):
        self.prev = (getattr(_tls, "arena", None),
                     getattr(_tls, "capture", None))
        _tls.arena, _tls.capture = self.arena, self.hooks
        return self

    def __exit__(self, *exc):
        _tls.arena, _tls.capture = self.prev
        return False


# ---------------------------------------------------------------------------
# programs: one per (entry, call signature)
# ---------------------------------------------------------------------------

_POOLS: Dict[int, Any] = {}
_SIDE_STREAMS: Dict[int, Any] = {}
_POOL_LOCK = threading.Lock()
# one warm-up or capture at a time on the shared side streams (reentrant:
# a program's body may reach another governed entry's first call)
_CAPTURE_LOCK = threading.RLock()
# one replay at a time, from its copy-in to its copies out: graphs share
# their card's pool, so one graph's internals may lie where another's
# static outputs are; replays queued from two threads (partitions on the
# ingest pool) must not interleave between a replay and its copies out
_REPLAY_LOCK = threading.Lock()


def _pool_and_side_stream(device: torch.device):
    """The card's graph memory pool and capture side stream, made at first
    use. The pool is held open by an empty anchor graph captured into it:
    torch's allocator marks a private pool freeable once no graph uses
    it, and a later capture into that pool then fails an internal
    assertion (seen on the card after ``governor().clear()`` had dropped
    every program)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _POOL_LOCK:
        if index not in _POOLS:
            with torch.cuda.device(index):
                pool = torch.cuda.graph_pool_handle()
                side = torch.cuda.Stream()
                anchor = torch.cuda.CUDAGraph()
                with torch.cuda.stream(side), warnings.catch_warnings():
                    warnings.filterwarnings(
                        "ignore", message="The CUDA Graph is empty")
                    anchor.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                    anchor.capture_end()
                _POOLS[index] = (pool, anchor)
                _SIDE_STREAMS[index] = side
        return _POOLS[index][0], _SIDE_STREAMS[index]


class _EagerProgram:
    """The record of a signature that runs eagerly (CPU, or a namespace
    that does not capture)."""

    __slots__ = ("calls", "arena")

    def __init__(self):
        self.calls = 0
        self.arena = None  # the CPU capture check's constants


def _input_index(t: torch.Tensor, inputs: List[torch.Tensor]):
    """Index of the input ``t`` is, or is a full same-layout view of
    (``broadcast_to`` to its own shape), else None."""
    for i, s in enumerate(inputs):
        if t is s or (t.data_ptr() == s.data_ptr() and t.dtype == s.dtype
                      and t.shape == s.shape and t.stride() == s.stride()):
            return i
    return None


class _GraphProgram:
    """One captured CUDA graph with its static input and output buffers,
    its constants arena and its replay hooks."""

    __slots__ = ("graph", "static_in", "static_out", "out_spec", "alias",
                 "passthrough", "arena", "hooks", "calls")

    @classmethod
    def capture(cls, gf: "GovernedFunction", args: tuple,
                leaves: List[torch.Tensor]):
        """Warm up on a side stream (the result is this call's), then
        capture. Returns (warm-up result, program)."""
        device = leaves[0].device
        if any(t.device != device for t in leaves):
            # a graph freezes a host tensor's value at capture
            raise CaptureError(
                f"{_render_key(gf.key)}: arguments on several devices "
                f"({sorted({str(t.device) for t in leaves})})")
        with _CAPTURE_LOCK:
            return cls._capture(gf, args, leaves, device)

    @classmethod
    def _capture(cls, gf: "GovernedFunction", args: tuple,
                 leaves: List[torch.Tensor], device: torch.device):
        pool, side = _pool_and_side_stream(device)
        cur = torch.cuda.current_stream(device)
        arena: dict = {}
        # The side stream waits for everything queued so far; the current
        # stream waits for the warm-up. Blocks the warm-up allocates
        # belong to the side stream and are reused only by later
        # warm-ups, each of which first waits for the current stream, so
        # no reuse overtakes a pending read.
        side.wait_stream(cur)
        with _CaptureScope(arena, None), torch.cuda.stream(side):
            out = gf.fn(*args)
        cur.wait_stream(side)
        spec = _flatten(args, [])
        static_in = [torch.empty(t.shape, dtype=t.dtype, device=device)
                     for t in leaves]
        for s, t in zip(static_in, leaves):
            s.copy_(t)
        static_args = _unflatten(spec, iter(static_in))
        graph = torch.cuda.CUDAGraph()
        hooks: list = []
        t0 = _PERF()
        # The graph API's own context manager empties the allocator's
        # cache at every capture; a query captures tens of programs, so
        # the capture is begun and ended here, on the side stream, after
        # one synchronize (the static inputs are filled).
        torch.cuda.synchronize(device)
        try:
            with _CaptureScope(arena, hooks), torch.cuda.stream(side):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    static = gf.fn(*static_args)
                finally:
                    with warnings.catch_warnings():
                        # a program that only renames columns launches
                        # nothing; it is then never replayed (below)
                        warnings.filterwarnings(
                            "ignore", message="The CUDA Graph is empty")
                        graph.capture_end()
        except Exception as e:
            raise CaptureError(
                f"capturing {_render_key(gf.key)} as a CUDA graph failed: "
                f"{type(e).__name__}: {e}") from e
        secs = _PERF() - t0
        _STATS["graph_captures"] += 1
        _STATS["capture_seconds"] += secs
        prog = cls()
        prog.graph, prog.static_in, prog.arena, prog.hooks = \
            graph, static_in, arena, hooks
        out_leaves: List[torch.Tensor] = []
        prog.out_spec = _flatten(static, out_leaves)
        prog.static_out = out_leaves
        # outputs that are inputs (a batch passed through with a new
        # selection, a column renamed) are handed back as the caller's own
        # tensors; a program all of whose outputs are is never replayed
        prog.alias = [_input_index(t, static_in) for t in out_leaves]
        prog.passthrough = not hooks and all(
            i is not None for i in prog.alias)
        prog.calls = 1
        return out, prog, secs

    def replay(self, leaves: List[torch.Tensor], donate=None):
        """Run the graph on ``leaves``. ``donate``: the batch that gives
        up its tensors once they are in the static input buffers."""
        if self.passthrough:
            self.calls += 1
            outs = [leaves[i] for i in self.alias]
            if donate is not None:
                donate.donate()
            return _unflatten(self.out_spec, iter(outs))
        with _REPLAY_LOCK:
            self.calls += 1
            for s, t in zip(self.static_in, leaves):
                s.copy_(t)
            kept = [None if i is None else leaves[i] for i in self.alias]
            if donate is not None:
                # the static buffers hold the inputs now: drop the batch's
                # references (and this call's) so their blocks can serve
                # the copies out below and the rest of the collect
                donate.donate()
                leaves.clear()
            self.graph.replay()
            outs = [k if k is not None else t.clone()
                    for t, k in zip(self.static_out, kept)]
            _STATS["graph_replays"] += 1
            for hook in self.hooks:
                hook()
        return _unflatten(self.out_spec, iter(outs))


def _captures(device: torch.device) -> bool:
    """Whether calls on ``device`` run as captured graphs: on a CUDA card.
    (The CPU tests replace it to drive the graph path with a stand-in
    for ``torch.cuda``'s graph API.)"""
    return device.type == "cuda"


# A test seam: when set, eager calls of capturing namespaces on the CPU go
# through it (``testing/capture_check.py`` checks there that each program
# would be legal to capture). None in normal operation.
_cpu_capture_check: Optional[Callable] = None


class GovernedFunction:
    """One governed entry: the built function plus its programs, one per
    call signature, and per-entry accounting. Shared across operator
    instances with the same signature."""

    __slots__ = ("key", "fn", "capture", "calls", "programs", "_lock")

    def __init__(self, key: tuple, fn: Callable):
        self.key = key
        self.fn = fn
        self.capture = CAPTURE.get(key[0] if key else "", False)
        self.calls = 0
        self.programs: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, *args):
        return self.call_with(None, *args)

    def call_donating(self, batch, *extra):
        """Call on ``(batch, *extra)``; ``batch`` gives up its tensors
        (see the module doc). The caller has claimed it with
        ``cache.donation.consume_transient``."""
        return self.call_with(None, batch, *extra, donate=batch)

    @staticmethod
    def _programs_per_entry() -> int:
        """Per-entry bound on programs (the JAX package's trace bound,
        same knob): signatures carry dictionary identities, so an entry
        re-run over fresh dictionaries would otherwise keep one graph,
        with its static buffers, per run."""
        try:
            return int(os.environ.get("BALLISTA_JIT_TRACES_PER_ENTRY",
                                      "128"))
        except ValueError:
            return 128

    def call_with(self, metrics, *args, donate=None):
        """Invoke, attributing a new signature's first call to
        ``metrics`` (an observability MetricsSet, or None). ``donate``:
        an argument batch that gives up its tensors (``call_donating``)."""
        _STATS["governed_calls"] += 1
        self.calls += 1
        sig, leaves = _signature(args)
        cuda = bool(leaves) and _captures(leaves[0].device)
        with self._lock:
            prog = self.programs.get(sig)
            if prog is not None:
                self.programs.move_to_end(sig)
        if prog is not None:
            if isinstance(prog, _GraphProgram):
                return prog.replay(leaves, donate)
            prog.calls += 1
            if _cpu_capture_check is not None and self.capture and not cuda:
                out = _cpu_capture_check(self, args, prog)
            else:
                out = self.fn(*args)
            if donate is not None:
                donate.donate()
            return out
        t0 = _PERF()
        if cuda and self.capture:
            out, prog, capture_secs = _GraphProgram.capture(self, args,
                                                            leaves)
        else:
            prog = _EagerProgram()
            prog.calls = 1
            capture_secs = 0.0
            if _cpu_capture_check is not None and self.capture and not cuda:
                out = _cpu_capture_check(self, args, prog)
            else:
                out = self.fn(*args)
        secs = _PERF() - t0
        with self._lock:
            self.programs[sig] = prog
            bound = self._programs_per_entry()
            while bound > 0 and len(self.programs) > bound:
                self.programs.popitem(last=False)
                _STATS["program_evictions"] += 1
        _STATS["programs_built"] += 1
        if metrics is not None:
            # the whole first call: warm-up, and capture on a card
            metrics.add_counter("compile_count", 1)
            metrics.add_time("elapsed_compile", secs)
        from ..observability.tracing import trace_event

        trace_event("compile.capture", key=_render_key(self.key),
                    captured=isinstance(prog, _GraphProgram),
                    capture_seconds=round(capture_secs, 6),
                    call_seconds=round(secs, 6))
        if donate is not None:
            donate.donate()
        return out


class _BoundGoverned:
    """A governed function bound to one operator's MetricsSet."""

    __slots__ = ("gf", "metrics")

    def __init__(self, gf: GovernedFunction, metrics):
        self.gf = gf
        self.metrics = metrics

    def __call__(self, *args):
        return self.gf.call_with(self.metrics, *args)

    def call_donating(self, batch, *extra):
        return self.gf.call_with(self.metrics, batch, *extra, donate=batch)


def _render_key(key: tuple) -> str:
    try:
        return repr(key)[:200]
    except Exception:  # noqa: BLE001 - unreprable key component
        return str(key[0]) if key else "?"


def _default_ns_cap() -> int:
    """Default per-namespace LRU bound. Governed entries outlive operator
    instances (that's the point), so a long-lived server answering
    thousands of DISTINCT query shapes would otherwise pin programs —
    and, through signatures, per-query dictionaries — forever. Raise or
    lower with BALLISTA_JIT_CACHE_ENTRIES."""
    try:
        return int(os.environ.get("BALLISTA_JIT_CACHE_ENTRIES", "1024"))
    except ValueError:
        return 1024


class CompileGovernor:
    """Process-wide registry of governed entries, grouped by the key's
    leading namespace string (per-namespace LRU caps)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spaces: Dict[str, OrderedDict] = {}
        self._caps: Dict[str, int] = {}

    def get(self, key: tuple, build: Callable[[], Callable], *,
            metrics=None, cap: Optional[int] = None):
        """The governed function for ``key`` (``build()`` runs on first
        use). ``cap`` bounds the key's namespace (LRU). With ``metrics``,
        returns a bound wrapper that attributes first calls to that
        MetricsSet."""
        ns = key[0] if key else "default"
        with self._lock:
            space = self._spaces.get(ns)
            if space is None:
                space = self._spaces[ns] = OrderedDict()
            if cap is not None:
                self._caps[ns] = cap
            gf = space.get(key)
            if gf is not None:
                space.move_to_end(key)
                _STATS["entry_hits"] += 1
        if gf is None:
            # build OUTSIDE the lock: build() may itself request governed
            # entries, which would deadlock a held non-reentrant lock.
            # Racing builders are possible and cheap; the first insert
            # wins.
            gf = GovernedFunction(key, build())
            with self._lock:
                # re-fetch: clear() may have swapped the namespace dict
                space = self._spaces.setdefault(ns, OrderedDict())
                existing = space.get(key)
                if existing is not None:
                    gf = existing
                    space.move_to_end(key)
                    _STATS["entry_hits"] += 1
                else:
                    ns_cap = self._caps.get(ns, _default_ns_cap())
                    if ns_cap > 0:
                        while len(space) >= ns_cap:
                            space.popitem(last=False)
                    space[key] = gf
                    _STATS["entries_built"] += 1
        if metrics is None:
            return gf
        return _BoundGoverned(gf, metrics)

    def entries(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._spaces.values())

    def namespace_sizes(self) -> Dict[str, int]:
        with self._lock:
            return {ns: len(s) for ns, s in self._spaces.items()}

    def clear(self, namespace: Optional[str] = None) -> None:
        """Drop entries, and with them their programs and graphs."""
        with self._lock:
            if namespace is None:
                self._spaces.clear()
            else:
                self._spaces.pop(namespace, None)


_GOVERNOR = CompileGovernor()


def governor() -> CompileGovernor:
    return _GOVERNOR


def governed(key: tuple, build: Callable[[], Callable], *, metrics=None,
             cap: Optional[int] = None):
    """Module-level shorthand for ``governor().get(...)``."""
    return _GOVERNOR.get(key, build, metrics=metrics, cap=cap)


def compile_stats() -> Dict[str, Any]:
    """Snapshot of process-wide accounting."""
    out = dict(_STATS)
    out["entries"] = _GOVERNOR.entries()
    return out


def reset_compile_stats() -> None:
    """Zero the process-wide counters (tests; entries stay cached)."""
    for k, v in list(_STATS.items()):
        _STATS[k] = 0.0 if isinstance(v, float) else 0
