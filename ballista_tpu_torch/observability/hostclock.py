"""Exclusive host seconds of the thread that runs a standalone collect.

Every thread keeps one clock: the category it charges now, the stack of
the categories it interrupted, and nanoseconds summed per category.
Entering a category charges the time since the thread's last switch to
the category it interrupts; leaving charges it to the one it leaves and
resumes the one below. So each nanosecond falls in exactly one category,
the innermost: a ``device_wait`` inside a governed call counts once, as
``device_wait``. A thread outside every category charges nothing. A
switch costs one ``perf_counter_ns()`` and one integer add; the clock is
always on.

The categories and where they are entered:

- ``frontend``: ``ctx.sql`` (parse, logical planning, the plan cache),
  and the collect's planning (optimizer, physical planning, fusion) and
  its adaptive rewrite (``client.py``);
- ``governor``: ``GovernedFunction.call_with`` (``compile/governor.py``):
  program lookup, input flattening, copies in and out, the replay's
  launch, a first call's warm-up and capture, and on the CPU or for a
  namespace that does not capture the program's eager run (the waits
  for its locks are ``pool_wait``);
- ``operators``: each operator's own host code, every ``next()`` of
  every operator (``metrics.instrument_execute``), the collect's own
  driving of the plan and its conversion of batches to the client's rows
  (``client.py``, ``execution.collect_physical``);
- ``device_wait``: the thread blocked on the card, inside every
  ``device.block`` span (``tracing.trace_span``);
- ``pool_wait``: the thread blocked on other host threads: a prefetch
  handle's queue (``ingest/pipeline.py``, partitions and primed scans),
  ``parallel_map``'s futures, the reader threads of a scan on the card
  (``io/text.py``), a shuffle reader's read-ahead
  (``physical/shuffle.py``), and the governor's replay and capture locks
  (:class:`held`) while another thread holds them. What the other
  threads do is charged to
  their own clocks, never to the collect's categories;
- ``recorder``: the standalone recorder (``systables.py``): its start,
  and its finish (lanes, latency ledger, query history, metrics).

A standalone collect takes its thread's totals when it returns
(:func:`take`), into its latency ledger's ``host`` key
(``StandaloneQueryRecorder.host``), so the ``ctx.sql`` that the thread
ran before the collect is carried into that collect's entry.

Beside them, under ``host["pool"]``, the same categories in thread-seconds
of the pool workers that produced the collect's prefetch handles
(``ingest/pipeline.py``: partitions run on the pool, primed scans): a
worker takes its clock anew for one handle's production, and the
handle's last item hands its take to the consumer (:func:`absorb`),
whose collect takes it in turn, nested handles included. Workers run
side by side and wait for the interpreter's lock inside any category,
so these seconds can add up to more than the wall; they say what the
collect's ``pool_wait`` waited for.
"""

from __future__ import annotations

import threading
from time import perf_counter_ns

CATEGORIES = ("frontend", "governor", "operators", "device_wait",
              "pool_wait", "recorder")
FRONTEND, GOVERNOR, OPERATORS, DEVICE_WAIT, POOL_WAIT, RECORDER = range(6)
_OUTSIDE = -1


class _Clock:
    __slots__ = ("ns", "stack", "cur", "t", "switches", "pool",
                 "pool_switches")

    def __init__(self):
        self.ns = [0] * len(CATEGORIES)
        self.stack: list = []
        self.cur = _OUTSIDE
        self.t = 0
        self.switches = 0
        self.pool = [0.0] * len(CATEGORIES)  # seconds absorbed from workers
        self.pool_switches = 0


class _Local(threading.local):
    def __init__(self):
        self.clock = _Clock()


_local = _Local()


def enter(cat: int) -> None:
    """Charge the thread's time to ``cat`` until the matching
    :func:`leave`. Never hold a category across a ``yield``."""
    c = _local.clock
    t = perf_counter_ns()
    if c.cur >= 0:
        c.ns[c.cur] += t - c.t
    c.stack.append(c.cur)
    c.cur = cat
    c.t = t
    c.switches += 1


def leave() -> None:
    """Charge the time since the last switch to the category left, and
    resume the one it interrupted."""
    c = _local.clock
    t = perf_counter_ns()
    if c.cur >= 0:
        c.ns[c.cur] += t - c.t
    c.cur = c.stack.pop() if c.stack else _OUTSIDE
    c.t = t
    c.switches += 1


class _Charged:
    __slots__ = ("cat",)

    def __init__(self, cat: int):
        self.cat = cat

    def __enter__(self):
        enter(self.cat)
        return self

    def __exit__(self, *exc):
        leave()
        return False


_CHARGED = tuple(_Charged(i) for i in range(len(CATEGORIES)))


def charged(cat: int) -> _Charged:
    """``with charged(GOVERNOR): ...``: the block's time (less that of
    inner categories) to ``cat``. The context manager keeps no state of
    its own, so one instance per category serves every thread."""
    return _CHARGED[cat]


class held:
    """``with held(lock): ...`` holds ``lock``; the wait to acquire it,
    while another thread holds it, is the thread's ``pool_wait`` (a free
    lock is taken without a switch)."""

    __slots__ = ("lock",)

    def __init__(self, lock):
        self.lock = lock

    def __enter__(self):
        if not self.lock.acquire(False):
            enter(POOL_WAIT)
            try:
                self.lock.acquire()
            finally:
                leave()
        return self

    def __exit__(self, *exc):
        self.lock.release()
        return False


def take() -> dict:
    """The thread's seconds per category and its switch count since its
    last take, with the pool workers' it absorbed under ``pool``; starts
    them anew."""
    c = _local.clock
    t = perf_counter_ns()
    if c.cur >= 0:
        c.ns[c.cur] += t - c.t
    c.t = t
    out: dict = {name: ns / 1e9 for name, ns in zip(CATEGORIES, c.ns)}
    out["switches"] = c.switches
    out["pool"] = dict(zip(CATEGORIES, c.pool), switches=c.pool_switches)
    c.ns = [0] * len(CATEGORIES)
    c.pool = [0.0] * len(CATEGORIES)
    c.switches = c.pool_switches = 0
    return out


def absorb(work: dict) -> None:
    """Add a pool worker's :func:`take`, its own categories and those it
    absorbed in turn, to this thread's pool tally."""
    c = _local.clock
    pool = work["pool"]
    c.pool = [p + work[name] + pool[name]
              for p, name in zip(c.pool, CATEGORIES)]
    c.pool_switches += work["switches"] + pool["switches"]
