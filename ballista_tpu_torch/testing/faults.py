"""Deterministic fault injection: named, registered fault points.

The port's copy of the JAX package's ``testing/faults.py``.
The reference has "no fault injection" at all (SURVEY.md:336-343);
every recovery behavior in this engine was pinned only by hand-crafted
setups (killing work_dirs, fake statuses). This module turns each
failure-handling boundary into a NAMED fault point that tests — and
the chaos sweep — can arm from the environment:

    BALLISTA_FAULTS="shuffle.fetch=fail-every:3;client.rpc=delay:50"

Grammar: ``;``- or ``,``-separated ``point=trigger`` pairs, where
``trigger`` is one of

- ``fail-once[:K]``  — raise :class:`FaultInjected` on the Kth hit
  only (1-based, default 1);
- ``fail-every:N``   — raise on every Nth hit (N >= 1);
- ``delay:MS``       — sleep MS milliseconds on every hit;
- ``delay-once:MS``  — sleep MS milliseconds on the first hit only;
- ``drop[-once[:K]|-every:N]`` — for points with drop semantics (the
  data plane closes the connection without a response); points that
  cannot drop treat a triggered drop as a no-op.

Triggers are DETERMINISTIC: per-point hit counters, no randomness —
the same program under the same spec fails identically every run. A
chaos sweep gets its variety by sweeping SPECS (seeds index a config
table), not by sampling.

Registered points (``dev/check_fault_points.py`` lints call sites
against this table):

==================== =======================================================
point                boundary
==================== =======================================================
scheduler.poll_work  top of the scheduler's PollWork handler (RPC fails,
                     executors exercise their backoff + report re-delivery)
executor.task.start  executor task runner, before execution (task fails
                     transiently; recovery re-queues within budget)
shuffle.fetch        consumer-side shuffle fetch, per attempt (tagged
                     ShuffleFetchError path: producer re-queue)
dataplane.serve      data-plane request handler (drop = close without a
                     response; fail = error response)
state.save           scheduler state task-status persistence
state.load           scheduler state rehydration read at construction
                     (fail = a restarted scheduler's recovery scan
                     degrades — serves with whatever loaded)
client.rpc           every SchedulerClient RPC, client side
scheduler.progress_report  executor-side TaskProgress piggyback assembly
                     (drop = skip this round's samples, delay = stall
                     them, fail = swallowed — progress is best-effort
                     and results must stay byte-identical)
shuffle.spill.write  spill-pool segment append (fail = IoError-shaped
                     disk fault; drop = TORN write — half the payload
                     reaches disk, the re-read detects SpillCorrupt)
shuffle.stream.chunk consumer-side chunk receive, per chunk (fail =
                     mid-transfer transport fault; delay = slow
                     consumer exercising flow control)
dataplane.flow       server-side chunk-stream writer, per chunk (drop =
                     close mid-stream like a crashed peer; fail =
                     tagged error frame to the reader)
scheduler.admit      admission gate on ExecuteQuery (fail = the
                     submission is shed with a structured retryable
                     error; clients honoring retry-after resubmit)
scheduler.admission_queue  admission queue pump (fail = this pump round
                     is skipped and the next retries — a queue fault
                     may delay dispatch, never lose a submission)
autoscaler.spawn     autoscaler scale-up hook, before the spawn (fail =
                     this tick is skipped; the demand signal persists
                     so the next tick retries)
==================== =======================================================

Disabled cost: one module-global ``is None`` check per hit — the
<5% warm-q1 overhead gate covers the armed-but-idle case too.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional

from ..errors import FaultInjected

log = logging.getLogger("ballista.faults")

# point -> description (the lint's registry; keep in step with the
# table in the module docstring and docs/robustness.md)
FAULT_POINTS: Dict[str, str] = {
    "scheduler.poll_work": "scheduler PollWork handler entry",
    "executor.task.start": "executor task runner, before execution",
    "shuffle.fetch": "consumer-side shuffle fetch attempt",
    "dataplane.serve": "data-plane request handler",
    "state.save": "scheduler task-status persistence",
    "state.load": "scheduler state rehydration read at construction",
    "client.rpc": "SchedulerClient RPC, client side",
    "scheduler.progress_report": "executor TaskProgress piggyback "
                                 "assembly (live progress plane)",
    "shuffle.spill.write": "spill-pool segment append (drop = torn "
                           "write)",
    "shuffle.stream.chunk": "consumer-side chunk receive on the "
                            "streaming shuffle fetch",
    "dataplane.flow": "server-side chunk-stream writer (drop = close "
                      "mid-stream)",
    "scheduler.admit": "admission gate on ExecuteQuery (fail = the "
                       "submission is shed with a retryable error)",
    "scheduler.admission_queue": "admission queue pump (fail = skip "
                                 "this round, the next pump retries; "
                                 "delay = stalled dispatch)",
    "autoscaler.spawn": "autoscaler scale-up hook, before the spawn "
                        "(fail = skip this tick, the next retries)",
}


class _Rule:
    """One parsed trigger for one point, with its deterministic hit
    counter."""

    __slots__ = ("point", "action", "nth", "every", "delay_ms", "hits",
                 "lock")

    def __init__(self, point: str, action: str, nth: int = 0,
                 every: int = 0, delay_ms: float = 0.0):
        self.point = point
        self.action = action  # "fail" | "delay" | "drop"
        self.nth = nth        # fire on exactly this hit (1-based)
        self.every = every    # fire on every Nth hit
        self.delay_ms = delay_ms
        self.hits = 0
        self.lock = threading.Lock()

    def fire(self) -> Optional[str]:
        """Count one hit; return the action when this hit triggers."""
        with self.lock:
            self.hits += 1
            n = self.hits
        if self.every:
            triggered = n % self.every == 0
        else:
            triggered = n == (self.nth or 1)
        if not triggered:
            return None
        if self.action == "delay":
            time.sleep(self.delay_ms / 1000.0)
            return "delay"
        return self.action


class FaultConfigError(ValueError):
    """BALLISTA_FAULTS could not be parsed — raised eagerly at load so
    a typo'd spec fails the test arming it, not silently no-ops."""


def _parse_trigger(point: str, trig: str) -> _Rule:
    head, _, arg = trig.partition(":")
    head = head.strip().lower()
    arg = arg.strip()
    try:
        if head == "fail-once":
            return _Rule(point, "fail", nth=int(arg) if arg else 1)
        if head == "fail-every":
            return _Rule(point, "fail", every=max(int(arg), 1))
        if head == "delay":
            return _Rule(point, "delay", every=1,
                         delay_ms=float(arg))
        if head == "delay-once":
            return _Rule(point, "delay", nth=1, delay_ms=float(arg))
        if head in ("drop", "drop-once"):
            return _Rule(point, "drop", nth=int(arg) if arg else 1)
        if head == "drop-every":
            return _Rule(point, "drop", every=max(int(arg), 1))
    except ValueError as e:
        raise FaultConfigError(
            f"bad argument in BALLISTA_FAULTS trigger {trig!r} "
            f"for point {point!r}: {e}") from None
    raise FaultConfigError(
        f"unknown BALLISTA_FAULTS trigger {trig!r} for point {point!r} "
        "(expected fail-once[:K] | fail-every:N | delay:MS | "
        "delay-once:MS | drop[-once[:K]|-every:N])")


def parse_spec(spec: str) -> Dict[str, _Rule]:
    """Parse a BALLISTA_FAULTS value into {point: rule}. Unknown point
    names fail loudly — an armed fault that can never fire is a test
    bug."""
    rules: Dict[str, _Rule] = {}
    for part in spec.replace(",", ";").split(";"):
        part = part.strip()
        if not part:
            continue
        point, sep, trig = part.partition("=")
        point = point.strip()
        if not sep or not trig.strip():
            raise FaultConfigError(
                f"malformed BALLISTA_FAULTS entry {part!r} "
                "(expected point=trigger)")
        if point not in FAULT_POINTS:
            raise FaultConfigError(
                f"unknown fault point {point!r} in BALLISTA_FAULTS "
                f"(registered: {', '.join(sorted(FAULT_POINTS))})")
        rules[point] = _parse_trigger(point, trig.strip())
    return rules


# None = faults disabled (the common case: ONE is-None check per hit).
# Armed once at first use from BALLISTA_FAULTS; tests re-arm explicitly
# via reload_faults() after changing the env.
_rules: Optional[Dict[str, _Rule]] = None
_loaded = False
_load_lock = threading.Lock()


def _load() -> Optional[Dict[str, _Rule]]:
    global _rules, _loaded
    with _load_lock:
        if not _loaded:
            spec = os.environ.get("BALLISTA_FAULTS", "").strip()
            _rules = parse_spec(spec) or None if spec else None
            _loaded = True
            if _rules:
                log.warning("fault injection ARMED: %s",
                            {p: vars_str(r) for p, r in _rules.items()})
        return _rules


def vars_str(rule: _Rule) -> str:
    if rule.every:
        sched = f"every:{rule.every}"
    else:
        sched = f"once:{rule.nth or 1}"
    extra = f" {rule.delay_ms}ms" if rule.action == "delay" else ""
    return f"{rule.action}-{sched}{extra}"


def reload_faults() -> None:
    """Re-read BALLISTA_FAULTS and reset every hit counter (tests call
    this after mutating the env; deterministic sweeps call it between
    seeds)."""
    global _loaded
    with _load_lock:
        _loaded = False
    _load()


def faults_armed() -> bool:
    return _load() is not None


def fault_point(name: str, **ctx) -> Optional[str]:
    """Declare a fault point. No-op (returns None) unless
    ``BALLISTA_FAULTS`` arms ``name``; a triggered ``fail`` raises
    :class:`FaultInjected`, ``delay`` sleeps then returns "delay", and
    ``drop`` returns "drop" for the caller to act on (callers without
    drop semantics ignore the return value). ``ctx`` is logged with
    the injection for debuggability."""
    rules = _rules if _loaded else _load()
    if rules is None:
        return None
    rule = rules.get(name)
    if rule is None:
        return None
    action = rule.fire()
    if action is None:
        return None
    log.warning("fault injected at %s (%s, hit %d) %s", name,
                vars_str(rule), rule.hits, ctx or "")
    if action == "fail":
        raise FaultInjected(
            f"injected fault at {name} (hit {rule.hits})")
    return action
