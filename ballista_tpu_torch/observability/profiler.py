"""Query profiler: one reproducible artifact per query.

The ROADMAP's execute-mass decomposition (q5 fresh-process: ~1.9s parse
+ ~0.2s H2D + ~1.8s compile retrieval + ~13s execute, of which ~5.8s
blocked on device results, ~4.6s jit trace/lower, ~2.9s host dictionary
/ numpy work) was established by ad-hoc profiling. This module makes
that decomposition a first-class output: a :class:`Profiler` session
captures, for the window of one query,

- every trace span (tracing is force-enabled into a private file for
  the session when not already on) — ingest producer threads, compile
  activity, blocking device syncs, host dictionary work, scheduler /
  executor / dataplane events;
- the ingest phase totals delta (``parse`` / ``h2d``);
- the compile governor stats delta (backend compiles, compile seconds,
  trace seconds, persistent-cache hits);
- the memory snapshot (tracked host bytes by category, device bytes,
  peaks, RSS);
- per-operator ``MetricsSet`` values off the executed physical plan,

and ``export.py`` merges them into ONE Chrome-trace/Perfetto-compatible
JSON artifact with named lane attribution. Entry points:
``DataFrame.profile()`` (standalone) and ``BALLISTA_PROFILE=<dir>``
(every standalone ``collect()`` writes an artifact into the directory).
The CLUSTER path does not use this window class: executors ship
per-task span windows with ``CompletedTask`` and the scheduler merges
them per job (``observability/distributed.py``), so the same env var /
``df.profile()`` surface works identically there.

One window per process: overlapping profilers are refused
(:class:`ProfilerBusy`; the ambient path degrades the loser to an
unprofiled run). The tracer itself stays process-global, though — if
OTHER queries run concurrently with an active window, their spans land
in the window's trace too and inflate its lanes. Profile on a quiet
process when lane precision matters; the per-record ``tid``/flow attrs
in ``traceEvents`` let a reader separate the interleaved work after
the fact.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Optional

from . import memory as obs_memory
from . import tracing
from .export import COMPILE_STATS

# One profiling window per process: start/stop mutate os.environ and the
# shared tracer, so two overlapping windows would cross-write each
# other's trace files and fight over the env restore. The lock makes
# activation atomic; losers of the race run unprofiled (ambient) or
# raise (explicit df.profile()).
_active_lock = threading.Lock()
_ACTIVE = False


class ProfilerBusy(RuntimeError):
    """Another profiling window is already active in this process."""


def _try_activate() -> bool:
    global _ACTIVE
    with _active_lock:
        if _ACTIVE:
            return False
        _ACTIVE = True
        return True


def _deactivate() -> None:
    global _ACTIVE
    with _active_lock:
        _ACTIVE = False


def profile_dir() -> Optional[str]:
    """The ``BALLISTA_PROFILE`` artifact directory, or None when the
    ambient profiler is off. ``BALLISTA_PROFILE=1`` means the current
    working directory."""
    v = os.environ.get("BALLISTA_PROFILE", "")
    if not v or v.lower() in ("0", "off", "false"):
        return None
    if v.lower() in ("1", "on", "true"):
        return os.getcwd()
    return v


def plan_digest(plan, n: int = 12) -> str:
    """Stable short digest of a logical plan's pretty-printed form —
    ONE format for every surface (artifact labels, slow-query
    summaries, scheduler job digests), so a digest seen in
    ``/debug/queries`` greps straight into artifact filenames."""
    import hashlib

    return hashlib.sha1(plan.pretty().encode()).hexdigest()[:n]


class Profiler:
    """One profiling window. Usage::

        prof = Profiler(label="q5")
        prof.start()
        ... run the query ...
        session = prof.stop(plan=phys)
        path = export.write_artifact(session, out_dir)
    """

    def __init__(self, label: str = "query"):
        self.label = label
        self._own_trace = False
        self._saved_env: dict = {}
        self._trace_file: Optional[str] = None
        self._t0 = None
        self._phases0: dict = {}
        self._compile0: dict = {}
        self._trace_offset = 0

    def start(self) -> "Profiler":
        from ..compile import compile_stats
        from ..ingest import phase_totals

        if not _try_activate():
            raise ProfilerBusy("another profiling window is active")
        try:
            self._start_inner(compile_stats, phase_totals)
        except BaseException:
            # a failed setup must not leave the process looking
            # permanently "profiling" (that would silently disable
            # ambient BALLISTA_PROFILE forever)
            _deactivate()
            raise
        return self

    def _start_inner(self, compile_stats, phase_totals) -> None:
        if not tracing.trace_enabled():
            # force tracing into a private file for this window only;
            # restore the user's env on stop
            self._own_trace = True
            fd, path = tempfile.mkstemp(prefix="ballista-profile-",
                                        suffix=".jsonl")
            os.close(fd)
            self._trace_file = path
            for k in ("BALLISTA_TRACE", "BALLISTA_TRACE_FILE",
                      "BALLISTA_TRACE_TRUNCATE", "BALLISTA_TRACE_MAX_MB"):
                self._saved_env[k] = os.environ.get(k)
            os.environ["BALLISTA_TRACE"] = "1"
            os.environ["BALLISTA_TRACE_FILE"] = path
            os.environ["BALLISTA_TRACE_TRUNCATE"] = "1"
            # the user's hygiene cap is for THEIR long-lived trace file;
            # a capped private window would silently drop spans and
            # under-report every lane
            os.environ["BALLISTA_TRACE_MAX_MB"] = "0"
            tracing.reconfigure()
        else:
            self._trace_file = tracing.trace_path()
            try:
                self._trace_offset = os.path.getsize(self._trace_file)
            except OSError:
                self._trace_offset = 0
        # NOTE: the process-wide memory peaks are NOT reset here — the
        # health plane, heartbeats and bench.py report them as lifetime
        # trajectories, and an ambient profiler window clobbering them
        # would make those under-report. The artifact's memory section
        # is a snapshot taken at stop() (peaks = process lifetime).
        self._phases0 = phase_totals()
        self._compile0 = compile_stats()
        self._t0 = time.time()

    def stop(self, plan=None) -> dict:
        """End the window; returns the session dict ``export`` consumes.
        ``plan`` (the executed physical plan) supplies per-operator
        metrics when given."""
        from ..compile import compile_stats
        from ..ingest import phase_totals

        try:
            wall = time.time() - self._t0
            phases1 = phase_totals()
            compile1 = compile_stats()
            records = self._read_trace()
            if self._own_trace:
                for k, v in self._saved_env.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
                tracing.reconfigure()
                try:
                    os.unlink(self._trace_file)
                except OSError:
                    pass
        finally:
            _deactivate()

        phase_delta = {
            k: round(phases1.get(k, 0.0) - self._phases0.get(k, 0.0), 6)
            for k in set(phases1) | set(self._phases0)
        }
        compile_delta = {
            k: (round(compile1[k] - self._compile0.get(k, 0), 6)
                if isinstance(compile1[k], float)
                else compile1[k] - self._compile0.get(k, 0))
            for k in COMPILE_STATS
            if k in compile1
        }
        operators = None
        if plan is not None:
            try:
                from .metrics import collect_plan_metrics

                operators = collect_plan_metrics(plan)
            except Exception:  # noqa: BLE001 - artifact still useful
                operators = None
        return {
            "schema": "ballista-profile-v1",
            "label": self.label,
            "t0": self._t0,
            "wall_seconds": round(wall, 6),
            "phases": phase_delta,
            "compile": compile_delta,
            "memory": obs_memory.memory_snapshot(),
            "operators": operators,
            "records": records,
        }

    def _read_trace(self) -> list:
        """Trace records emitted during the window (other processes
        write their own files; a standalone query is single-process)."""
        if not self._trace_file:
            return []
        out = []
        try:
            with open(self._trace_file) as fh:
                fh.seek(self._trace_offset)
                for line in fh:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    # keep records that OVERLAP the window (a span that
                    # started before .start() but ended inside still
                    # holds wall time of this query)
                    end = rec.get("ts", 0.0) + rec.get("dur", 0.0)
                    if end >= self._t0 - 1e-6:
                        out.append(rec)
        except OSError:
            return []
        return out


def profiling_active() -> bool:
    return _ACTIVE


def profile_call(fn, label: str = "query", plan_getter=None,
                 out_dir: Optional[str] = None,
                 out_path: Optional[str] = None,
                 busy_ok: bool = False):
    """Run ``fn()`` under a profiler and write the artifact. Returns
    ``(fn result, artifact path)``. ``plan_getter()`` is called after
    ``fn`` to fetch the executed physical plan (it may not exist until
    the query ran). With ``busy_ok`` a concurrent profiling window
    degrades this call to an unprofiled ``fn()`` (path None) instead of
    raising :class:`ProfilerBusy` — the ambient-BALLISTA_PROFILE path
    uses that so racing collects never corrupt each other's windows."""
    from . import export

    prof = Profiler(label=label)
    try:
        prof.start()
    except ProfilerBusy:
        if busy_ok:
            return fn(), None
        raise
    except Exception:
        if busy_ok:
            # ambient mode: ANY profiler setup failure (unwritable
            # TMPDIR, tracer trouble) degrades to an unprofiled run —
            # a broken observability knob must not abort the query
            import logging

            logging.getLogger("ballista.profiler").exception(
                "profiler setup failed; running unprofiled")
            return fn(), None
        raise
    try:
        result = fn()
    finally:
        plan = plan_getter() if plan_getter is not None else None
        session = prof.stop(plan=plan)
    path = export.write_artifact(session, out_dir=out_dir,
                                 out_path=out_path)
    return result, path
