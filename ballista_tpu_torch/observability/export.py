"""Profile artifact export: Chrome-trace/Perfetto JSON + lane summary.

One artifact file serves two readers:

- **chrome://tracing / Perfetto** load it directly: the top-level
  object carries a ``traceEvents`` array (Complete ``"X"`` / Instant
  ``"i"`` / Metadata ``"M"`` events, microsecond timestamps) and both
  tools ignore the extra keys.
- **Programs / humans** read the summary keys: ``wall_seconds``,
  ``lanes`` (the named wall-time decomposition), ``phases``,
  ``compile``, ``memory``, ``operators``.

Lane semantics (``lanes`` + ``lane_fractions``): measured categories
are THREAD seconds summed from their spans — under the ingest pipeline
they overlap, so their sum may legitimately exceed wall time —

- ``parse`` / ``h2d``: ingest phase totals (file parse, host->device);
- ``compile_trace_lower``: governed first-call time, the
  ``call_seconds`` of ``compile.capture`` records (the port's governor,
  ``compile/governor.py``): on a card the warm-up call plus the CUDA
  graph capture that follows it, on the CPU the governed first call
  (eager), as the JAX package counts the ``call_seconds`` of a
  ``compile.jit`` record; without records, the governor's
  ``first_call_seconds`` delta. The ledger's ``compile`` phase is the
  same delta (``systables.py``, ``distributed.py``);
- ``device_blocked``: host time blocked on device results
  (``device.block`` spans: batched count syncs, result fetches, join
  builds);
- ``host_dictionary``: host-side numpy dictionary work
  (``host.dictionary`` spans: unify/remap/union builds);
- ``xla_execute_other``: the remainder of the wall clock after the
  measured categories (clamped at 0) — on this engine dominated by XLA
  execution and dispatch, hence the name.

``attributed_fraction`` is the fraction of wall time covered by the
MEASURED lanes (the remainder lane deliberately excluded — including a
lane defined as "whatever is left" would make the metric identically
1.0 and meaningless). 1.0 means every wall second was inside an
instrumented category; a low value means the ``xla_execute_other``
remainder carries most of the attribution and should be read as "XLA
execute + uninstrumented host work". Overlapped thread-seconds beyond
the wall clock don't raise it past 1.0.

**Merged (distributed) sessions** — built by
``observability/distributed.py`` from the scheduler's flight-recorder
window plus every executor's per-task profile payload — flow through
the same exporter: records carry process identity (``role`` / ``exec``
tags), so each distinct (pid, role, executor) gets its OWN process
track (synthetic display pids keep an in-process LocalCluster's
scheduler and executors on separate tracks despite one OS pid); a
``scheduler.task_dispatch`` span and its matching ``executor.task``
span are connected with Chrome-trace flow arrows (``ph:"s"``/``"f"``);
and a synthetic "job timeline" process renders a stage/task Gantt lane.
Merged sessions carry no process-wide ingest phase deltas (concurrent
tasks would cross-attribute them), so the parse/h2d lanes fall back to
summing ``ingest.parse``/``ingest.h2d`` span durations.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

LANE_NAMES = ("parse", "h2d", "compile_trace_lower", "device_blocked",
              "host_dictionary", "shuffle_spill", "xla_execute_other")

# Span name -> lane, the declarative face of compute_lanes below (which
# also folds in phase-delta fallbacks and attr-based compile sums). The
# lane-coverage analysis pass reads this map + ledger.LEDGER_SPANS to
# flag span names that NO attribution surface maps — keep it in sync
# with the span names compute_lanes consumes.
LANE_SPANS = {
    "ingest.parse": "parse",
    "ingest.h2d": "h2d",
    "compile.capture": "compile_trace_lower",
    "device.block": "device_blocked",
    "host.dictionary": "host_dictionary",
    "shuffle.spill": "shuffle_spill",
}

# The governor's compile record and the compile_stats() keys the
# profile artifacts, task profiles and ledgers carry as their "compile"
# delta (compile/governor.py::_STATS). COMPILE_SECONDS is the one that
# counts as compile time.
COMPILE_SPAN = "compile.capture"
COMPILE_SECONDS = "first_call_seconds"
COMPILE_STATS = ("programs_built", "graph_captures", "capture_seconds",
                 COMPILE_SECONDS)


def compute_lanes(session: dict) -> dict:
    """The named wall-time decomposition (see module docstring)."""
    wall = float(session.get("wall_seconds", 0.0))
    phases = session.get("phases") or {}
    records = session.get("records") or []

    def span_sum(name: str, field: str = "dur") -> float:
        return float(sum(float(r.get(field, 0.0)) for r in records
                         if r.get("name") == name))

    # merged cluster sessions ship no process-wide phase deltas
    # (concurrent tasks would cross-attribute them): fall back to the
    # ingest span durations, which phases.py emits from the same blocks
    parse = float(phases.get("parse", 0.0)) or span_sum("ingest.parse")
    h2d = float(phases.get("h2d", 0.0)) or span_sum("ingest.h2d")
    lanes = {
        "parse": round(parse, 6),
        "h2d": round(h2d, 6),
        "device_blocked": round(span_sum("device.block"), 6),
        "host_dictionary": round(span_sum("host.dictionary"), 6),
        # disk time the shuffle governor's spill writes/re-reads add
        # (distributed/spill.py) — zero unless the memory budget forced
        # chunks to disk
        "shuffle_spill": round(span_sum("shuffle.spill"), 6),
    }
    compile_lane = sum(float(r.get("call_seconds", 0.0)) for r in records
                       if r.get("name") == COMPILE_SPAN)
    if compile_lane == 0.0:
        # no compile.capture records (tracing came up late): fall back
        # to the governor's process-stat delta
        comp = session.get("compile") or {}
        compile_lane = float(comp.get(COMPILE_SECONDS, 0.0))
    lanes["compile_trace_lower"] = round(compile_lane, 6)
    measured = sum(lanes.values())
    lanes["xla_execute_other"] = round(max(0.0, wall - measured), 6)
    out = {
        "lanes": lanes,
        "measured_seconds": round(measured, 6),
        "attributed_fraction": (round(min(1.0, measured / wall), 4)
                                if wall > 0 else 0.0),
    }
    if wall > 0:
        out["lane_fractions"] = {
            k: round(v / wall, 4) for k, v in lanes.items()
        }
    return out


def _process_key(r: dict) -> tuple:
    """Track identity of a record: OS pid alone is NOT enough — an
    in-process LocalCluster runs the scheduler and every executor under
    one pid, and their records are separated by the ``role``/``exec``
    tags process identity / per-task window extraction stamped on."""
    return (r.get("pid", 0), r.get("role", ""), r.get("exec", ""))


def _process_tracks(records: List[dict]) -> Dict[tuple, tuple]:
    """process key -> (display pid, label). Display pids are synthetic
    small ints (scheduler first, then executors by id) so two identities
    sharing an OS pid still render as distinct Perfetto process
    tracks; the real pid stays in the label."""
    keys: List[tuple] = []
    for r in records:
        k = _process_key(r)
        if k not in keys:
            keys.append(k)

    def order(k):
        pid, role, ex = k
        rank = {"scheduler": 0, "executor": 1}.get(role, 2)
        return (rank, ex, pid)

    keys.sort(key=order)
    out: Dict[tuple, tuple] = {}
    for i, k in enumerate(keys):
        pid, role, ex = k
        if role == "scheduler":
            label = f"scheduler (pid {pid})"
        elif role == "executor":
            label = f"executor {ex or '?'} (pid {pid})"
        else:
            label = f"ballista pid {pid}"
        out[k] = (i + 1, label)
    return out


def _thread_names(records: List[dict], main_tid: int) -> Dict[tuple, str]:
    """(process key, tid) -> display name: ingest producer threads and
    executor task threads get their own labels (their spans are what
    makes the overlap visible)."""
    names: Dict[tuple, str] = {}
    producer_n: Dict[tuple, int] = {}
    task_n: Dict[tuple, int] = {}
    for r in records:
        pkey = _process_key(r)
        key = (pkey, r.get("tid", 0))
        if key in names:
            continue
        name = r.get("name", "")
        if name.startswith("ingest.") and r.get("tid") != main_tid:
            n = producer_n.get(pkey, 0)
            producer_n[pkey] = n + 1
            names[key] = f"ingest-producer-{n}"
        elif name == "executor.task":
            n = task_n.get(pkey, 0)
            task_n[pkey] = n + 1
            names[key] = f"task-worker-{n}"
    for r in records:
        key = (_process_key(r), r.get("tid", 0))
        if key not in names:
            names[key] = "main" if r.get("tid") == main_tid \
                else f"worker-{len(names)}"
    return names


_META_KEYS = ("name", "ts", "dur", "pid", "tid")


def _rel_us(ts: float, t0: float) -> float:
    return round((float(ts) - t0) * 1e6, 1)


def _flow_events(records: List[dict], tracks: Dict[tuple, tuple],
                 t0: float) -> List[dict]:
    """Chrome-trace flow arrows from each ``scheduler.task_dispatch``
    span into the matching ``executor.task`` span (paired on the task
    key). The start binds mid-dispatch and the finish binds just inside
    the task slice so both attach to real slices in Perfetto."""
    dispatches = {}
    for r in records:
        if r.get("name") == "scheduler.task_dispatch" and "dur" in r \
                and r.get("task"):
            dispatches[r["task"]] = r
    out: List[dict] = []
    n = 0
    for r in records:
        if r.get("name") != "executor.task" or "dur" not in r:
            continue
        d = dispatches.get(r.get("task"))
        if d is None:
            continue
        n += 1
        out.append({
            "ph": "s", "cat": "taskflow", "name": "task_dispatch",
            "id": n, "pid": tracks[_process_key(d)][0],
            "tid": d.get("tid", 0),
            "ts": _rel_us(float(d["ts"]) + float(d["dur"]) / 2, t0),
        })
        out.append({
            "ph": "f", "bp": "e", "cat": "taskflow",
            "name": "task_dispatch", "id": n,
            "pid": tracks[_process_key(r)][0], "tid": r.get("tid", 0),
            "ts": _rel_us(float(r["ts"]) + min(float(r["dur"]) / 2,
                                               1e-4), t0),
        })
    return out


_GANTT_PID = 0  # synthetic process; real tracks start at display pid 1


def _gantt_events(records: List[dict], t0: float) -> List[dict]:
    """Synthetic "job timeline" process: one thread per stage, one slice
    per executor task — the job's stage/task Gantt chart."""
    tasks = [r for r in records
             if r.get("name") == "executor.task" and "dur" in r]
    if not tasks:
        return []
    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": _GANTT_PID, "tid": 0,
         "args": {"name": "job timeline (stage/task gantt)"}},
        {"ph": "M", "name": "process_sort_index", "pid": _GANTT_PID,
         "tid": 0, "args": {"sort_index": -1}},
    ]
    seen_stages = set()
    for r in tasks:
        try:
            stage = int(r.get("stage", 0))
        except (TypeError, ValueError):
            stage = 0
        if stage not in seen_stages:
            seen_stages.add(stage)
            events.append({"ph": "M", "name": "thread_name",
                           "pid": _GANTT_PID, "tid": stage,
                           "args": {"name": f"stage {stage}"}})
        events.append({
            "ph": "X", "cat": "gantt",
            "name": f"task {r.get('task', '?')}",
            "pid": _GANTT_PID, "tid": stage,
            "ts": _rel_us(r["ts"], t0),
            "dur": round(float(r["dur"]) * 1e6, 1),
            "args": {"executor": r.get("exec")
                     or r.get("executor", "")},
        })
    return events


def to_chrome_trace(session: dict, main_tid: Optional[int] = None) -> list:
    """Session records -> Chrome trace event array."""
    records = session.get("records") or []
    t0 = float(session.get("t0", 0.0))
    if main_tid is None:
        main_tid = threading.get_ident()
    tracks = _process_tracks(records)
    events: List[dict] = []
    for (pid, label) in tracks.values():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        events.append({"ph": "M", "name": "process_sort_index",
                       "pid": pid, "tid": 0,
                       "args": {"sort_index": pid}})
    for (pkey, tid), tname in _thread_names(records, main_tid).items():
        events.append({"ph": "M", "name": "thread_name",
                       "pid": tracks[pkey][0], "tid": tid,
                       "args": {"name": tname}})
    for r in records:
        args = {k: v for k, v in r.items() if k not in _META_KEYS}
        ev = {
            "name": r.get("name", "?"),
            "cat": str(r.get("name", "?")).split(".")[0],
            "pid": tracks[_process_key(r)][0],
            "tid": r.get("tid", 0),
            "ts": _rel_us(r.get("ts", t0), t0),
            "args": args,
        }
        if "dur" in r:
            ev["ph"] = "X"
            ev["dur"] = round(float(r["dur"]) * 1e6, 1)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
    events.extend(_flow_events(records, tracks, t0))
    events.extend(_gantt_events(records, t0))
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    return events


def build_artifact(session: dict) -> dict:
    """Merge a profiler session into the final artifact dict."""
    art = {
        "schema": session.get("schema", "ballista-profile-v1"),
        "label": session.get("label", "query"),
        "wall_seconds": session.get("wall_seconds", 0.0),
        "phases": session.get("phases", {}),
        "compile": session.get("compile", {}),
        "memory": session.get("memory", {}),
        "operators": session.get("operators"),
        "displayTimeUnit": "ms",
        "traceEvents": to_chrome_trace(session),
    }
    if session.get("distributed"):
        # merged cluster artifact: which processes contributed
        art["distributed"] = session["distributed"]
    if session.get("flight_recorder"):
        # retroactive dump: the records came from the ring, not a
        # profiled window — spans older than the ring bound are absent
        art["flight_recorder"] = True
    art.update(compute_lanes(session))
    art["otherData"] = {
        "label": art["label"],
        "wall_seconds": art["wall_seconds"],
        "attributed_fraction": art["attributed_fraction"],
    }
    return art


def write_artifact_file(art: dict, out_dir: Optional[str] = None,
                        out_path: Optional[str] = None) -> str:
    """Write an already-built artifact dict; returns its path.
    ``out_path`` pins the exact file, otherwise a timestamped name
    derived from the artifact label lands in ``out_dir`` (default:
    cwd). The single naming/IO path for every artifact writer —
    standalone profiler, scheduler merge, remote df.profile()."""
    if out_path is None:
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in str(art.get("label", "query")))[:48] \
            or "query"
        fname = f"ballista-profile-{safe}-{int(time.time() * 1000)}.json"
        out_path = os.path.join(out_dir or os.getcwd(), fname)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(art, fh, default=str)
    return out_path


def write_artifact(session: dict, out_dir: Optional[str] = None,
                   out_path: Optional[str] = None) -> str:
    """Build + write a profiler session's artifact; returns its path."""
    return write_artifact_file(build_artifact(session), out_dir=out_dir,
                               out_path=out_path)
