"""SQL-queryable ``system.*`` tables + the durable query-history log.

(The JAX package's module, ported: a system source makes its batches on
a torch device, the executor's for a shipped plan, and the standalone
``system.executors`` row counts this process's cards.)

Every telemetry surface the engine grew (per-operator
MetricsSet, profiler lane decomposition, Prometheus families,
``/debug/queries``) was a side channel: an HTTP endpoint, a JSON
artifact, a bench line. This module dogfoods the engine instead — its
own telemetry becomes relational tables served by the engine itself:

- ``system.queries``   — recent queries (bounded ring) + the durable
  on-disk history (``BALLISTA_QUERY_LOG_DIR``): job id, plan digest,
  status, wall seconds, output rows, peak memory, profile artifact.
- ``system.query_lanes`` — one row per query x named wall-time lane
  (the profiler's decomposition: parse / h2d / compile_trace_lower /
  device_blocked / host_dictionary / xla_execute_other).
- ``system.operators`` — per-operator MetricsSet rows of the last N
  queries, long format (one row per operator x metric).
- ``system.compile``   — compile-governor entries: signature, calls,
  compiles, elapsed compile seconds, persistent-cache hits, AOT loads.
- ``system.cache``     — warm-path serving caches (docs/caching.md):
  one row per device-resident table entry / host result-cache entry.
- ``system.executors`` — executor heartbeat resources (cluster) or one
  row for the current process (standalone).
- ``system.settings``  — every ``BALLISTA_*`` knob: effective value,
  default, source, description (the registry ``dev/check_knob_docs.py``
  lints against the source tree and the README knob table).

ONE snapshot layer feeds every surface: the query records built by
:func:`build_query_record` are what ``/debug/queries`` serves (via
``health.QueryLog``), what the history log persists, and what
``system.queries`` scans materialize — so the surfaces cannot drift.
System tables are ordinary plans (a :class:`SystemTableSource` scan),
so EXPLAIN / EXPLAIN ANALYZE, whole-stage fusion and the profiler all
apply to them for free.

Standalone vs cluster semantics: a standalone context scans the
CURRENT PROCESS's snapshot; a remote context fetches rows from the
SCHEDULER (``GetSystemTable`` RPC) at scan/ship time, so
``system.executors`` / ``system.queries`` reflect the whole cluster,
not the client process.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from ..datatypes import Float64, Int64, Schema, Utf8, schema as make_schema
from ..logical import TableSource

# ---------------------------------------------------------------------------
# Knob registry (system.settings + dev/check_knob_docs.py)
# ---------------------------------------------------------------------------

# name -> (default as the docs state it, description). The single
# source of truth for BALLISTA_* env knobs: dev/check_knob_docs.py
# fails tier-1 when a knob read in the source is missing here (or from
# the README knob table), and vice versa.
KNOBS: Dict[str, tuple] = {
    # compile governor / shape bucketing (docs/compile_cache.md)
    "BALLISTA_SHAPE_BUCKETS": ("on", "quantize batch capacities onto the "
                                     "canonical geometric ladder"),
    "BALLISTA_SHAPE_BUCKETS_FLOOR": ("1024", "smallest ladder rung"),
    "BALLISTA_SHAPE_BUCKETS_GROWTH": ("2", "geometric ladder step"),
    "BALLISTA_FUSION": ("on", "whole-stage fusion: one governed XLA "
                              "program per pipeline stage"),
    "BALLISTA_FUSION_AOT_DIR": ("off", "read, but the port writes and "
                                       "loads nothing there (a CUDA "
                                       "graph does not outlive its "
                                       "process)"),
    "BALLISTA_PREWARM": ("off", "warm-up and capture fused stages "
                                "concurrently with parse/H2D (a stage "
                                "over utf8 columns: warm-up only)"),
    "BALLISTA_XLA_CACHE": ("~/.cache/ballista-tpu-xla-<cpu-tag>",
                           "persistent XLA compilation cache dir "
                           "(empty = disabled)"),
    "BALLISTA_XLA_CACHE_MIN_COMPILE_SECS": ("0", "only disk-cache kernels "
                                                 "compiling at least this "
                                                 "long"),
    "BALLISTA_JIT_CACHE_ENTRIES": ("1024", "per-namespace LRU bound on "
                                           "governed jit entries"),
    "BALLISTA_JIT_TRACES_PER_ENTRY": ("128", "clear an entry's in-memory "
                                             "trace cache past this many "
                                             "specializations"),
    # ingest (docs/ingest.md)
    "BALLISTA_INGEST_THREADS": ("min(cpu_count, 8)", "shared ingest pool "
                                                     "width"),
    "BALLISTA_PREFETCH_BATCHES": ("2", "per-scan bounded prefetch depth "
                                       "(0 = serial pull loop)"),
    "BALLISTA_SCAN_THREADS": ("cpu count", "native C++ scanner threads "
                                           "within one file"),
    "BALLISTA_SCAN_CHUNK_BYTES": ("1073741824", "text scan chunk size"),
    # kernels / execution
    "BALLISTA_DICT_REGISTRY": ("on", "process-wide dictionary registry: "
                                     "interned string dictionaries, "
                                     "cached integer remaps, epoch-keyed "
                                     "AOT artifacts (off = legacy "
                                     "object-array unify/remap; "
                                     "docs/strings.md)"),
    "BALLISTA_PALLAS": ("off", "force the Pallas dense-aggregation kernel "
                               "(off/on/interpret)"),
    "BALLISTA_JOIN_SWAP": ("on", "planner may swap join build/probe sides "
                                 "by estimated size"),
    "BALLISTA_JOIN_SYNC_WINDOW": ("8", "deferred-sync join build window "
                                       "(batches)"),
    "BALLISTA_JOIN_SYNC_WINDOW_BYTES": ("1073741824", "deferred-sync join "
                                                      "build window cap "
                                                      "(bytes)"),
    "BALLISTA_NARROW_WIRE": ("auto", "narrow integer wire encoding for "
                                     "shuffle IPC"),
    "BALLISTA_ALLOW_MIMALLOC": ("off", "skip the jemalloc pool guard for "
                                       "pyarrow"),
    # distributed / streaming shuffle (docs/shuffle.md)
    "BALLISTA_NATIVE_DATAPLANE": ("on", "serve shuffle partitions from the "
                                        "native C++ daemon (off = Python)"),
    "BALLISTA_SHUFFLE_CHUNK_BYTES": ("4194304", "max Arrow-IPC record-"
                                                "batch / wire-frame size "
                                                "on the shuffle path"),
    "BALLISTA_SHUFFLE_MEM_BUDGET": ("268435456", "per-process cap on "
                                                 "in-flight shuffle "
                                                 "buffer bytes"),
    "BALLISTA_SHUFFLE_SPILL_WATERMARK": ("0.8", "budget fraction past "
                                                "which fetched chunks "
                                                "divert to disk"),
    "BALLISTA_SHUFFLE_SPILL_DIR": ("tempdir/ballista-spill-<pid>",
                                   "directory for size-rotated spill "
                                   "segments"),
    "BALLISTA_SHUFFLE_SPILL_FILE_MB": ("64", "spill segment rotation "
                                             "size"),
    "BALLISTA_SHUFFLE_WINDOW_BYTES": ("4x chunk bytes", "flow-control "
                                                        "window: max "
                                                        "unacked in-"
                                                        "flight bytes "
                                                        "per peer "
                                                        "stream"),
    "BALLISTA_MESH_GROUP_ACK_TIMEOUT": ("3600", "multi-process mesh group "
                                                "broadcast ack timeout "
                                                "(seconds)"),
    # observability (docs/observability.md)
    "BALLISTA_METRICS": ("on", "per-operator MetricsSet collection "
                               "(EXPLAIN ANALYZE forces it back on)"),
    "BALLISTA_METRICS_PORT": ("off", "health plane port (0 = ephemeral, "
                                     "-1 = off)"),
    "BALLISTA_TRACE": ("off", "span tracing to a JSON-lines file"),
    "BALLISTA_TRACE_FILE": ("auto", "pin the exact trace file path"),
    "BALLISTA_TRACE_DIR": ("tempdir", "directory for per-process trace "
                                      "files"),
    "BALLISTA_TRACE_TRUNCATE": ("off", "open the trace file fresh instead "
                                       "of appending"),
    "BALLISTA_TRACE_MAX_MB": ("unbounded", "cap the trace file size"),
    "BALLISTA_FLIGHT_RECORDER": ("on", "always-on bounded in-memory ring "
                                       "of recent spans"),
    "BALLISTA_FLIGHT_RECORDER_SPANS": ("4096", "flight-recorder ring "
                                               "capacity"),
    "BALLISTA_PROFILE": ("off", "write one Chrome-trace profile artifact "
                                "per query into this directory"),
    "BALLISTA_TASK_PROFILE": ("on", "executors ship per-task profile "
                                    "windows with CompletedTask"),
    "BALLISTA_SLOW_QUERY_SECS": ("off", "slow-query threshold: ring entry "
                                        "+ retroactive profile artifact"),
    "BALLISTA_SLOW_QUERY_DIR": ("profile dir, else tempdir",
                                "where retroactive slow-query artifacts "
                                "land"),
    "BALLISTA_SLOW_QUERY_MAX_ARTIFACTS": ("32", "retained slow-query "
                                                "dumps per directory; "
                                                "oldest deleted past the "
                                                "cap (0 = unbounded)"),
    "BALLISTA_LEDGER": ("on", "always-on per-query latency ledger: phase "
                              "attribution into system.latency + "
                              "ballista_latency_* SLO histograms with "
                              "exemplars"),
    "BALLISTA_LEDGER_LOG": ("256", "recent query ledgers retained per "
                                   "process (system.latency window)"),
    "BALLISTA_QUERY_LOG_DIR": ("off", "durable query-history log "
                                      "directory (JSON lines, size-capped "
                                      "rotation; feeds system.queries "
                                      "across restarts)"),
    "BALLISTA_QUERY_LOG_MAX_MB": ("16", "rotate the query-history log "
                                        "past this size (one rotated "
                                        "segment is kept)"),
    # live progress & session metering plane (docs/observability.md)
    "BALLISTA_PROGRESS_INTERVAL_SECS": ("1.0", "cadence of executor "
                                               "TaskProgress piggybacks "
                                               "and ambient standalone "
                                               "sampling (0/off disables "
                                               "the plane)"),
    "BALLISTA_EXECUTOR_STALE_SECS": ("15", "heartbeat age past which "
                                           "system.executors marks a row "
                                           "stale=true"),
    # query lifecycle control plane (docs/robustness.md)
    "BALLISTA_SLOW_QUERY_KILL_SECS": ("off", "upgrade the slow-query log "
                                             "to a KILL: cancel queries "
                                             "running longer than this "
                                             "(both paths)"),
    "BALLISTA_CANCEL_ON_TIMEOUT": ("on", "a client-side job timeout "
                                         "issues a best-effort CancelJob "
                                         "before raising (off = old "
                                         "abandon-the-job behavior)"),
    "BALLISTA_DRAIN_TIMEOUT_SECS": ("20", "graceful drain bound: "
                                          "in-flight tasks get this long "
                                          "to finish before being "
                                          "cancelled"),
    "BALLISTA_FAULTS": ("off", "deterministic fault injection spec "
                               "(point=trigger[;...]; see "
                               "docs/robustness.md)"),
    "BALLISTA_POLL_BACKOFF_MAX_SECS": ("8", "executor poll-loop backoff "
                                            "ceiling while the scheduler "
                                            "is unreachable"),
    "BALLISTA_MAX_TASK_RECOVERIES": ("3", "recovery events allowed per "
                                          "job (transient retry, fetch "
                                          "recovery, lease reap) before "
                                          "the job fails"),
    "BALLISTA_SPECULATION_LAG_FACTOR": ("3.0", "duplicate a running task "
                                               "when its sampled row rate "
                                               "x this factor trails the "
                                               "stage median (<=1 = age "
                                               "trigger only)"),
    "BALLISTA_ADMISSION_RETRY": ("on", "remote_collect honors admission "
                                       "shed retry-after (sleep + "
                                       "resubmit within the job "
                                       "timeout; off = raise "
                                       "immediately)"),
    "BALLISTA_CONTROLPLANE_COST_FEEDBACK": (
        "on", "planner consults persisted per-digest stage costs for "
              "initial partition counts and join strategy (off = "
              "static defaults; AQE still corrects mid-flight)"),
    "BALLISTA_CONTROLPLANE_COST_TARGET_PARTITION_BYTES": (
        "67108864", "cost feedback sizes shuffle partition counts so "
                    "each partition carries about this many observed "
                    "shuffle bytes"),
    # warm-path serving caches (docs/caching.md)
    "BALLISTA_TABLE_CACHE": ("on", "pin hot scan outputs device-resident "
                                   "across queries (parse + H2D skipped "
                                   "on repeat scans)"),
    "BALLISTA_TABLE_CACHE_BUDGET_MB": ("512", "device-memory budget for "
                                              "pinned table batches"),
    "BALLISTA_TABLE_CACHE_WATERMARK": ("0.9", "budget fraction past which "
                                              "fills evict coldest "
                                              "entries (never block)"),
    "BALLISTA_RESULT_CACHE": ("off", "plan-fingerprint result cache: "
                                     "repeat collects of an identical "
                                     "plan over unchanged inputs return "
                                     "host-cached rows"),
    "BALLISTA_RESULT_CACHE_BUDGET_MB": ("64", "host-memory budget for "
                                              "cached query results"),
    "BALLISTA_DONATION": ("on", "donate single-consumer intermediate "
                                "buffers into governed programs "
                                "(donate_argnums in-place reuse)"),
}

# dynamic env-name families: read via computed names, documented as
# patterns (the lint accepts any BALLISTA_* literal covered by one)
KNOB_PREFIXES: Dict[str, str] = {
    "BALLISTA_ADAPTIVE_": "adaptive.* setting fallbacks "
                          "(adaptive/config.py)",
    "BALLISTA_SCHEDULER_": "scheduler binary config overrides "
                           "(distributed/config.py)",
    "BALLISTA_EXECUTOR_": "executor binary config overrides "
                          "(distributed/config.py)",
    "BALLISTA_ADMISSION_": "admission.* setting fallbacks "
                           "(distributed/admission.py; quotas, "
                           "saturation bound, queue timeout — see "
                           "docs/robustness.md)",
    "BALLISTA_AUTOSCALE_": "autoscale.* setting fallbacks "
                           "(distributed/controlplane/autoscaler.py; "
                           "fleet bounds, backlog/ETA thresholds, "
                           "cooldown — see docs/robustness.md)",
    "BALLISTA_CONTROLPLANE_": "controlplane.* setting fallbacks "
                              "(distributed/controlplane/; cost "
                              "feedback — see docs/robustness.md)",
}


def settings_rows() -> List[dict]:
    """``system.settings``: one row per registered knob with its
    EFFECTIVE value (env wins over default), plus any set env var from
    the dynamic families."""
    rows = []
    for name, (default, desc) in sorted(KNOBS.items()):
        env = os.environ.get(name)
        rows.append({
            "name": name,
            "value": env if env is not None else default,
            "default": default,
            "source": "env" if env is not None else "default",
            "description": desc,
        })
    for prefix, desc in sorted(KNOB_PREFIXES.items()):
        for name in sorted(os.environ):
            if name.startswith(prefix) and name not in KNOBS:
                rows.append({
                    "name": name, "value": os.environ[name],
                    "default": "", "source": "env", "description": desc,
                })
    return rows


# ---------------------------------------------------------------------------
# Table schemas
# ---------------------------------------------------------------------------

SYSTEM_SCHEMAS: Dict[str, Schema] = {
    "system.queries": make_schema(
        ("job_id", Utf8), ("plan_digest", Utf8), ("status", Utf8),
        ("started_at", Float64), ("wall_seconds", Float64),
        ("output_rows", Int64), ("num_stages", Int64),
        ("peak_host_bytes", Int64), ("peak_device_bytes", Int64),
        ("profile_artifact", Utf8), ("error", Utf8),
        ("cancel_reason", Utf8), ("origin", Utf8),
        # admission plane: live 1-based queue position while a job is
        # held in the scheduler's admission queue (NULL otherwise)
        ("queue_position", Int64),
    ),
    "system.query_lanes": make_schema(
        ("job_id", Utf8), ("plan_digest", Utf8), ("lane", Utf8),
        ("seconds", Float64), ("fraction", Float64),
    ),
    "system.operators": make_schema(
        ("job_id", Utf8), ("plan_digest", Utf8), ("stage_id", Int64),
        ("op_index", Int64), ("operator", Utf8), ("depth", Int64),
        ("metric", Utf8), ("value", Float64),
    ),
    "system.compile": make_schema(
        ("namespace", Utf8), ("signature", Utf8), ("calls", Int64),
        ("compiles", Int64), ("compile_seconds", Float64),
        ("persistent_cache_hits", Int64), ("aot_loads", Int64),
    ),
    "system.executors": make_schema(
        ("executor_id", Utf8), ("host", Utf8), ("port", Int64),
        ("num_devices", Int64), ("rss_bytes", Int64),
        ("device_bytes", Int64), ("inflight_tasks", Int64),
        ("ingest_pool_depth", Int64), ("peak_host_bytes", Int64),
        # shuffle memory governor (distributed/spill.py): governed
        # in-flight shuffle buffer bytes + cumulative spill, per
        # heartbeat
        ("shuffle_inflight_bytes", Int64), ("spill_bytes_total", Int64),
        # live progress plane: scheduler-side clock minus the last
        # heartbeat; stale=1 past BALLISTA_EXECUTOR_STALE_SECS (or when
        # the executor never heartbeated this scheduler lifetime)
        ("heartbeat_age_seconds", Float64), ("stale", Int64),
    ),
    "system.settings": make_schema(
        ("name", Utf8), ("value", Utf8), ("default", Utf8),
        ("source", Utf8), ("description", Utf8),
    ),
    # live progress plane (observability/progress.py): running tasks,
    # per-stage completion fractions, cumulative per-session metering
    "system.tasks": make_schema(
        ("job_id", Utf8), ("stage_id", Int64), ("partition_id", Int64),
        ("executor_id", Utf8), ("operator", Utf8),
        ("rows_so_far", Int64), ("bytes_so_far", Int64),
        ("elapsed_seconds", Float64),
    ),
    "system.stages": make_schema(
        ("job_id", Utf8), ("stage_id", Int64), ("tasks_total", Int64),
        ("tasks_running", Int64), ("tasks_completed", Int64),
        ("fraction", Float64), ("eta_seconds", Float64),
        ("rows_so_far", Int64), ("bytes_so_far", Int64),
    ),
    "system.sessions": make_schema(
        ("session_id", Utf8), ("queries", Int64),
        ("wall_seconds", Float64), ("task_seconds", Float64),
        ("device_blocked_seconds", Float64), ("bytes_shuffled", Int64),
        ("peak_host_bytes", Int64), ("peak_device_bytes", Int64),
        # warm-path cache attribution (docs/caching.md): scans served
        # from the device table cache / collects served from the
        # result cache, accumulated per session
        ("table_cache_hits", Int64), ("result_cache_hits", Int64),
        ("started_at", Float64), ("last_active", Float64),
    ),
    # warm-path serving caches (cache/residency.py + cache/results.py):
    # one row per live entry across both tiers
    "system.cache": make_schema(
        ("tier", Utf8), ("entry", Utf8), ("bytes", Int64),
        ("hits", Int64), ("age_seconds", Float64),
        ("idle_seconds", Float64),
    ),
    # admission plane (distributed/admission.py): recent gate/pump
    # decisions — the scheduler's ring on the cluster path, empty
    # standalone (collects never pass an admission gate)
    "system.admission": make_schema(
        ("job_id", Utf8), ("session_id", Utf8), ("decision", Utf8),
        ("reason", Utf8), ("priority", Float64),
        ("cluster_load", Int64), ("queue_wait_seconds", Float64),
        ("retry_after_seconds", Float64), ("decided_at", Float64),
    ),
    # elastic control plane (distributed/controlplane/autoscaler.py):
    # recent scale-up/scale-down decisions — the scheduler's ring on
    # the cluster path, empty standalone or with the autoscaler off
    "system.autoscaler": make_schema(
        ("decided_at", Float64), ("action", Utf8), ("reason", Utf8),
        ("executors", Int64), ("target", Int64), ("backlog", Int64),
        ("inflight_tasks", Int64), ("eta_seconds", Float64),
        ("drained", Utf8),
    ),
    # latency ledger (observability/ledger.py): one row per recent
    # query per phase (plus an "unattributed" remainder row) — the
    # always-on SLO attribution surface
    "system.latency": make_schema(
        ("job_id", Utf8), ("origin", Utf8), ("status", Utf8),
        ("phase", Utf8), ("seconds", Float64), ("fraction", Float64),
        ("wall_seconds", Float64),
    ),
    # SLO histogram exemplars (observability/metrics.py): the most
    # recent worst offender per latency bucket, full ledger attached
    "system.exemplars": make_schema(
        ("family", Utf8), ("phase", Utf8), ("bucket_le", Float64),
        ("job_id", Utf8), ("seconds", Float64),
        ("wall_seconds", Float64), ("ledger_json", Utf8),
    ),
}

SYSTEM_TABLES = tuple(sorted(SYSTEM_SCHEMAS))


def is_system_table(name: str) -> bool:
    return name in SYSTEM_SCHEMAS


# ---------------------------------------------------------------------------
# Query records: the ONE builder every surface shares
# ---------------------------------------------------------------------------


def build_query_record(job_id: str, status: str, wall_seconds: float,
                       plan_digest: Optional[str] = None,
                       output_rows: Optional[int] = None,
                       num_stages: Optional[int] = None,
                       started_at: Optional[float] = None,
                       peak_host_bytes: Optional[int] = None,
                       peak_device_bytes: Optional[int] = None,
                       profile_artifact: Optional[str] = None,
                       error: Optional[str] = None,
                       cancel_reason: Optional[str] = None,
                       lanes: Optional[dict] = None,
                       origin: str = "standalone") -> dict:
    """The canonical query summary dict: what the /debug/queries ring,
    the durable history log and ``system.queries`` scans all carry.
    ``state`` is kept as an alias of ``status`` for pre-existing
    consumers of the ring shape."""
    rec = {
        "job_id": job_id,
        "status": status,
        "state": status,  # legacy ring key
        "wall_seconds": round(float(wall_seconds), 4),
        "origin": origin,
    }
    if plan_digest:
        rec["plan_digest"] = plan_digest
    if output_rows is not None:
        rec["output_rows"] = int(output_rows)
    if num_stages is not None:
        rec["num_stages"] = int(num_stages)
    if started_at is not None:
        rec["started_at"] = float(started_at)
    if peak_host_bytes is not None:
        rec["peak_host_bytes"] = int(peak_host_bytes)
    if peak_device_bytes is not None:
        rec["peak_device_bytes"] = int(peak_device_bytes)
    if profile_artifact:
        rec["profile_artifact"] = profile_artifact
    if error:
        rec["error"] = str(error)[:300]
    if cancel_reason:
        rec["cancel_reason"] = str(cancel_reason)
    if lanes:
        rec["lanes"] = {k: float(v) for k, v in lanes.items()}
    return rec


# ---------------------------------------------------------------------------
# Durable query-history log (BALLISTA_QUERY_LOG_DIR)
# ---------------------------------------------------------------------------

_HISTORY_FILE = "query_history.jsonl"


class QueryHistoryLog:
    """Bounded on-disk JSON-lines history with size-capped rotation.

    One line per terminal query record; when the file crosses the byte
    cap it rotates to ``.1`` (one rotated segment kept, so disk usage
    is bounded at ~2x the cap). Appends reopen the file each time
    (O_APPEND) so several engine processes sharing the directory — a
    scheduler next to a standalone context — interleave whole lines
    instead of clobbering a shared handle. Readers dedup by job_id,
    LAST line wins: late-arriving facts (a deferred profile artifact or
    lane decomposition) are appended as an enriched repeat line."""

    def __init__(self, directory: str, max_bytes: Optional[int] = None):
        self.dir = directory
        if max_bytes is None:
            try:
                max_bytes = int(float(os.environ.get(
                    "BALLISTA_QUERY_LOG_MAX_MB", "16")) * 1e6)
            except ValueError:
                max_bytes = 16_000_000
        self.max_bytes = max(max_bytes, 4096)
        self._lock = threading.Lock()
        self.path = os.path.join(directory, _HISTORY_FILE)

    def append(self, record: dict) -> None:
        """Best-effort durable append; never raises into the query."""
        line = json.dumps(record, default=str)
        with self._lock:
            try:
                os.makedirs(self.dir, exist_ok=True)
                try:
                    if os.path.getsize(self.path) + len(line) + 1 > \
                            self.max_bytes:
                        os.replace(self.path, self.path + ".1")
                except OSError:
                    pass  # no file yet
                with open(self.path, "a") as fh:
                    fh.write(line + "\n")
            except OSError:
                import logging

                logging.getLogger("ballista.systables").warning(
                    "query-history append failed (dir %s)", self.dir,
                    exc_info=True)

    def read(self) -> List[dict]:
        """All surviving history records, oldest first (rotated segment
        before the live file), duplicates by job_id collapsed to the
        LAST occurrence."""
        records: List[dict] = []
        for path in (self.path + ".1", self.path):
            try:
                with open(path) as fh:
                    for line in fh:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if isinstance(rec, dict):
                            records.append(rec)
            except OSError:
                continue
        by_job: Dict[str, dict] = {}
        order: List[str] = []
        for rec in records:
            jid = str(rec.get("job_id", ""))
            if jid not in by_job:
                order.append(jid)
            by_job[jid] = rec
        return [by_job[j] for j in order]


_history_lock = threading.Lock()
_history_cache: dict = {}  # dir -> QueryHistoryLog


def query_log_dir() -> Optional[str]:
    v = os.environ.get("BALLISTA_QUERY_LOG_DIR", "")
    if not v or v.lower() in ("0", "off", "false"):
        return None
    return v


def history_log() -> Optional[QueryHistoryLog]:
    """The process's history log for the current
    ``BALLISTA_QUERY_LOG_DIR`` (None when unset)."""
    d = query_log_dir()
    if d is None:
        return None
    with _history_lock:
        log = _history_cache.get(d)
        if log is None:
            log = _history_cache[d] = QueryHistoryLog(d)
        return log


def record_query(record: dict, query_log=None) -> None:
    """Record a terminal query: into the given ring (``health.QueryLog``
    — the scheduler's, or this process's default), and into the durable
    history log when configured. The one write path every surface
    shares."""
    (query_log or process_query_log()).record(record)
    hist = history_log()
    if hist is not None:
        hist.append(record)


def annotate_query(job_id: str, query_log=None, **fields) -> None:
    """Attach late-arriving facts (profile artifact path, lanes) to a
    recorded query: updates the ring entries in place and appends an
    enriched history line (readers keep the last line per job)."""
    ql = query_log or process_query_log()
    ql.annotate(job_id, **fields)
    hist = history_log()
    if hist is not None:
        entry = next((e for e in ql.snapshot()["queries"]
                      if e.get("job_id") == job_id), None)
        if entry is not None:
            hist.append(entry)


# -- process-global stores (standalone surface) ------------------------------

_process_lock = threading.Lock()
_process_query_log = None
_local_job_ids = itertools.count(1)


def process_query_log():
    """This process's query ring: what a standalone context records
    into and what its ``system.queries`` scans read."""
    global _process_query_log
    with _process_lock:
        if _process_query_log is None:
            from .health import QueryLog

            _process_query_log = QueryLog()
            # live progress plane: in-flight standalone collects show
            # up as status="running" rows with live wall seconds
            from . import progress as obs_progress

            _process_query_log.live_fn = \
                obs_progress.local_live_query_records
        return _process_query_log


def _reset_process_state_for_tests() -> None:
    """Drop the in-memory rings (NOT the on-disk history): simulates a
    fresh process for restart-survival tests."""
    global _process_query_log
    with _process_lock:
        _process_query_log = None
    _OPERATOR_STORE.clear()
    with _history_lock:
        _history_cache.clear()
    from . import progress as obs_progress

    obs_progress._reset_process_state_for_tests()


class OperatorStore:
    """Bounded ring of per-query operator-metric snapshots feeding
    ``system.operators``. Entries hold a PROVIDER so the standalone
    path can defer the device sync + plan walk to scan time (the < 5%
    collect-overhead gate forbids eager harvesting); a provider
    returning None (the plan re-ran and reset its metrics, or was
    collected) drops the entry's rows."""

    def __init__(self, cap: int = 32):
        self._lock = threading.Lock()
        self._entries: deque = deque(maxlen=cap)

    def record(self, job_id: str, plan_digest: str,
               provider: Callable[[], Optional[List[dict]]]) -> None:
        with self._lock:
            self._entries.append((job_id, plan_digest or "", provider))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def rows(self) -> List[dict]:
        with self._lock:
            entries = list(self._entries)
        out: List[dict] = []
        for job_id, digest, provider in entries:
            try:
                op_rows = provider()
            except Exception:  # noqa: BLE001 - observability only
                op_rows = None
            if not op_rows:
                continue
            for i, r in enumerate(op_rows):
                base = {
                    "job_id": job_id, "plan_digest": digest,
                    "stage_id": int(r.get("stage_id", 0)),
                    "op_index": i,
                    "operator": str(r.get("operator", "")),
                    "depth": int(r.get("depth", 0)),
                }
                for metric, value in sorted(
                        (r.get("metrics") or {}).items()):
                    try:
                        v = float(value)
                    except (TypeError, ValueError):
                        continue
                    out.append({**base, "metric": metric, "value": v})
        return out


_OPERATOR_STORE = OperatorStore()


def operator_store() -> OperatorStore:
    return _OPERATOR_STORE


def plan_metrics_provider(phys) -> Callable[[], Optional[List[dict]]]:
    """Deferred standalone operator harvest: a weakly-referenced plan
    plus a metrics epoch. If the plan re-ran (reset bumped the epoch)
    or was collected, the snapshot no longer describes the recorded
    query and the provider declines."""
    ref = weakref.ref(phys)
    epoch = getattr(phys, "_metrics_epoch", 0)
    cache: dict = {}

    def provide() -> Optional[List[dict]]:
        if "rows" in cache:
            return cache["rows"]
        plan = ref()
        if plan is None or getattr(plan, "_metrics_epoch", 0) != epoch:
            return None
        from .metrics import collect_plan_metrics

        rows = [{**r, "stage_id": 0}
                for r in collect_plan_metrics(plan)]
        cache["rows"] = rows
        return rows

    return provide


def stage_metrics_provider(stage_metrics: dict) -> Callable[[], List[dict]]:
    """Cluster-side operator rows: materialized once from the completed
    JobStatus's per-stage aggregation (already host data)."""
    rows: List[dict] = []
    for sid in sorted(stage_metrics or {}):
        for r in (stage_metrics[sid].get("operators") or []):
            rows.append({**r, "stage_id": sid})
    return lambda: rows


# ---------------------------------------------------------------------------
# Standalone query recorder (hooked into BallistaContext._standalone_collect)
# ---------------------------------------------------------------------------


def _result_rows(result) -> Optional[int]:
    """Rows of a collect's result: a pandas DataFrame, or the port's
    dict of numpy arrays (``to_pydict``)."""
    if result is None:
        return None
    if isinstance(result, dict):
        return len(next(iter(result.values()))) if result else 0
    return len(result)


class StandaloneQueryRecorder:
    """Times one standalone collect and records its terminal summary —
    with real profiler lanes, computed from the always-on flight
    recorder — into the shared snapshot layer. Every step is
    best-effort: observability must never fail or slow the query
    meaningfully (the < 5% warm-q1 gate covers this path, history log
    on AND off)."""

    def __init__(self, plan, session_id: str = ""):
        from ..compile import compile_stats
        from ..ingest import phase_totals
        from . import profiler as obs_profiler
        from . import progress as obs_progress

        self.job_id = f"local-{os.getpid()}-{next(_local_job_ids)}"
        self.session_id = session_id
        try:
            self.digest = obs_profiler.plan_digest(plan)
        except Exception:  # noqa: BLE001 - digest is advisory
            self.digest = ""
        self.artifact_path: Optional[str] = None
        self._phases0 = phase_totals()
        self._compile0 = compile_stats()
        self._t0 = time.time()
        # latency ledger (ledger.py): open the thread-local stamp
        # window the collect path writes planning/host_decode into;
        # _finish_inner assembles + records the full ledger
        self.ledger: Optional[dict] = None
        # the collect thread's host seconds by category (hostclock.py),
        # the ledger's ``host`` key: filled by the collect when it
        # returns, after this recorder's finish, so the finish counts
        self.host: dict = {}
        from . import ledger as obs_ledger

        obs_ledger.begin_collect()
        # live progress plane: register the collect with the in-flight
        # surfaces (system.tasks/stages, running system.queries rows);
        # the executed plan attaches once planned (attach_current_plan)
        self.handle = obs_progress.start_local_query(
            self.job_id, session_id, self.digest)

    def _lanes(self, wall: float, records) -> Optional[dict]:
        from ..compile import compile_stats
        from ..ingest import phase_totals
        from .export import COMPILE_STATS, compute_lanes

        if records is None:
            return None
        phases1 = phase_totals()
        compile1 = compile_stats()
        session = {
            "wall_seconds": wall,
            "phases": {k: phases1.get(k, 0.0) - self._phases0.get(k, 0.0)
                       for k in ("parse", "h2d")},
            "compile": {k: compile1.get(k, 0) - self._compile0.get(k, 0)
                        for k in COMPILE_STATS},
            "records": records,
        }
        return compute_lanes(session)["lanes"]

    def _build_ledger(self, wall: float, status: str, records) -> None:
        """Assemble + record this collect's latency ledger: the TLS
        stamp window (planning/host_decode) + span sums out of the SAME
        ring extraction the lanes use + the compile governor delta,
        with ``device_execute`` as the remainder — phases sum exactly
        to the wall time."""
        from . import ledger as obs_ledger
        from ..compile import compile_stats
        from .export import COMPILE_SECONDS

        # always detach the window, even when recording is off — a
        # stale window would soak up stamps from later unrecorded runs
        stamps = obs_ledger.take_collect()
        if not obs_ledger.ledger_enabled():
            return
        phases = dict(stamps)
        if records:
            for phase, secs in obs_ledger.span_phase_sums(
                    records).items():
                phases[phase] = phases.get(phase, 0.0) + secs
        compile1 = compile_stats()
        comp = (float(compile1.get(COMPILE_SECONDS, 0.0))
                - float(self._compile0.get(COMPILE_SECONDS, 0.0)))
        if comp > 0:
            phases["compile"] = phases.get("compile", 0.0) + comp
        measured = sum(phases.values())
        phases["device_execute"] = max(0.0, wall - measured)
        self.ledger = obs_ledger.build_ledger(
            self.job_id, wall, origin="standalone", status=status,
            phases=phases)
        from .operators import operator_sums

        self.ledger["operators"] = operator_sums(records or ())
        self.ledger["host"] = self.host
        obs_ledger.record_ledger(self.ledger)

    def finish(self, status: str, result=None, phys=None,
               error: Optional[BaseException] = None) -> None:
        try:
            self._finish_inner(status, result, phys, error)
        except Exception:  # noqa: BLE001 - never fail the query
            import logging

            logging.getLogger("ballista.systables").warning(
                "query record failed for %s", self.job_id, exc_info=True)
        finally:
            from . import progress as obs_progress

            try:
                obs_progress.finish_local_query(self.handle, status)
            except Exception:  # noqa: BLE001 - advisory
                pass

    def _finish_inner(self, status, result, phys, error) -> None:
        from . import memory as obs_memory
        from . import tracing

        wall = time.time() - self._t0
        # ONE ring extraction feeds both the lane decomposition and the
        # ledger's span-derived phases
        records = None
        try:
            if tracing.flight_recorder_enabled():
                records = tracing.ring_records(since=self._t0)
        except Exception:  # noqa: BLE001 - advisory
            records = None
        lanes = None
        try:
            lanes = self._lanes(wall, records)
        except Exception:  # noqa: BLE001 - lanes are advisory
            lanes = None
        # a cooperatively-cancelled query is terminal "cancelled", not a
        # failure; the reason (client/deadline/slow-query-kill/drain)
        # rides the record so system.queries can answer "who killed it"
        cancel_reason = None
        from ..errors import QueryCancelled

        if isinstance(error, QueryCancelled):
            status = "cancelled"
            cancel_reason = error.reason
        try:
            self._build_ledger(wall, status, records)
        except Exception:  # noqa: BLE001 - observability only
            pass
        rec = build_query_record(
            self.job_id, status, wall,
            plan_digest=self.digest,
            output_rows=_result_rows(result),
            num_stages=1,
            started_at=self._t0,
            peak_host_bytes=obs_memory.peak_host_bytes(),
            peak_device_bytes=obs_memory.peak_device_bytes(),
            profile_artifact=self.artifact_path,
            error=error,
            cancel_reason=cancel_reason,
            lanes=lanes,
            origin="standalone",
        )
        record_query(rec)
        if phys is not None and status == "completed":
            _OPERATOR_STORE.record(self.job_id, self.digest,
                                   plan_metrics_provider(phys))
        # per-session metering (system.sessions): the standalone face
        # of the scheduler's terminal-transition accumulation; wall
        # doubles as task seconds (one in-process "task")
        from . import progress as obs_progress

        obs_progress.process_session_meter().record(
            self.session_id,
            wall_seconds=wall,
            task_seconds=wall,
            device_blocked_seconds=(lanes or {}).get(
                "device_blocked", 0.0),
            bytes_shuffled=0,
            peak_host_bytes=obs_memory.peak_host_bytes(),
            peak_device_bytes=obs_memory.peak_device_bytes(),
        )


# ---------------------------------------------------------------------------
# Snapshot builder: table name -> rows
# ---------------------------------------------------------------------------


def _query_table_records(query_log) -> List[dict]:
    """History rows (oldest, restart-surviving) + the in-memory ring;
    ring entries win on job_id collisions (they carry annotations)."""
    ring = (query_log or process_query_log()).snapshot()["queries"]
    ring_ids = {str(e.get("job_id", "")) for e in ring}
    hist = history_log()
    out: List[dict] = []
    if hist is not None:
        for rec in hist.read():
            if str(rec.get("job_id", "")) not in ring_ids:
                out.append({**rec, "origin": "history"})
    out.extend(ring)
    return out


def _queries_rows(query_log) -> List[dict]:
    rows = []
    for rec in _query_table_records(query_log):
        rows.append({
            "job_id": rec.get("job_id"),
            "plan_digest": rec.get("plan_digest"),
            "status": rec.get("status", rec.get("state")),
            "started_at": rec.get("started_at"),
            "wall_seconds": rec.get("wall_seconds"),
            "output_rows": rec.get("output_rows"),
            "num_stages": rec.get("num_stages"),
            "peak_host_bytes": rec.get("peak_host_bytes"),
            "peak_device_bytes": rec.get("peak_device_bytes"),
            "profile_artifact": rec.get("profile_artifact"),
            "error": rec.get("error"),
            "cancel_reason": rec.get("cancel_reason"),
            "origin": rec.get("origin"),
            "queue_position": rec.get("queue_position"),
        })
    return rows


def _query_lanes_rows(query_log) -> List[dict]:
    rows = []
    for rec in _query_table_records(query_log):
        lanes = rec.get("lanes")
        if not isinstance(lanes, dict):
            continue
        wall = float(rec.get("wall_seconds") or 0.0)
        for lane, secs in sorted(lanes.items()):
            try:
                s = float(secs)
            except (TypeError, ValueError):
                continue
            rows.append({
                "job_id": rec.get("job_id"),
                "plan_digest": rec.get("plan_digest"),
                "lane": lane,
                "seconds": round(s, 6),
                "fraction": round(s / wall, 4) if wall > 0 else None,
            })
    return rows


def _compile_rows() -> List[dict]:
    from ..compile.governor import governor

    return governor().entry_rows()


def _device_count() -> int:
    """Devices of the kind this process computes on: its cards, or the
    one CPU when it has none."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _local_executor_rows() -> List[dict]:
    """Standalone ``system.executors``: one row describing the current
    process as its own single executor."""
    import socket

    from . import memory as obs_memory
    from ..ingest import pool_queue_depth

    n_devices = _device_count()
    gov = _gov_stats()
    return [{
        "executor_id": "standalone",
        "host": socket.gethostname(),
        "port": 0,
        "num_devices": n_devices,
        "rss_bytes": obs_memory.rss_bytes(),
        "device_bytes": obs_memory.device_bytes(),
        "inflight_tasks": 0,
        "ingest_pool_depth": pool_queue_depth(),
        "peak_host_bytes": obs_memory.peak_host_bytes(),
        "shuffle_inflight_bytes": gov["inflight_bytes"],
        "spill_bytes_total": gov["spilled_bytes_total"],
        # the current process IS the executor: its heartbeat is now
        "heartbeat_age_seconds": 0.0,
        "stale": 0,
    }]


def _gov_stats() -> dict:
    from ..distributed import spill as _spill

    return _spill.governor().stats()


def _local_tasks_rows() -> List[dict]:
    from . import progress as obs_progress

    return obs_progress.local_task_rows()


def _local_stages_rows() -> List[dict]:
    from . import progress as obs_progress

    return obs_progress.local_stage_rows()


def _session_rows() -> List[dict]:
    from . import progress as obs_progress

    rows = obs_progress.process_session_meter().rows()
    # records persisted by older builds predate the cache-attribution
    # columns; surface them as 0, not NULL
    for r in rows:
        r.setdefault("table_cache_hits", 0)
        r.setdefault("result_cache_hits", 0)
    return rows


def _cache_rows() -> List[dict]:
    from ..cache.residency import process_table_cache
    from ..cache.results import process_result_cache

    return (process_table_cache().entry_rows()
            + process_result_cache().entry_rows())


class SystemSnapshot:
    """The shared snapshot layer: one instance per serving surface (the
    process default for standalone contexts, one owned by the scheduler
    service for the cluster), all tables built from the same stores the
    other surfaces read."""

    def __init__(self, query_log=None, operators: Optional[OperatorStore] = None,
                 executors_fn: Optional[Callable[[], List[dict]]] = None,
                 tasks_fn: Optional[Callable[[], List[dict]]] = None,
                 stages_fn: Optional[Callable[[], List[dict]]] = None,
                 sessions_fn: Optional[Callable[[], List[dict]]] = None,
                 admission_fn: Optional[Callable[[], List[dict]]] = None,
                 autoscaler_fn: Optional[Callable[[], List[dict]]] = None):
        self._query_log = query_log
        self._operators = operators
        self._executors_fn = executors_fn or _local_executor_rows
        # live progress plane: the scheduler wires its JobProgressTracker
        # here; the standalone defaults read the local query handles
        self._tasks_fn = tasks_fn or _local_tasks_rows
        self._stages_fn = stages_fn or _local_stages_rows
        self._sessions_fn = sessions_fn or _session_rows
        # admission plane: the scheduler wires its controller's decision
        # ring; standalone has no gate, so the table is empty
        self._admission_fn = admission_fn or (lambda: [])
        # elastic control plane: the scheduler wires its autoscaler's
        # decision ring; standalone never autoscales, so empty
        self._autoscaler_fn = autoscaler_fn or (lambda: [])

    def table_rows(self, table: str) -> List[dict]:
        if table not in SYSTEM_SCHEMAS:
            raise KeyError(f"unknown system table {table!r}")
        if table == "system.queries":
            return _queries_rows(self._query_log)
        if table == "system.query_lanes":
            return _query_lanes_rows(self._query_log)
        if table == "system.operators":
            return (self._operators or _OPERATOR_STORE).rows()
        if table == "system.compile":
            return _compile_rows()
        if table == "system.cache":
            return _cache_rows()
        if table == "system.executors":
            return self._executors_fn()
        if table == "system.tasks":
            return self._tasks_fn()
        if table == "system.stages":
            return self._stages_fn()
        if table == "system.sessions":
            return self._sessions_fn()
        if table == "system.admission":
            return self._admission_fn()
        if table == "system.autoscaler":
            return self._autoscaler_fn()
        if table == "system.latency":
            # process-global ledger log: standalone queries land here
            # directly; on the cluster path the scheduler assembles the
            # job ledger at terminal time into its own process log
            from . import ledger as _ledger

            return _ledger.latency_rows()
        if table == "system.exemplars":
            from . import metrics as _metrics

            return _metrics.exemplar_rows()
        return settings_rows()


_PROCESS_SNAPSHOT = SystemSnapshot()


def process_snapshot() -> SystemSnapshot:
    """The standalone (current-process) snapshot."""
    return _PROCESS_SNAPSHOT


# ---------------------------------------------------------------------------
# Virtual scan source
# ---------------------------------------------------------------------------


def rows_to_batches(schema: Schema, rows: List[dict], device="cpu"):
    """Row dicts -> at most one ColumnBatch on ``device`` (None/missing
    values become NULLs via validity masks). Empty input yields no
    batches."""
    import numpy as np

    from ..columnar import ColumnBatch, Dictionary

    if not rows:
        return []
    n = len(rows)
    arrays: Dict[str, "np.ndarray"] = {}
    dicts: Dict[str, Dictionary] = {}
    valids: Dict[str, "np.ndarray"] = {}
    for f in schema.fields:
        raw = [r.get(f.name) for r in rows]
        valid = np.asarray([v is not None for v in raw], dtype=bool)
        if f.dtype.kind == "utf8":
            d, codes = Dictionary.encode(
                ["" if v is None else str(v) for v in raw])
            dicts[f.name] = d
            arrays[f.name] = codes
        elif f.dtype.kind == "float64":
            vals = np.zeros(n, dtype=np.float64)
            for i, v in enumerate(raw):
                if v is not None:
                    try:
                        vals[i] = float(v)
                    except (TypeError, ValueError):
                        valid[i] = False
            arrays[f.name] = vals
        else:  # integral
            vals = np.zeros(n, dtype=f.dtype.device_dtype())
            for i, v in enumerate(raw):
                if v is not None:
                    try:
                        vals[i] = int(v)
                    except (TypeError, ValueError):
                        valid[i] = False
            arrays[f.name] = vals
        if not valid.all():
            valids[f.name] = valid
    return [ColumnBatch.from_numpy(schema, arrays, dicts,
                                   validity=valids or None, device=device)]


class SystemTableSource(TableSource):
    """Scan source for one ``system.*`` table.

    Three hydration modes, resolved in order:

    - ``rows`` given (deserialized on an executor, or scheduler-planned
      raw SQL): scan the materialized snapshot as shipped;
    - ``fetcher`` given (a remote context): rows come from the
      SCHEDULER — fetched fresh at every scan / serialization, so
      cluster scans see cluster state;
    - neither (standalone): rows come from this process's snapshot,
      rebuilt at every scan so repeated collects see fresh telemetry.

    Its batches are made on ``device``: the executor's, for a plan
    deserialized there.
    """

    def __init__(self, table: str,
                 fetcher: Optional[Callable[[], List[dict]]] = None,
                 rows: Optional[List[dict]] = None, device="cpu"):
        if table not in SYSTEM_SCHEMAS:
            from ..errors import PlanError

            raise PlanError(f"unknown system table {table!r} "
                            f"(known: {', '.join(SYSTEM_TABLES)})")
        self.table = table
        self._fetcher = fetcher
        self._rows = rows
        self.device = device

    def table_schema(self) -> Schema:
        return SYSTEM_SCHEMAS[self.table]

    def num_partitions(self) -> int:
        return 1

    def current_rows(self) -> List[dict]:
        if self._rows is not None:
            return self._rows
        if self._fetcher is not None:
            return self._fetcher()
        return process_snapshot().table_rows(self.table)

    def estimated_rows(self) -> Optional[int]:
        if self._rows is not None:
            return len(self._rows)
        return None  # building the snapshot just to estimate is wasteful

    def scan(self, partition: int,
             projection: Optional[Sequence[str]] = None):
        schema = self.table_schema()
        for batch in rows_to_batches(schema, self.current_rows(),
                                     self.device):
            if projection is None:
                yield batch
            else:
                sub = schema.project(projection)
                cols = [batch.column(n) for n in projection]
                yield batch.with_columns(sub, cols)

    def source_descriptor(self) -> dict:
        # serialization point (a plan shipping to the scheduler /
        # executors): materialize the rows NOW so the remote side scans
        # the snapshot the submitting surface saw
        return {
            "kind": "system",
            "path": self.table,
            "rows_json": json.dumps(self.current_rows(), default=str),
        }
