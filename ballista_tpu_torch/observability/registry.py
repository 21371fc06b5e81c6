"""Metric name registry: the single source of truth for metric names.

Two sections:

- :data:`OPERATOR_METRICS` — names recorded on per-operator
  ``MetricsSet`` instances (``add_counter`` / ``add_time`` /
  ``set_gauge``). ``dev/check_metric_names.py`` lints every literal
  call site in the package against this table, so a typo'd or
  undocumented metric name fails tier-1 instead of silently forking the
  namespace.
- :data:`PROCESS_METRICS` — Prometheus families the health plane
  exports (``observability/health.py`` renders ``# HELP``/``# TYPE``
  lines from here and refuses to export a family this table doesn't
  know).

Kinds: ``counter`` (monotonic int, summed on merge), ``timer``
(``elapsed_*`` seconds, summed on merge), ``gauge`` (last/max value,
max-ed on merge), ``histogram`` (Prometheus cumulative-bucket
histograms, observed through :func:`observe_histogram` in this module
so the family gate covers them too).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Tuple

log = logging.getLogger("ballista.health")

# -- per-operator MetricsSet names -------------------------------------------

OPERATOR_METRICS = {
    # recorded automatically by instrument_execute
    "output_rows": ("counter", "live rows yielded (device counts, lazy)"),
    "output_batches": ("counter", "batches yielded"),
    "elapsed_compute": ("timer", "cumulative wall time inside the "
                                 "operator's generator, children included"),
    "elapsed_self": ("timer", "derived: elapsed_compute minus children"),
    "peak_host_bytes": ("gauge", "peak tracked host bytes observed while "
                                 "this operator yielded"),
    "peak_device_bytes": ("gauge", "peak device bytes observed while this "
                                   "operator yielded"),
    # compile governor attribution
    "compile_count": ("counter", "XLA backend compiles attributed to the "
                                 "operator's governed calls"),
    "elapsed_compile": ("timer", "first-call compile (+first batch) time"),
    "persistent_cache_hits": ("counter", "disk-cache hits that skipped a "
                                         "compile"),
    # ingest phases
    "elapsed_parse": ("timer", "file -> host arrays parse time"),
    "elapsed_h2d": ("timer", "host -> device transfer time"),
    "elapsed_prefetch_wait": ("timer", "consumer time blocked on the "
                                       "prefetch queue"),
    "prefetched_batches": ("counter", "batches served through the "
                                      "prefetch queue"),
    # operator-specific
    "compact_count": ("counter", "adaptive post-filter compactions taken"),
    "expand_reruns": ("counter", "expanding-probe capacity re-runs"),
    "bytes_read": ("counter", "shuffle reader input bytes"),
    "local_reads": ("counter", "shuffle partitions read from local disk"),
    "remote_fetches": ("counter", "shuffle partitions fetched over the "
                                  "data plane"),
    "spilled_bytes": ("counter", "fetched shuffle chunk bytes diverted "
                                 "to disk past the memory budget "
                                 "watermark"),
    "bytes_written": ("counter", "partition/shuffle output bytes"),
    "elapsed_write": ("timer", "partition IPC write time"),
    "selectivity": ("gauge", "filter pass fraction"),
    "table_cache_hits": ("counter", "partition scans served from the "
                                    "device-resident table cache "
                                    "(parse + H2D skipped)"),
}

# -- Prometheus families exported by the health plane ------------------------

PROCESS_METRICS = {
    "ballista_up": ("gauge", "1 while the process serves its health plane"),
    "ballista_uptime_seconds": ("gauge", "seconds since process start"),
    "ballista_rss_bytes": ("gauge", "resident set size of the process"),
    "ballista_host_tracked_bytes": ("gauge", "host bytes currently tracked "
                                            "by category accounting"),
    "ballista_host_tracked_peak_bytes": ("gauge", "peak tracked host bytes"),
    "ballista_host_category_bytes": ("gauge", "tracked host bytes by "
                                              "category label"),
    "ballista_device_bytes": ("gauge", "device bytes in use (live arrays / "
                                       "allocator stats)"),
    "ballista_device_peak_bytes": ("gauge", "peak observed device bytes"),
    # shuffle memory governor (distributed/spill.py)
    "ballista_shuffle_inflight_bytes": ("gauge", "governed in-flight "
                                                 "shuffle buffer bytes"),
    "ballista_spill_bytes_total": ("counter", "shuffle chunk bytes "
                                              "spilled to disk past the "
                                              "budget watermark"),
    # executor
    "ballista_inflight_tasks": ("gauge", "tasks currently executing"),
    "ballista_ingest_pool_depth": ("gauge", "queued work items waiting on "
                                            "the ingest pool"),
    "ballista_tasks_completed_total": ("counter", "tasks completed"),
    "ballista_tasks_failed_total": ("counter", "tasks failed"),
    # scheduler
    "ballista_executors_live": ("gauge", "executors with an unexpired "
                                         "lease"),
    "ballista_jobs_submitted_total": ("counter", "jobs accepted by "
                                                 "ExecuteQuery"),
    "ballista_jobs_completed_total": ("counter", "jobs completed"),
    "ballista_jobs_failed_total": ("counter", "jobs failed"),
    "ballista_jobs_cancelled_total": ("counter", "jobs cooperatively "
                                                 "cancelled (client, "
                                                 "deadline, slow-query "
                                                 "kill, drain)"),
    "ballista_tasks_cancelled_total": ("counter", "task attempts aborted "
                                                  "by a cancel token "
                                                  "(job cancel or "
                                                  "executor drain)"),
    "ballista_tasks_dispatched_total": ("counter", "task definitions "
                                                   "handed to executors"),
    "ballista_ready_queue_depth": ("gauge", "tasks in the ready queue"),
    # live progress plane (scheduler)
    "ballista_tasks_running": ("gauge", "tasks currently running across "
                                        "all live jobs (progress "
                                        "tracker view)"),
    "ballista_job_progress_fraction": ("gauge", "per-live-job completion "
                                                "fraction 0..1 (label "
                                                "job=...)"),
    "ballista_slow_queries_total": ("counter", "completed queries over "
                                               "BALLISTA_SLOW_QUERY_SECS"),
    # scheduler-side aggregation of executor heartbeat gauges
    "ballista_executor_rss_bytes": ("gauge", "per-executor RSS from the "
                                             "last heartbeat"),
    "ballista_executor_device_bytes": ("gauge", "per-executor device bytes "
                                                "from the last heartbeat"),
    "ballista_executor_inflight_tasks": ("gauge", "per-executor inflight "
                                                  "tasks"),
    "ballista_executor_ingest_pool_depth": ("gauge", "per-executor ingest "
                                                     "pool queue depth"),
    "ballista_executor_peak_host_bytes": ("gauge", "per-executor peak "
                                                   "tracked host bytes"),
    # distributed profiler (scheduler)
    "ballista_query_lane_seconds": ("histogram",
                                    "per-query named wall-time lane "
                                    "seconds (label lane=...), observed "
                                    "when a merged profile artifact is "
                                    "built for a job"),
    "ballista_stage_seconds": ("histogram",
                               "summed task seconds per completed stage "
                               "(label stage=...), observed at job "
                               "completion"),
    # always-on latency ledger (observability/ledger.py + metrics.py):
    # SLO histograms observed once per terminal query; each bucket
    # keeps its most recent worst-offender exemplar (system.exemplars)
    "ballista_latency_seconds": ("histogram",
                                 "end-to-end query wall seconds, "
                                 "observed from the per-query latency "
                                 "ledger at terminal time"),
    "ballista_latency_phase_seconds": ("histogram",
                                       "per-query ledger phase seconds "
                                       "(label phase=admission_wait|"
                                       "queue_wait|planning|compile|"
                                       "device_execute|...)"),
    # admission plane (scheduler; distributed/admission.py)
    "ballista_admission_queue_depth": ("gauge", "submissions waiting in "
                                                "the admission queue"),
    "ballista_admission_admitted_total": ("counter", "submissions "
                                                     "admitted (at the "
                                                     "gate or from the "
                                                     "queue)"),
    "ballista_admission_queued_total": ("counter", "submissions held in "
                                                   "the admission queue "
                                                   "at the gate"),
    "ballista_admission_sheds_total": ("counter", "submissions shed with "
                                                  "a retryable error "
                                                  "(budget, queue-full, "
                                                  "queue-timeout, "
                                                  "draining)"),
    "ballista_admission_queue_wait_seconds": ("histogram",
                                              "time submissions spent in "
                                              "the admission queue "
                                              "(label outcome=admitted|"
                                              "shed)"),
    # warm-path cache tiers (ballista_tpu_torch/cache/)
    "ballista_cache_table_hits_total": ("counter", "partition scans served "
                                                   "from the device-"
                                                   "resident table cache"),
    "ballista_cache_table_misses_total": ("counter", "partition scans that "
                                                     "found no resident "
                                                     "entry"),
    "ballista_cache_table_fills_total": ("counter", "partitions pinned "
                                                    "into the table "
                                                    "cache"),
    "ballista_cache_table_evictions_total": ("counter", "pinned partitions "
                                                        "evicted for "
                                                        "budget"),
    "ballista_cache_table_resident_bytes": ("gauge", "device bytes pinned "
                                                     "by the table cache "
                                                     "governor"),
    "ballista_cache_result_hits_total": ("counter", "collects served from "
                                                    "the plan-fingerprint "
                                                    "result cache"),
    "ballista_cache_result_misses_total": ("counter", "result-cache "
                                                      "lookups that "
                                                      "executed"),
    "ballista_cache_result_bytes": ("gauge", "host bytes held by cached "
                                             "result sets"),
    "ballista_cache_donated_buffers_total": ("counter", "governed calls "
                                                        "that donated a "
                                                        "transient batch's "
                                                        "device buffers"),
    "ballista_cache_donated_bytes_total": ("counter", "device bytes "
                                                      "donated through "
                                                      "fused stages"),
    # autoscaler (scheduler; distributed/controlplane/autoscaler.py)
    "ballista_autoscale_target_executors": ("gauge", "fleet size the "
                                                     "autoscaler is "
                                                     "steering toward"),
    "ballista_autoscale_ups_total": ("counter", "scale-up decisions "
                                                "acted on (executor "
                                                "spawned)"),
    "ballista_autoscale_downs_total": ("counter", "scale-down decisions "
                                                  "acted on (executor "
                                                  "drained)"),
}

# -- process-level histograms -------------------------------------------------
# Cumulative-bucket histograms the health plane renders as
# ``<family>_bucket{le=...}`` / ``_sum`` / ``_count``. One fixed bucket
# ladder serves every family (they all measure seconds).

HISTOGRAM_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0)

_hist_lock = threading.Lock()
# family -> labelkey (sorted items tuple) -> [per-bucket counts, sum, n]
_histograms: Dict[str, Dict[tuple, list]] = {}


def observe_histogram(family: str, labels: Dict[str, str],
                      value: float) -> None:
    """Record one observation. The family must be registered in
    PROCESS_METRICS with kind ``histogram`` — same gate the renderer
    applies to counters/gauges."""
    kind = PROCESS_METRICS.get(family, (None,))[0]
    if kind != "histogram":
        log.warning("dropping observation for unregistered histogram "
                    "family %r (add it to observability/registry.py)",
                    family)
        return
    key = tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))
    v = float(value)
    with _hist_lock:
        cells = _histograms.setdefault(family, {})
        cell = cells.get(key)
        if cell is None:
            cell = cells[key] = [[0] * len(HISTOGRAM_BUCKETS), 0.0, 0]
        counts, _, _ = cell
        for i, le in enumerate(HISTOGRAM_BUCKETS):
            if v <= le:
                counts[i] += 1
        cell[1] += v
        cell[2] += 1


def histogram_snapshot() -> Dict[str, List[Tuple[dict, list, float, int]]]:
    """{family: [(labels, bucket counts, sum, count), ...]} — consumed
    by the health plane's renderer."""
    out: Dict[str, List[Tuple[dict, list, float, int]]] = {}
    with _hist_lock:
        for family, cells in _histograms.items():
            rows = []
            for key, (counts, total, n) in sorted(cells.items()):
                rows.append((dict(key), list(counts), total, n))
            out[family] = rows
    return out


def reset_histograms() -> None:
    with _hist_lock:
        _histograms.clear()


def operator_metric_names() -> set:
    return set(OPERATOR_METRICS)


def process_metric_names() -> set:
    return set(PROCESS_METRICS)
