"""Live cluster health plane: ``/healthz``, ``/metrics``,
``/debug/queries``.

A lightweight stdlib HTTP server every long-running process (scheduler,
executor) can start next to its RPC port — no new dependencies, daemon
threads only, one instance per process role:

- ``GET /healthz`` — liveness: ``200 {"status": "ok", ...}`` with role,
  pid, uptime. Cluster tests poll this instead of sleeping.
- ``GET /metrics`` — Prometheus text exposition. Families come from the
  process's registered sample callbacks; names MUST exist in
  ``registry.PROCESS_METRICS`` (the renderer drops unknown names — the
  registry is the contract ``dev/check_metric_names.py`` lints).
- ``GET /debug/queries`` — JSON ring buffer of recent query summaries
  plus the slow-query subset (``BALLISTA_SLOW_QUERY_SECS``) and, when
  a live provider is wired, IN-FLIGHT queries (status "running").
- ``GET /debug/jobs[/<job_id>]`` — live job progress snapshots
  (scheduler only; the progress plane's HTTP face — per-stage
  completion fractions, rate-based ETA, task counts).
- ``GET /debug/profile/<job_id>`` — the job's merged Chrome-trace
  profile artifact (scheduler only; served from the distributed
  profiler's collector, built on demand from the flight recorder when
  no ambient/slow-query build happened).

Servers bind ``127.0.0.1`` by default (diagnosis plane, not a public
API); ``port=0`` picks an ephemeral port (read ``server.port``)."""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from .registry import (HISTOGRAM_BUCKETS, PROCESS_METRICS,
                       histogram_snapshot)

log = logging.getLogger("ballista.health")

# sample: (family name, labels dict, numeric value)
Sample = Tuple[str, Dict[str, str], float]


def slow_query_secs() -> Optional[float]:
    """BALLISTA_SLOW_QUERY_SECS threshold, or None when unset/invalid."""
    v = os.environ.get("BALLISTA_SLOW_QUERY_SECS", "")
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        return None


def slow_query_kill_secs() -> Optional[float]:
    """``BALLISTA_SLOW_QUERY_KILL_SECS``: upgrade the slow-query LOG to
    a KILL — the scheduler's reap pass cancels cluster jobs running
    longer than this, and standalone collects arm a watchdog that fires
    the query's cancel token. None when unset/invalid."""
    v = os.environ.get("BALLISTA_SLOW_QUERY_KILL_SECS", "")
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        return None


class QueryLog:
    """Bounded ring of recent query summaries + the slow subset.

    ``record`` takes a summary dict (job_id/label, wall_seconds,
    state, ...); entries over the slow threshold are ALSO kept in a
    separate ring so a burst of fast queries can't evict the slow one
    being investigated. Thread-safe, lock-cheap."""

    def __init__(self, capacity: int = 128):
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=capacity)
        self._slow: deque = deque(maxlen=capacity)
        self.slow_total = 0
        # live progress plane: optional provider of IN-FLIGHT query
        # records (status "running", live wall seconds) appended to
        # every snapshot — they vanish/are overwritten the moment the
        # terminal record lands in the ring
        self.live_fn = None

    def record(self, summary: dict) -> None:
        entry = dict(summary)
        entry.setdefault("recorded_at", time.time())
        thr = slow_query_secs()
        is_slow = (thr is not None
                   and float(entry.get("wall_seconds", 0.0)) >= thr)
        with self._lock:
            self._recent.append(entry)
            if is_slow:
                self._slow.append(entry)
                self.slow_total += 1
        if is_slow:
            log.warning("slow query (>= %.3fs): %s", thr,
                        json.dumps(entry, default=str))

    def annotate(self, job_id: str, **fields) -> None:
        """Attach fields to already-recorded entries of a job —
        ``record`` copies its input, so late-arriving facts (the
        deferred profile-artifact path) land through here."""
        with self._lock:
            for ring in (self._recent, self._slow):
                for e in ring:
                    if e.get("job_id") == job_id:
                        e.update(fields)

    def snapshot(self) -> dict:
        live: List[dict] = []
        if self.live_fn is not None:
            try:
                live = list(self.live_fn())
            except Exception:  # noqa: BLE001 - advisory rows only
                live = []
        with self._lock:
            return {
                "queries": list(self._recent) + live,
                "slow_queries": list(self._slow),
                "slow_query_secs": slow_query_secs(),
                "slow_total": self.slow_total,
            }


def render_prometheus(samples: List[Sample]) -> str:
    """Prometheus text exposition (v0.0.4). Families are grouped, HELP/
    TYPE come from the registry; samples whose family the registry
    doesn't know are dropped (loudly, once per name)."""
    by_family: Dict[str, List[Sample]] = {}
    for name, labels, value in samples:
        if name not in PROCESS_METRICS:
            log.warning("dropping unregistered metric family %r "
                        "(add it to observability/registry.py)", name)
            continue
        by_family.setdefault(name, []).append((name, labels, value))
    lines: List[str] = []
    for name in sorted(by_family):
        kind, help_text = PROCESS_METRICS[name]
        ptype = "counter" if kind == "counter" else "gauge"
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {ptype}")
        for _, labels, value in by_family[name]:
            label_s = _label_str(labels)
            if float(value) == int(value):
                vs = str(int(value))
            else:
                vs = repr(float(value))
            lines.append(f"{name}{label_s} {vs}")
    return "\n".join(lines) + "\n"


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", "\\\\")
                         .replace('"', '\\"'))
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_histograms() -> str:
    """Prometheus text for every registered histogram family with
    observations (``registry.observe_histogram``): cumulative
    ``_bucket{le=...}`` series plus ``_sum`` / ``_count``."""
    lines: List[str] = []
    for family, rows in sorted(histogram_snapshot().items()):
        if PROCESS_METRICS.get(family, (None,))[0] != "histogram":
            continue  # registry is the gate, here too
        help_text = PROCESS_METRICS[family][1]
        lines.append(f"# HELP {family} {help_text}")
        lines.append(f"# TYPE {family} histogram")
        for labels, counts, total, n in rows:
            for le, c in zip(HISTOGRAM_BUCKETS, counts):
                ls = _label_str({**labels, "le": f"{le:g}"})
                lines.append(f"{family}_bucket{ls} {c}")
            ls = _label_str({**labels, "le": "+Inf"})
            lines.append(f"{family}_bucket{ls} {n}")
            ls = _label_str(labels)
            lines.append(f"{family}_sum{ls} {round(total, 6)}")
            lines.append(f"{family}_count{ls} {n}")
    return "\n".join(lines) + "\n" if lines else ""


def base_process_samples() -> List[Sample]:
    """Samples every role exports: RSS, tracked host bytes (+ per
    category), device bytes."""
    from . import memory as obs_memory

    from ..distributed import spill as _spill

    snap = obs_memory.memory_snapshot()
    gov = _spill.governor().stats()
    out: List[Sample] = [
        ("ballista_rss_bytes", {}, snap["rss_bytes"]),
        ("ballista_host_tracked_bytes", {}, snap["current_bytes"]),
        ("ballista_host_tracked_peak_bytes", {}, snap["peak_bytes"]),
        ("ballista_device_bytes", {}, snap["device_bytes"]),
        ("ballista_device_peak_bytes", {}, snap["peak_device_bytes"]),
        ("ballista_shuffle_inflight_bytes", {}, gov["inflight_bytes"]),
        ("ballista_spill_bytes_total", {}, gov["spilled_bytes_total"]),
    ]
    for cat, n in sorted(snap["by_category"].items()):
        out.append(("ballista_host_category_bytes", {"category": cat}, n))
    from ..cache import cache_counters

    cc = cache_counters()
    out.extend([
        ("ballista_cache_table_hits_total", {}, cc["table_cache_hits"]),
        ("ballista_cache_table_misses_total", {},
         cc["table_cache_misses"]),
        ("ballista_cache_table_fills_total", {}, cc["table_cache_fills"]),
        ("ballista_cache_table_evictions_total", {},
         cc["table_cache_evictions"]),
        ("ballista_cache_table_resident_bytes", {},
         cc["table_cache_resident_bytes"]),
        ("ballista_cache_result_hits_total", {}, cc["result_cache_hits"]),
        ("ballista_cache_result_misses_total", {},
         cc["result_cache_misses"]),
        ("ballista_cache_result_bytes", {}, cc["result_cache_bytes"]),
        ("ballista_cache_donated_buffers_total", {},
         cc["donated_buffers"]),
        ("ballista_cache_donated_bytes_total", {}, cc["donated_bytes"]),
    ])
    return out


class HealthServer:
    """The per-process health plane. ``samples_fn`` returns the role's
    metric samples (base process samples are appended automatically);
    ``query_log`` feeds ``/debug/queries``."""

    def __init__(self, role: str, port: int = 0,
                 samples_fn: Optional[Callable[[], List[Sample]]] = None,
                 query_log: Optional[QueryLog] = None,
                 host: str = "127.0.0.1",
                 profile_fn: Optional[Callable[[str],
                                              Optional[dict]]] = None,
                 jobs_fn: Optional[Callable[[Optional[str]],
                                            object]] = None):
        self.role = role
        self.query_log = query_log or QueryLog()
        self._samples_fn = samples_fn
        # profile_fn(job_id) -> merged profile artifact dict (or None):
        # serves /debug/profile/<job_id> on the scheduler
        self._profile_fn = profile_fn
        # jobs_fn(None) -> live job progress snapshots, jobs_fn(id) ->
        # one snapshot or None: serves /debug/jobs[/<job_id>] (live
        # progress plane, scheduler only)
        self._jobs_fn = jobs_fn
        self._started_at = time.time()
        plane = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent: no stdout spam
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/healthz":
                        body = json.dumps(plane.healthz()).encode()
                        self._send(200, body, "application/json")
                    elif path == "/metrics":
                        body = plane.metrics_text().encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4")
                    elif path == "/debug/queries":
                        body = json.dumps(plane.query_log.snapshot(),
                                          default=str).encode()
                        self._send(200, body, "application/json")
                    elif path == "/debug/jobs" and \
                            plane._jobs_fn is not None:
                        body = json.dumps(
                            {"jobs": plane._jobs_fn(None)},
                            default=str).encode()
                        self._send(200, body, "application/json")
                    elif path.startswith("/debug/jobs/") and \
                            plane._jobs_fn is not None:
                        jid = path[len("/debug/jobs/"):]
                        # empty id ("/debug/jobs/") must 404, not leak
                        # the whole-list shape through the falsy branch
                        snap = plane._jobs_fn(jid) if jid else None
                        if snap is None:
                            self._send(404, b"unknown job", "text/plain")
                        else:
                            body = json.dumps(snap, default=str).encode()
                            self._send(200, body, "application/json")
                    elif path.startswith("/debug/profile/") and \
                            plane._profile_fn is not None:
                        job_id = path[len("/debug/profile/"):]
                        art = plane._profile_fn(job_id)
                        if art is None:
                            self._send(404, b"no profile for that job",
                                       "text/plain")
                        else:
                            body = json.dumps(art, default=str).encode()
                            self._send(200, body, "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception:  # noqa: BLE001 - never kill the plane
                    try:
                        self._send(500, b"internal error", "text/plain")
                    except Exception:  # noqa: BLE001 - peer went away
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"health-{role}-{self.port}",
        )
        self._thread.start()

    def healthz(self) -> dict:
        return {
            "status": "ok",
            "role": self.role,
            "pid": os.getpid(),
            "uptime_seconds": round(time.time() - self._started_at, 3),
        }

    def metrics_text(self) -> str:
        samples: List[Sample] = [
            ("ballista_up", {}, 1),
            ("ballista_uptime_seconds", {},
             time.time() - self._started_at),
        ]
        if self._samples_fn is not None:
            try:
                samples.extend(self._samples_fn())
            except Exception:  # noqa: BLE001 - plane must stay up
                log.exception("metrics sample callback failed")
        samples.extend(base_process_samples())
        return render_prometheus(samples) + render_histograms()

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 - already down
            pass


def metrics_port_from_env(default: int = -1) -> int:
    """BALLISTA_METRICS_PORT: -1 = off, 0 = ephemeral, else fixed."""
    try:
        return int(os.environ.get("BALLISTA_METRICS_PORT", str(default)))
    except ValueError:
        return default


def maybe_start_health_server(role: str, port: Optional[int],
                              samples_fn=None, query_log=None,
                              profile_fn=None, jobs_fn=None
                              ) -> Optional[HealthServer]:
    """Start a health server unless disabled (``port`` None/negative)."""
    if port is None or port < 0:
        return None
    try:
        return HealthServer(role, port, samples_fn=samples_fn,
                            query_log=query_log, profile_fn=profile_fn,
                            jobs_fn=jobs_fn)
    except OSError as e:
        log.warning("health plane for %s failed to bind port %s: %s",
                    role, port, e)
        return None
