"""Client API: BallistaContext + DataFrame, standalone and remote.

The port of the JAX package's ``client.py``. A standalone context plans
and executes in-process on one device. The context's device defaults to
``"cuda"`` and is explicit everywhere below it — sources create their
batches there, and no code path moves to another device on its own.

A remote context (``BallistaContext.remote(host, port)``) submits each
query to a scheduler (``distributed/client.py``: submit, poll, fetch the
final partitions), whose executors run it on their own devices. As in
the JAX package, the client still resolves uncorrelated scalar
subqueries itself before submitting, on the context's device; cancel,
progress, system tables and ``df.profile()`` go to the scheduler.

A collect runs as the JAX package's standalone collect does: fusion,
the opt-in result cache, every scan primed on the ingest pool before the
first pull (``ingest.prime_plan``; scans serve from the device table
cache when they can), the standalone adaptive pass over the primed tree
(``adaptive/standalone.py``, once per kept plan, then re-fused), one
cancel token bound around it (``ctx.cancel()`` from another thread), and
``cancel_plan`` in a ``finally``. Around it, as in the JAX package: a
``StandaloneQueryRecorder`` (``system.queries``, ``system.latency``, the
query history and the latency ledger, ``ctx.last_query_ledger()``), the
``planning`` and ``host_decode`` ledger stamps, a progress sampler when
the caller passes ``on_progress``, and a profile artifact per collect
under ``BALLISTA_PROFILE=<dir>``. ``EXPLAIN [VERBOSE]`` and ``EXPLAIN
ANALYZE`` plan to ``physical/explain.py``. Prewarming is not ported
yet.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .datatypes import Schema, schema as make_schema
from .errors import ExecutionError, PlanError
from .observability import hostclock
from . import expr as ex
from .io import CsvSource, MemTableSource, ParquetSource, TblSource
from .logical import (
    Aggregate,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Projection,
    Repartition,
    Sort,
    TableScan,
    TableSource,
)
from .sql.parser import CreateExternalTable, parse_sql
from .sql.planner import CatalogTable, SqlPlanner


def _default_pk(schema: Schema) -> Optional[str]:
    """TPC-H-style convention: a first column named *key is the primary key."""
    names = schema.names()
    if names and names[0].endswith("key"):
        return names[0]
    return None


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ExecutionError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ExecutionError(f"unsupported device {dev}")
    return dev


class BallistaContext:
    """Entry point: table registration + SQL/DataFrame construction."""

    def __init__(self, settings: Optional[Dict[str, str]] = None,
                 device="cuda", mode: str = "standalone",
                 host: str = "localhost", port: int = 50050):
        self.mode = mode
        self.host = host
        self.port = port
        self.device = _resolve_device(device)
        self.settings = dict(settings or {})
        # per-session metering (observability/progress.py): every query
        # of this context is accounted to one session id, which travels
        # with the submitted settings (a caller's "session.id" wins)
        import uuid

        self.session_id = self.settings.setdefault(
            "session.id", uuid.uuid4().hex[:12])
        self._catalog: Dict[str, CatalogTable] = {}
        # SQL plan cache: repeated identical queries reuse the planned
        # DataFrame (and its physical plan); cleared on catalog change
        self._plan_cache: Dict[str, "DataFrame"] = {}
        # in-flight collects' cancel tokens (ctx.cancel reaches them)
        self._lifecycle_lock = threading.Lock()
        self._active_tokens: List = []
        # job-id sinks of in-flight remote collects (ctx.cancel and
        # job_progress reach their jobs through them), and the last
        # remote job's id and per-stage metrics
        self._active_job_sinks: List[list] = []
        self._last_job_id = None
        # the last query's operator metrics: a remote query's come from
        # the scheduler; a standalone query keeps its executed plan and
        # snapshots it only when read (last_query_metrics)
        self._last_query_metrics = None
        self._last_query_phys = None
        # the last query's latency ledger (standalone: assembled at its
        # end; remote: fetched when read, merged with the client's
        # envelope in _last_ledger_env)
        self._last_query_ledger = None
        self._last_ledger_env = None
        # warm-path attribution of this context's collects: scan
        # partitions served by the table cache, results served by the
        # result cache
        self.cache_hits = {"table": 0, "result": 0}

    # -- constructors -------------------------------------------------------

    @staticmethod
    def standalone(device="cuda", **settings) -> "BallistaContext":
        """In-process context on ``device`` ("cuda" by default; raises
        when there is no card, unless the caller asks for "cpu")."""
        return BallistaContext(settings or None, device=device)

    @staticmethod
    def remote(host: str, port: int = 50050, device="cuda",
               **settings) -> "BallistaContext":
        """Context submitting to the scheduler at ``host:port``. Its
        ``device`` ("cuda" by default) is where it resolves scalar
        subqueries before submitting; the executors pick their own."""
        return BallistaContext(settings or None, device=device,
                               mode="remote", host=host, port=port)

    # -- registration -------------------------------------------------------

    def register_source(self, name: str, source: TableSource,
                        primary_key: Optional[str] = None) -> None:
        pk = primary_key or _default_pk(source.table_schema())
        self._catalog[name] = CatalogTable(name, source, pk)
        self._plan_cache.clear()

    def register_tbl(self, name: str, path: str, schema: Schema,
                     primary_key: Optional[str] = None, **kw) -> None:
        self.register_source(
            name, TblSource(path, schema, device=self.device, **kw),
            primary_key)

    def register_csv(self, name: str, path: str, schema: Schema,
                     has_header: bool = True,
                     primary_key: Optional[str] = None, **kw) -> None:
        self.register_source(
            name, CsvSource(path, schema, has_header=has_header,
                            device=self.device, **kw),
            primary_key,
        )

    def register_parquet(self, name: str, path: str,
                         schema: Optional[Schema] = None,
                         primary_key: Optional[str] = None, **kw) -> None:
        """A Parquet file or a directory of ``*.parquet`` files (one
        partition each), scanned on this context's device."""
        self.register_source(
            name, ParquetSource(path, schema, device=self.device, **kw),
            primary_key)

    def register_memtable(self, name: str, schema: Schema, data: Dict,
                          num_partitions: int = 1,
                          primary_key: Optional[str] = None) -> None:
        self.register_source(
            name, MemTableSource.from_pydict(schema, data, num_partitions,
                                             device=self.device),
            primary_key,
        )

    def register_table(self, name: str, df: "DataFrame") -> None:
        """Register a DataFrame as a named table (view semantics): SQL
        referencing ``name`` inlines a copy of the frame's logical plan."""
        import copy

        self._catalog[name] = CatalogTable(name, None, None,
                                           plan=copy.deepcopy(df.plan))
        self._plan_cache.clear()

    def deregister_table(self, name: str) -> None:
        self._catalog.pop(name, None)
        self._plan_cache.clear()

    def tables(self) -> List[str]:
        return sorted(self._catalog)

    # -- reads --------------------------------------------------------------

    def read_tbl(self, path: str, schema: Schema, **kw) -> "DataFrame":
        src = TblSource(path, schema, device=self.device, **kw)
        return DataFrame(self, TableScan("tbl:" + path, src))

    def read_csv(self, path: str, schema: Schema, has_header: bool = True,
                 **kw) -> "DataFrame":
        src = CsvSource(path, schema, has_header=has_header,
                        device=self.device, **kw)
        return DataFrame(self, TableScan("csv:" + path, src))

    def read_parquet(self, path: str, schema: Optional[Schema] = None,
                     **kw) -> "DataFrame":
        src = ParquetSource(path, schema, device=self.device, **kw)
        return DataFrame(self, TableScan("parquet:" + path, src))

    def _system_source(self, name: str):
        """Scan source for a ``system.*`` table: the current process's
        snapshot in standalone mode; in remote mode rows are fetched
        from the SCHEDULER at scan or ship time, so they reflect cluster
        state. Either way its batches are made on the context's
        device."""
        from .observability.systables import SystemTableSource

        if self.mode != "remote":
            return SystemTableSource(name, device=self.device)
        host, port = self.host, self.port

        def fetch():
            from .distributed.client import fetch_system_table

            return fetch_system_table(host, port, name)

        return SystemTableSource(name, fetcher=fetch, device=self.device)

    def table(self, name: str) -> "DataFrame":
        if name not in self._catalog:
            from .observability.systables import is_system_table

            if is_system_table(name):
                return DataFrame(
                    self, TableScan(name, self._system_source(name)))
            raise PlanError(f"unknown table {name!r}")
        t = self._catalog[name]
        if t.plan is not None:  # registered DataFrame view: inline a copy
            import copy

            return DataFrame(self, copy.deepcopy(t.plan))
        return DataFrame(self, TableScan(t.name, t.source))

    # -- SQL ----------------------------------------------------------------

    def sql(self, query: str) -> "DataFrame":
        with hostclock.charged(hostclock.FRONTEND):
            return self._sql(query)

    def _sql(self, query: str) -> "DataFrame":
        cached = self._plan_cache.get(query)
        if cached is not None:
            return cached
        if (self.mode == "remote"
                and self.settings.get("plan.server") in ("on", "true", "1")
                and not query.lstrip().lower().startswith("create")):
            # raw-SQL submission: the scheduler plans against the catalog
            # shipped with the query (DDL still registers client-side)
            return DataFrame(self, None, raw_sql=query)
        stmt = parse_sql(query)
        if isinstance(stmt, CreateExternalTable):
            sch = make_schema(*[(n, t) for n, t in stmt.columns])
            if stmt.stored_as in ("CSV",):
                self.register_csv(stmt.name, stmt.location, sch,
                                  has_header=stmt.has_header)
            elif stmt.stored_as in ("TBL",):
                self.register_tbl(stmt.name, stmt.location, sch)
            elif stmt.stored_as in ("PARQUET",):
                self.register_parquet(stmt.name, stmt.location, sch)
            else:
                raise PlanError(f"STORED AS {stmt.stored_as} unsupported")
            return DataFrame(self, None)
        planner = SqlPlanner(self._catalog,
                             system_provider=self._system_source)
        df = DataFrame(self, planner.plan(stmt))
        # plans over system.* tables are not cached: re-issuing the SQL
        # must see fresh rows (observability/systables.py)
        if not _scans_system_table(df._plan):
            self._plan_cache[query] = df
        return df

    # -- execution ----------------------------------------------------------

    def _planner_options(self):
        from .physical.planner import PlannerOptions

        return PlannerOptions.from_settings(self.settings, self.device)

    @contextmanager
    def _track_lifecycle(self, obj, registry: list):
        """Register an in-flight query's cancel handle (a CancelToken,
        or a remote collect's job-id sink) for the duration of the
        collect, so a concurrent ``ctx.cancel()`` can reach it."""
        with self._lifecycle_lock:
            registry.append(obj)
        try:
            yield obj
        finally:
            with self._lifecycle_lock:
                registry.remove(obj)

    def cancel(self, reason: str = "client") -> int:
        """Cooperatively cancel this context's in-flight queries (call
        from another thread). Standalone collects stop at their next
        batch boundary and raise :class:`errors.QueryCancelled`; their
        scan producers stop at their next chunk. Remote collects get a
        best-effort ``CancelJob`` for every job this context has in
        flight. Returns how many queries or jobs this call cancelled."""
        with self._lifecycle_lock:
            tokens = list(self._active_tokens)
            sinks = list(self._active_job_sinks)
        n = sum(bool(t.cancel(reason)) for t in tokens)
        if sinks:
            import logging

            from .distributed.client import CancelRequested, cancel_job

            for jid in [j for sink in sinks for j in list(sink)
                        if isinstance(j, str)]:
                try:
                    n += bool(cancel_job(self.host, self.port, jid, reason))
                except Exception:  # noqa: BLE001 - best-effort
                    logging.getLogger("ballista.lifecycle").warning(
                        "CancelJob(%s) failed", jid, exc_info=True)
            # a collect sleeping between admission retries has no live
            # job to cancel: the sentinel stops it from resubmitting
            for sink in sinks:
                sink.append(CancelRequested(reason))
        return n

    def _remote_collect(self, plan: Optional[LogicalPlan],
                        raw_sql: Optional[str] = None, on_progress=None):
        """Submit ``plan`` (or ``raw_sql`` with the catalog), wait for
        the job and fetch its final partitions: a pandas DataFrame."""
        import time as _time

        from .distributed.client import remote_collect, remote_sql_collect
        from .observability import ledger as _ledger

        sink: list = []
        jsink: list = []
        _ledger.begin_collect()
        t0 = _time.perf_counter()
        # jsink receives the job id at SUBMIT time, so a concurrent
        # ctx.cancel() can cancel the job while this thread waits
        with self._track_lifecycle(jsink, self._active_job_sinks):
            if raw_sql is not None:
                out = remote_sql_collect(
                    self.host, self.port, raw_sql, self._catalog,
                    self.settings, metrics_out=sink, job_id_out=jsink,
                    on_progress=on_progress)
            else:
                out = remote_collect(
                    self.host, self.port, plan, self.settings,
                    metrics_out=sink, job_id_out=jsink,
                    on_progress=on_progress)
        self._last_query_metrics = sink[0] if sink else None
        self._last_query_phys = None
        self._last_job_id = next(
            (j for j in jsink if isinstance(j, str)), None)
        # the client envelope of the job's ledger: end-to-end wall and
        # the client-side stamps (result_transfer, host_decode) the
        # scheduler never sees; merged when the ledger is read
        self._last_query_ledger = None
        self._last_ledger_env = {"wall": _time.perf_counter() - t0,
                                 "stamps": _ledger.take_collect()}
        return out

    def job_progress(self, job_id: Optional[str] = None):
        """Live progress snapshot of a job (per-stage fractions, ETA,
        task counts; the JAX package's shape). Remote: by default of
        this context's in-flight job or else its last one, asked of the
        scheduler. Standalone: of this process's in-flight collects.
        None when nothing is known of the job."""
        if self.mode != "remote":
            from .observability import progress as obs_progress

            handles = obs_progress.local_live_handles()
            if job_id is not None:
                handles = [h for h in handles if h.job_id == job_id]
            return handles[-1].snapshot() if handles else None
        jid = job_id
        if not jid:
            with self._lifecycle_lock:
                inflight = [j for sink in self._active_job_sinks
                            for j in list(sink) if isinstance(j, str)]
            jid = (inflight[-1] if inflight else None) or self._last_job_id
        if not jid:
            return None
        from .distributed.client import fetch_job_progress

        return fetch_job_progress(self.host, self.port, jid)

    def last_query_metrics(self):
        """Per-stage operator metrics of this context's last query
        (:class:`observability.QueryMetrics`), or None before any query
        or under ``BALLISTA_METRICS=0``. Standalone queries report one
        synthetic stage 0, snapshotted from the executed plan when read;
        remote queries the scheduler's aggregation over completed
        tasks."""
        if self._last_query_metrics is None and \
                self._last_query_phys is not None:
            from .observability.metrics import snapshot_plan_metrics

            self._last_query_metrics = snapshot_plan_metrics(
                self._last_query_phys)
        return self._last_query_metrics

    def _record_plan_metrics(self, phys) -> None:
        from .observability.metrics import metrics_enabled

        self._last_query_metrics = None
        self._last_query_phys = phys if metrics_enabled() else None

    def last_query_ledger(self):
        """The latency ledger of the most recent query this context ran:
        the fixed phase schema (``observability.ledger.LEDGER_PHASES``)
        plus wall seconds and the unattributed remainder, or None before
        any query or under ``BALLISTA_LEDGER=0``. Standalone queries keep
        the ledger assembled at their end; remote queries fetch the
        scheduler's ``system.latency`` rows for the job here, when read,
        and merge them with the client envelope (end-to-end wall, result
        transfer, host decode) — nothing on the collect's own path."""
        if self._last_query_ledger is None and self.mode == "remote" \
                and self._last_job_id and self._last_ledger_env:
            self._last_query_ledger = self._fetch_remote_ledger()
        return self._last_query_ledger

    def _fetch_remote_ledger(self):
        import time as _time

        from .distributed.client import fetch_system_table
        from .observability import ledger as _ledger

        env = self._last_ledger_env
        job_id = self._last_job_id
        # completion is published before the scheduler's terminal hook
        # records the job ledger (results never wait on observability)
        # — briefly retry until the job's rows appear
        rows = []
        deadline = _time.time() + 5.0
        while True:
            try:
                rows = [r for r in fetch_system_table(
                            self.host, self.port, "system.latency")
                        if r.get("job_id") == job_id]
            except Exception:  # noqa: BLE001 - ledger is advisory
                rows = []
            if rows or _time.time() > deadline:
                break
            _time.sleep(0.1)
        phases = {}
        status = "completed"
        for r in rows:
            phase = r.get("phase")
            if phase and phase != "unattributed":
                try:
                    phases[phase] = float(r.get("seconds") or 0.0)
                except (TypeError, ValueError):
                    continue
            status = r.get("status") or status
        # the client envelope: end-to-end wall + client-side stamps
        # (result_transfer, host_decode) the scheduler never sees
        for k, v in (env.get("stamps") or {}).items():
            phases[k] = phases.get(k, 0.0) + float(v)
        return _ledger.build_ledger(job_id, env["wall"], origin="client",
                                    status=status, phases=phases)

    def _standalone_collect(self, plan: LogicalPlan, phys=None,
                            on_progress=None, frame: bool = False):
        """Plan (unless the caller passes a kept physical plan), execute
        and record; returns ``(result, phys)``: a dict of numpy arrays,
        or a pandas DataFrame when ``frame`` (made inside the collect's
        ``host_decode`` stamp). Every collect's terminal summary (status,
        wall seconds, output rows, flight-recorder lanes, latency ledger,
        artifact path) lands in the system-tables snapshot and the
        query-history log (``observability/systables.py``).
        ``on_progress`` receives snapshots of the one progress shape
        from a sampler thread over the executing plan's metrics, as the
        cluster path's status poll delivers them."""
        from .observability.systables import StandaloneQueryRecorder

        with hostclock.charged(hostclock.RECORDER):
            rec = StandaloneQueryRecorder(plan, session_id=self.session_id)
        sampler = None
        if on_progress is not None:
            from .observability.progress import LocalProgressSampler

            sampler = LocalProgressSampler(rec.handle, on_progress)
        try:
            out, phys2 = self._standalone_collect_routed(plan, phys, rec,
                                                         frame)
        except Exception as e:  # noqa: BLE001 - record, then propagate
            from .errors import QueryCancelled

            with hostclock.charged(hostclock.RECORDER):
                if sampler is not None:
                    sampler.finish("cancelled"
                                   if isinstance(e, QueryCancelled)
                                   else "failed")
                rec.finish("failed", error=e)
            rec.host.update(hostclock.take())
            self._last_query_ledger = rec.ledger
            self._last_ledger_env = None
            raise
        with hostclock.charged(hostclock.RECORDER):
            if sampler is not None:
                # terminal callback BEFORE the recorder tears the handle
                # down: the final snapshot reports fraction exactly 1.0
                sampler.finish("completed")
            rec.finish("completed", result=out, phys=phys2)
        # the ledger, recorded inside the finish, holds this very dict:
        # its host seconds are complete once the recorder's are in
        rec.host.update(hostclock.take())
        self._last_query_ledger = rec.ledger
        self._last_ledger_env = None
        return out, phys2

    def _standalone_collect_routed(self, plan: LogicalPlan, phys, rec,
                                   frame: bool):
        from .observability import profiler as obs_profiler

        out_dir = obs_profiler.profile_dir()
        if out_dir is not None and not obs_profiler.profiling_active():
            # BALLISTA_PROFILE=<dir>: one artifact a collect, labelled by
            # a plan digest so a loop's files tell query shapes apart
            try:
                profile_label = "query-" + obs_profiler.plan_digest(plan)
            except Exception:  # noqa: BLE001 - label is cosmetic
                profile_label = "query"
            box = {}

            def run():
                box["r"] = self._standalone_collect_inner(plan, phys, frame)

            import logging

            plog = logging.getLogger("ballista.profiler")
            try:
                _, path = obs_profiler.profile_call(
                    run, label=profile_label,
                    plan_getter=lambda: box.get("r", (None, None))[1],
                    out_dir=out_dir, busy_ok=True,
                )
            except Exception:
                if "r" not in box:
                    raise  # the QUERY failed: propagate as usual
                # only the artifact write failed (e.g. an unwritable
                # BALLISTA_PROFILE path): the caller keeps the result
                plog.exception("profile artifact write failed; "
                               "returning the query result anyway")
                path = None
            if path is not None:
                plog.info("profile artifact written: %s", path)
                rec.artifact_path = path
            return box["r"]
        # unprofiled run: the always-on flight recorder still lets a
        # query that crosses BALLISTA_SLOW_QUERY_SECS dump a retroactive
        # artifact after the fact (no-op when the knob is unset)
        from .observability.distributed import watch_slow_query

        def slow_label():
            return "query-" + obs_profiler.plan_digest(plan)

        slow_sink: list = []
        try:
            with watch_slow_query(slow_label, artifact_out=slow_sink):
                return self._standalone_collect_inner(plan, phys, frame)
        finally:
            if slow_sink:
                rec.artifact_path = slow_sink[0]

    def _standalone_collect_inner(self, plan: LogicalPlan, phys=None,
                                  frame: bool = False):
        """One cancel token per collect: ``cancel()`` fires it from
        another thread, the slow-query killer on timeout, and every
        batch boundary under the bind checks it."""
        from .lifecycle import CancelToken, bind_token, slow_query_killer

        token = CancelToken()
        with self._track_lifecycle(token, self._active_tokens), \
                bind_token(token), \
                slow_query_killer(token), \
                hostclock.charged(hostclock.OPERATORS):
            return self._collect_governed(plan, phys, frame)

    def _collect_governed(self, plan: LogicalPlan, phys=None,
                          frame: bool = False):
        from .cache import results as _results
        from .execution import collect_physical, plan_logical
        from .ingest import cancel_plan, prime_plan
        from .observability import progress as obs_progress
        from .observability.ledger import ledger_phase
        from .physical.explain import ExplainAnalyzeExec, ExplainExec
        from .physical.fusion import maybe_fuse

        with ledger_phase("planning"), hostclock.charged(hostclock.FRONTEND):
            if phys is None:
                phys = plan_logical(plan, self._planner_options())
            # whole-stage fusion: each pipeline stage becomes one
            # governed program (a no-op on a kept plan, fused already)
            phys = maybe_fuse(phys)
        # plan-fingerprint result cache (cache/results.py, opt-in): a
        # repeat of the same fused plan over unchanged files with the
        # same settings on the same device returns the stored result
        # without executing. EXPLAIN executes nothing worth caching and
        # ANALYZE must measure again, so both bypass it
        rc_key = None
        if (_results.result_cache_enabled(self.settings)
                and not isinstance(phys, (ExplainAnalyzeExec, ExplainExec))):
            # keyed on the plan as planned: an adapted plan is a function
            # of the planned one and the (signed) files it read
            rc_key = _results.plan_key(getattr(phys, "_planned", phys),
                                       self.settings, self.device)
            cached = _results.process_result_cache().lookup(rc_key)
            if cached is not None:
                self._annotate_cache_hits(result_hit=True)
                return _decode(cached, frame), phys
        for node in _plan_nodes(phys):  # report THIS run's metrics
            node.metrics().reset()
        # optional prewarm (BALLISTA_PREWARM): start the scan-side
        # programs' first calls at their predicted capacities BEFORE the
        # scans below start parsing, so warm-up and capture overlap
        # parse/upload (no-op unless enabled; compile/prewarm.py)
        from .compile.prewarm import maybe_prewarm

        maybe_prewarm(phys)
        # parallel ingest: start parse+H2D of every leaf scan now, so
        # independent tables overlap each other and the adaptive pass's
        # repartition materializations consume running streams. Scan
        # instances survive the adaptive rewrite (with_new_children
        # keeps leaves), so the primed handles are consumed by the
        # adapted tree; whatever an early exit leaves unconsumed is
        # cancelled, never leaked
        prime_plan(phys)
        try:
            with hostclock.charged(hostclock.FRONTEND):
                phys = self._apply_adaptive(phys)
            # live progress: expose the final (adapted) tree to this
            # thread's query handle — the on_progress sampler and
            # system.tasks/system.stages read it weakly (a no-op for an
            # unrecorded collect: df.profile())
            obs_progress.attach_current_plan(phys)
            data = collect_physical(phys)
            out = _decode(data, frame)
        finally:
            cancel_plan(phys)
            # join builds and repartitioned batches of the tree that ran;
            # scan batches the table cache pins stay with the cache
            for node in _plan_nodes(phys):
                node.release()
        self._record_plan_metrics(phys)
        if rc_key is not None:
            _results.process_result_cache().fill(rc_key, data)
        self._annotate_cache_hits(phys)
        return out, phys

    def _apply_adaptive(self, phys):
        """Standalone adaptive execution: rewrite the planned tree from
        observed repartition histograms (``adaptive/standalone.py``).
        Runs once per plan — a kept DataFrame keeps the adapted tree,
        whose layouts stay frozen — then re-fuses what the rewrite
        restructured (a demoted join's probe chain is left unfused, so
        the join keeps the programs it has). EXPLAIN [ANALYZE] leaves
        are left alone: ANALYZE applies the rules itself, inside its
        measured window."""
        if getattr(phys, "_adaptive_applied", False):
            return phys
        from .adaptive import AdaptiveConfig
        from .adaptive.standalone import apply_adaptive_rules
        from .physical.explain import ExplainAnalyzeExec, ExplainExec
        from .physical.fusion import fuse_plan, fusion_enabled

        planned = phys
        conf = AdaptiveConfig.from_settings(self.settings)
        if conf.enabled and \
                not isinstance(phys, (ExplainAnalyzeExec, ExplainExec)):
            phys = apply_adaptive_rules(phys, conf)
            if fusion_enabled():
                phys = fuse_plan(phys, fuse_joins=False)
                # without the marker the next collect's maybe_fuse would
                # fuse the demoted join's probe chain after all
                phys._fusion_applied = True
        if phys is not planned:
            phys._planned = planned
        phys._adaptive_applied = True
        return phys

    def _annotate_cache_hits(self, phys=None, result_hit=False) -> None:
        """Warm-path attribution of this context (``cache_hits``): the
        plan's ScanExec ``table_cache_hits`` counters of THIS collect
        (reset at its start) and/or a result-cache hit."""
        hits = 0
        if phys is not None:
            for node in _plan_nodes(phys):
                hits += int(node.metrics()._counters.get(
                    "table_cache_hits", 0))
        self.cache_hits["table"] += hits
        self.cache_hits["result"] += int(result_hit)


def _scans_system_table(plan: Optional[LogicalPlan]) -> bool:
    from .observability.systables import SystemTableSource

    if plan is None:
        return False
    if isinstance(plan, TableScan) and \
            isinstance(plan.source, SystemTableSource):
        return True
    return any(_scans_system_table(c) for c in plan.children())


def _frame_to_pydict(frame, schema: Schema) -> Dict[str, np.ndarray]:
    """A remote result (pandas) as the dict of numpy arrays a standalone
    ``to_pydict`` returns: pandas turns dates into ``datetime64[s]`` and
    string NULLs into NaN, so both are put back by the result schema."""
    out = {}
    for f in schema.fields:
        if f.name not in frame:  # no partition came back
            out[f.name] = np.empty(0, dtype=object)
            continue
        col = frame[f.name].to_numpy()
        kind = f.dtype.kind
        if kind == "date32":
            col = col.astype("datetime64[D]")
        elif kind == "timestamp_ns":
            col = col.astype("datetime64[ns]")
        elif kind == "utf8":
            col = np.asarray([v if isinstance(v, str) else None
                              for v in col], dtype=object)
        out[f.name] = col
    return out


def _decode(data: Dict[str, np.ndarray], frame: bool):
    """The collect's result: the dict of numpy arrays, or a pandas
    DataFrame of it, made under the ledger's ``host_decode`` stamp."""
    if not frame:
        return data
    import pandas as pd

    from .observability.ledger import ledger_phase

    with ledger_phase("host_decode"):
        return pd.DataFrame(data)


def _plan_nodes(plan) -> list:
    out = [plan]
    for c in plan.children():
        out.extend(_plan_nodes(c))
    return out


class DataFrame:
    """Lazy relational frame over a logical plan."""

    def __init__(self, ctx: BallistaContext, plan: Optional[LogicalPlan],
                 raw_sql: Optional[str] = None):
        self.ctx = ctx
        self._plan = plan
        # server-side planning (remote ``plan.server``): the SQL text is
        # submitted with the catalog and planned by the scheduler
        self._raw_sql = raw_sql
        # the physical plan is kept across collects of this frame
        self._phys = None

    # -- plan access --------------------------------------------------------

    @property
    def plan(self) -> LogicalPlan:
        if self._plan is None and self._raw_sql is not None:
            # a server-planned frame used through the DataFrame API:
            # plan locally on demand; collect still submits the SQL
            planner = SqlPlanner(self.ctx._catalog,
                                 system_provider=self.ctx._system_source)
            self._plan = planner.plan(parse_sql(self._raw_sql))
        if self._plan is None:
            raise PlanError("this DataFrame carries no plan (DDL result)")
        return self._plan

    def schema(self) -> Schema:
        return self.plan.schema()

    def explain(self) -> str:
        from .optimizer import optimize

        return (
            "== Logical plan ==\n" + self.plan.pretty()
            + "== Optimized ==\n" + optimize(self.plan).pretty()
        )

    def explain_analyze(self) -> str:
        """Execute the frame's plan and return the physical plan text
        annotated with live operator metrics — the DataFrame face of SQL
        ``EXPLAIN ANALYZE`` (standalone and remote; the remote plan
        ships as one task, see physical/explain.py)."""
        from .logical import Explain

        out = self._with(Explain(self.plan, analyze=True)).to_pydict()
        rows = dict(zip(out["plan_type"], out["plan"]))
        return rows.get("plan_with_metrics", "")

    def logical_plan(self) -> LogicalPlan:
        return self.plan

    def physical_plan(self):
        """The physical plan of the latest collect (None before one)."""
        return self._phys

    # -- verbs --------------------------------------------------------------

    def _with(self, plan: LogicalPlan) -> "DataFrame":
        return DataFrame(self.ctx, plan)

    def select(self, *exprs: Union[ex.Expr, str]) -> "DataFrame":
        es = [ex.col(e) if isinstance(e, str) else e for e in exprs]
        return self._with(Projection(list(es), self.plan))

    def select_columns(self, *names: str) -> "DataFrame":
        return self.select(*names)

    def filter(self, predicate: ex.Expr) -> "DataFrame":
        return self._with(Filter(predicate, self.plan))

    where = filter

    def aggregate(self, group_by: Sequence[ex.Expr],
                  aggs: Sequence[ex.Expr]) -> "DataFrame":
        return self._with(Aggregate(list(group_by), list(aggs), self.plan))

    def sort(self, *sort_exprs: ex.Expr) -> "DataFrame":
        ses = [
            e if isinstance(e, ex.SortExpr) else ex.SortExpr(e)
            for e in sort_exprs
        ]
        return self._with(Sort(ses, self.plan))

    def limit(self, n: int) -> "DataFrame":
        return self._with(Limit(n, self.plan))

    def join(self, right: "DataFrame", on: Sequence[Tuple[str, str]],
             how: str = "inner") -> "DataFrame":
        return self._with(Join(self.plan, right.plan, list(on), how))

    def repartition(self, num_partitions: int,
                    hash_exprs: Optional[Sequence[ex.Expr]] = None) -> "DataFrame":
        return self._with(
            Repartition(self.plan, num_partitions,
                        list(hash_exprs) if hash_exprs else None)
        )

    # -- execution ----------------------------------------------------------

    def to_pydict(self, on_progress=None) -> Dict[str, np.ndarray]:
        """Execute and return the result as a dict of numpy arrays
        (column name -> logical values). Standalone, needs no pandas; a
        remote result arrives as pandas first. ``on_progress`` receives
        live progress snapshots (the one shape of both paths; the last
        reports fraction 1.0): off the status poll for a remote frame,
        from a sampler thread over the executing plan standalone.
        Callbacks are best-effort: a raising one is logged."""
        if self.ctx.mode == "remote":
            return _frame_to_pydict(self.collect(on_progress=on_progress),
                                    self.schema())
        out, self._phys = self.ctx._standalone_collect(
            self.plan, phys=self._phys, on_progress=on_progress)
        return out

    def cancel(self, reason: str = "client") -> int:
        """Cancel the context's in-flight collects (this frame's
        included) — see :meth:`BallistaContext.cancel`."""
        return self.ctx.cancel(reason)

    def collect(self, on_progress=None):
        """Execute and return a pandas DataFrame. Remote frames submit
        their SQL text (``plan.server``) or their logical plan;
        ``on_progress`` as in :meth:`to_pydict`."""
        if self.ctx.mode == "remote":
            return self.ctx._remote_collect(
                None if self._raw_sql is not None else self.plan,
                raw_sql=self._raw_sql, on_progress=on_progress)
        out, self._phys = self.ctx._standalone_collect(
            self.plan, phys=self._phys, on_progress=on_progress,
            frame=True)
        return out

    def profile(self, path: Optional[str] = None,
                label: Optional[str] = None) -> str:
        """Execute the frame under the query profiler and write ONE
        Chrome-trace/Perfetto artifact (trace spans, ingest phases,
        compile attribution, per-operator metrics, named wall-time
        lanes); returns its path.

        On the cluster path the query runs normally and the scheduler
        builds the merged artifact — its own spans and every executor's
        task windows — which this call fetches and writes locally."""
        from .observability import profiler as obs_profiler

        if self.ctx.mode != "remote":
            box = {}

            def run():
                out, phys = self.ctx._standalone_collect_inner(
                    self.plan, phys=self._phys)
                self._phys = phys
                box["phys"] = phys
                return out

            _, artifact = obs_profiler.profile_call(
                run, label=label or "query",
                plan_getter=lambda: box.get("phys"),
                out_path=path,
                out_dir=obs_profiler.profile_dir(),
            )
            return artifact
        return self._profile_remote(path, label)

    def _profile_remote(self, path: Optional[str],
                        label: Optional[str]) -> str:
        """Cluster df.profile(): run the query, then pull the
        scheduler-merged artifact for its job."""
        import time as _time

        from .distributed.client import SchedulerClient, fetch_job_profile
        from .errors import ClusterError
        from .observability import profiler as obs_profiler
        from .observability.export import write_artifact_file

        self.collect()
        job_id = self.ctx._last_job_id
        if not job_id:
            raise ExecutionError("no job id recorded for the profiled query")
        # the client can see completion before the scheduler finalizes
        # the job's profile window: retry while it is partial or absent
        deadline = _time.time() + 10.0
        sched = SchedulerClient(self.ctx.host, self.ctx.port)
        try:
            while True:
                try:
                    art = fetch_job_profile(self.ctx.host, self.ctx.port,
                                            job_id, client=sched)
                except ClusterError:
                    if _time.time() > deadline:
                        raise
                    _time.sleep(0.25)
                    continue
                if not (art.get("distributed") or {}).get("partial") or \
                        _time.time() > deadline:
                    break
                _time.sleep(0.25)
        finally:
            sched.close()
        if label:
            art["label"] = label
        return write_artifact_file(art, out_dir=obs_profiler.profile_dir(),
                                   out_path=path)

    def to_pandas(self):
        return self.collect()

    def count(self) -> int:
        agg = Aggregate([], [ex.count().alias("__n")], self.plan)
        if self.ctx.mode == "remote":
            return int(self.ctx._remote_collect(agg)["__n"][0])
        out, _ = self.ctx._standalone_collect(agg)
        return int(out["__n"][0])

    def show(self, n: int = 20) -> None:
        print(self.limit(n).collect().to_string())
