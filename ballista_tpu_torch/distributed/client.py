"""Remote client: submit plan, poll status, fetch results.

(reference: rust/client/src/context.rs:161-239 BallistaDataFrame::collect —
submit -> 100ms GetJobStatus poll -> Flight-fetch every result partition.)
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

from ..errors import (AdmissionRejected, ClusterError, PlanError,
                      QueryCancelled)
from ..proto import ballista_pb2 as pb
from .. import serde
from .dataplane import fetch_partition_bytes
from .scheduler import SchedulerClient

POLL_SECS = 0.1  # reference: 100ms, context.rs:183-201


def _deadline_secs(settings: Optional[Dict[str, str]]) -> float:
    """``job.deadline`` setting: server-side deadline in seconds (0 =
    none). Unlike ``job.timeout`` — which only bounds how long THIS
    client waits — the deadline rides ExecuteQueryParams and the
    scheduler's reap pass cancels the job once it expires, even when
    the submitting client is long gone."""
    raw = (settings or {}).get("job.deadline", 0)
    try:
        return max(float(raw), 0.0)
    except ValueError:
        raise ClusterError(f"invalid job.deadline setting: {raw!r} "
                           "(expected seconds as a number)") from None


def _job_id_or_shed(result: pb.ExecuteQueryResult) -> str:
    """Admission plane: a shed submission comes back with a structured
    retryable error instead of a live job id — raise it as
    :class:`AdmissionRejected` (``remote_collect`` honors the
    retry-after within the client's job timeout)."""
    if result.error:
        parsed = AdmissionRejected.parse(result.error)
        if parsed is not None:
            raise AdmissionRejected(parsed[0],
                                    result.retry_after_secs or parsed[1])
        raise ClusterError(result.error)
    return result.job_id


def submit_plan(host: str, port: int, logical_plan,
                settings: Optional[Dict[str, str]] = None) -> str:
    client = SchedulerClient(host, port)
    try:
        params = pb.ExecuteQueryParams()
        params.logical_plan.CopyFrom(serde.plan_to_proto(logical_plan))
        for k, v in (settings or {}).items():
            params.settings[k] = v
        params.deadline_secs = _deadline_secs(settings)
        return _job_id_or_shed(client.ExecuteQuery(params))
    finally:
        client.close()


def cancel_job(host: str, port: int, job_id: str,
               reason: str = "client") -> bool:
    """Cooperatively cancel a running job (CancelJob RPC). Returns True
    when this call moved the job to its terminal Cancelled state (False:
    unknown job or already terminal). Queued tasks are dropped at the
    scheduler; running tasks abort at their next batch boundary once
    their executor's poll carries the id."""
    client = SchedulerClient(host, port)
    try:
        res = client.CancelJob(
            pb.CancelJobParams(job_id=job_id, reason=reason))
        return res.cancelled
    finally:
        client.close()


def _cancel_on_timeout_enabled() -> bool:
    """``BALLISTA_CANCEL_ON_TIMEOUT`` (default on): a client-side job
    timeout issues a best-effort CancelJob before raising, so an
    abandoned client doesn't leak a running job. ``0``/``off`` restores
    the old abandon-the-job behavior."""
    return os.environ.get("BALLISTA_CANCEL_ON_TIMEOUT", "on").lower() \
        not in ("0", "off", "false", "no")


def _sql_references_table(sql: str, name: str) -> bool:
    """True when ``name`` appears in a table position (after FROM/JOIN or
    a FROM-list comma). Token-based so column aliases, string literals,
    and comments named like the table don't count."""
    from ..sql.lexer import tokenize

    try:
        toks = tokenize(sql)
    except Exception:
        return False  # unparseable here -> let the server report it
    lname = name.lower()
    prev = None
    in_from = False  # inside a FROM list, where commas introduce tables
    for t in toks:
        if t.kind == "kw":
            if t.value == "from":
                in_from = True
            elif t.value in ("where", "group", "having", "order", "limit",
                             "select", "on"):
                in_from = False
        if (t.kind == "ident" and t.value.lower() == lname and prev is not None
                and (prev.is_kw("from", "join") or
                     (in_from and prev.kind == "op" and prev.value == ","))):
            return True
        prev = t
    return False


def submit_sql(host: str, port: int, sql: str, catalog,
               settings: Optional[Dict[str, str]] = None) -> str:
    """Raw-SQL submission: the scheduler plans server-side against the
    catalog descriptors carried with the query (parity with the
    reference's sql-or-plan ExecuteQuery, rust/scheduler/src/lib.rs:
    236-247). ``catalog`` maps name -> sql.planner.CatalogTable."""
    client = SchedulerClient(host, port)
    try:
        params = pb.ExecuteQueryParams()
        params.sql = sql
        for k, v in (settings or {}).items():
            params.settings[k] = v
        for name, ct in (catalog or {}).items():
            if ct.source is None:
                # plan-backed view (register_table): views are planned
                # client-side and cannot ship as a source descriptor.
                # Fail here (actionably) if the query references it.
                if _sql_references_table(sql, name):
                    raise PlanError(
                        f"view {name!r} was registered from a DataFrame and "
                        "cannot be used with server-side SQL planning; plan "
                        "client-side (settings['plan.server']='off') or "
                        "register the underlying source instead"
                    )
                continue
            entry = params.catalog.add()
            entry.name = name
            entry.source.CopyFrom(
                serde.source_to_proto(ct.source, ct.primary_key)
            )
        params.deadline_secs = _deadline_secs(settings)
        return _job_id_or_shed(client.ExecuteQuery(params))
    finally:
        client.close()


def _emit_progress(result, job_id: str, on_progress, last: list,
                   status: str = "running") -> None:
    """Invoke the caller's progress callback from the status poll when
    the scheduler's snapshot changed. Best-effort: a raising callback
    is logged, never the query's problem."""
    if on_progress is None or not result.HasField("progress"):
        return
    from .. import serde as _serde

    snap = _serde.job_progress_from_proto(result.progress, job_id,
                                          status=status)
    from ..observability.progress import emit_if_changed, force_completed

    if status == "completed":
        # the client can observe the terminal KV before the tracker's
        # final snapshot freezes (the hook runs after the status save):
        # the terminal callback must still report exactly 1.0 — job
        # AND stage rows
        force_completed(snap)

    last[:] = [emit_if_changed(on_progress, snap,
                               last[-1] if last else None)]


def wait_for_job(host: str, port: int, job_id: str,
                 timeout: float = 300.0,
                 on_progress=None) -> pb.GetJobStatusResult:
    client = SchedulerClient(host, port)
    last: list = []
    try:
        deadline = time.time() + timeout
        while True:
            result = client.GetJobStatus(pb.GetJobStatusParams(job_id=job_id))
            which = result.status.WhichOneof("status")
            if which == "completed":
                # terminal callback: the tracker's frozen final
                # snapshot reports fraction exactly 1.0
                _emit_progress(result, job_id, on_progress, last,
                               status="completed")
                return result
            if which == "failed":
                # terminal callback carries the terminal status — a
                # progress UI must not show "running" as the job dies
                _emit_progress(result, job_id, on_progress, last,
                               status="failed")
                err = result.status.failed.error
                parsed = AdmissionRejected.parse(err)
                if parsed is not None or \
                        result.status.failed.retry_after_secs > 0:
                    # a queue-timeout shed: retryable by contract
                    reason, after = parsed or ("queue-timeout", 0.0)
                    raise AdmissionRejected(
                        reason,
                        result.status.failed.retry_after_secs or after,
                        job_id=job_id)
                raise ClusterError(
                    f"job {job_id} failed: {err}", job_id=job_id,
                )
            if which == "cancelled":
                # terminal Cancelled (client CancelJob, server deadline,
                # slow-query kill, drain): distinct from failure so
                # callers can tell "stopped on purpose" from "broke"
                _emit_progress(result, job_id, on_progress, last,
                               status="cancelled")
                raise QueryCancelled(
                    result.status.cancelled.reason or "unknown",
                    job_id=job_id,
                )
            # non-terminal: the snapshot's status mirrors the oneof
            # (queued jobs must not read "running" — ONE shape with
            # fetch_job_progress)
            _emit_progress(result, job_id, on_progress, last,
                           status="queued" if which == "queued"
                           else "running")
            if time.time() > deadline:
                if _cancel_on_timeout_enabled():
                    # best-effort: an abandoned client must not leak a
                    # running job burning executor slots; the job id on
                    # the error lets the caller inspect system.queries
                    try:
                        client.CancelJob(pb.CancelJobParams(
                            job_id=job_id, reason="timeout"))
                    except Exception:  # noqa: BLE001 - best-effort
                        pass
                raise ClusterError(
                    f"job {job_id} timed out after {timeout:.1f}s "
                    "(best-effort CancelJob issued; see system.queries)"
                    if _cancel_on_timeout_enabled() else
                    f"job {job_id} timed out after {timeout:.1f}s",
                    job_id=job_id,
                )
            time.sleep(POLL_SECS)
    finally:
        client.close()


def _job_timeout(settings: Optional[Dict[str, str]],
                 override: Optional[float]) -> float:
    """Seconds to wait for a remote job: explicit arg > ``job.timeout``
    setting > 300 (large-SF runs on few cores legitimately exceed the
    default)."""
    if override is not None:
        return override
    raw = (settings or {}).get("job.timeout", 300.0)
    try:
        return float(raw)
    except ValueError:
        raise ClusterError(f"invalid job.timeout setting: {raw!r} "
                           "(expected seconds as a number)") from None


class CancelRequested:
    """Sentinel ``BallistaContext.cancel()`` drops into an in-flight
    collect's job-id sink: a cancel that lands BETWEEN admission-retry
    attempts (the shed job is already terminal, so CancelJob had
    nothing to hit) must still stop the retry loop — resubmitting a
    query the user just cancelled breaks the cancel contract."""

    __slots__ = ("reason",)

    def __init__(self, reason: str = "client"):
        self.reason = reason


def _cancel_requested(job_id_out):
    return next((x for x in (job_id_out or [])
                 if isinstance(x, CancelRequested)), None)


def _admission_retry_enabled() -> bool:
    """``BALLISTA_ADMISSION_RETRY`` (default on): ``remote_collect``
    honors a shed's retry-after — sleep and resubmit within the
    client's job timeout. ``0``/``off`` surfaces the AdmissionRejected
    immediately (callers running their own backoff)."""
    return os.environ.get("BALLISTA_ADMISSION_RETRY", "on").lower() \
        not in ("0", "off", "false", "no")


def _collect_with_admission_retry(deadline_secs: float, submit_fn,
                                  wait_fn, job_id_out=None,
                                  cancel_fn=None):
    """One submit+wait attempt loop honoring admission retry-after:
    a shed (at the gate, or a queue-timeout mid-wait) sleeps the
    server's retry_after_secs and resubmits, as long as the NEXT
    attempt still fits inside the caller's job-timeout budget. The
    timeout stays one end-to-end bound across attempts — admission
    pressure never extends how long a caller can block.

    ``job_id_out`` is populated at SUBMIT time (and replaced on a
    resubmission): a concurrent ``ctx.cancel()`` must reach the job
    WHILE this thread waits on it, not after."""
    deadline_ts = time.time() + deadline_secs
    while True:
        mark = _cancel_requested(job_id_out)
        if mark is not None:
            raise QueryCancelled(mark.reason)
        try:
            job_id = submit_fn()
            if job_id_out is not None:
                # PRESERVE any sentinel a racing ctx.cancel() appended
                # while the submit RPC was in flight — a plain replace
                # would destroy it and the cancel would be lost
                job_id_out[:] = [x for x in job_id_out
                                 if isinstance(x, CancelRequested)] \
                    + [job_id]
            mark = _cancel_requested(job_id_out)
            if mark is not None:
                # the cancel raced the submit: the job exists but the
                # canceller's CancelJob pass never saw its id — issue
                # it here before raising
                if cancel_fn is not None:
                    try:
                        cancel_fn(job_id, mark.reason)
                    except Exception:  # noqa: BLE001 - best-effort
                        pass
                raise QueryCancelled(mark.reason, job_id=job_id)
            return job_id, wait_fn(job_id,
                                   max(deadline_ts - time.time(), 0.01))
        except AdmissionRejected as e:
            wait = min(max(e.retry_after_secs, 0.05), 30.0)
            if not _admission_retry_enabled() or \
                    time.time() + wait >= deadline_ts:
                raise
            time.sleep(wait)


def remote_collect(host: str, port: int, logical_plan,
                   settings: Optional[Dict[str, str]] = None,
                   timeout: Optional[float] = None,
                   metrics_out: Optional[list] = None,
                   job_id_out: Optional[list] = None,
                   on_progress=None):
    """Submit + poll + fetch -> pandas DataFrame. ``metrics_out``
    (when a list) receives the job's per-stage QueryMetrics, which ride
    the completed JobStatus (ctx.last_query_metrics()); ``job_id_out``
    receives the scheduler-assigned job id (the handle the distributed
    profiler's GetJobProfile / /debug/profile/<job_id> take);
    ``on_progress`` receives live progress snapshots off the status
    poll (the ONE shape — see observability/progress.py). Admission
    sheds are retried per their retry-after within the job timeout."""
    from ..execution import resolve_scalar_subqueries

    deadline = _job_timeout(settings, timeout)  # fail fast pre-submit
    logical_plan = resolve_scalar_subqueries(logical_plan)
    _job_id, result = _collect_with_admission_retry(
        deadline,
        lambda: submit_plan(host, port, logical_plan, settings),
        lambda jid, left: wait_for_job(host, port, jid, left,
                                       on_progress=on_progress),
        job_id_out=job_id_out,
        cancel_fn=lambda jid, reason: cancel_job(host, port, jid,
                                                 reason))
    _deliver_metrics(result, metrics_out)
    return _fetch_result_frames(result)


def remote_sql_collect(host: str, port: int, sql: str, catalog,
                       settings: Optional[Dict[str, str]] = None,
                       timeout: Optional[float] = None,
                       metrics_out: Optional[list] = None,
                       job_id_out: Optional[list] = None,
                       on_progress=None):
    """Raw-SQL round trip: submit SQL + catalog, poll, fetch."""
    deadline = _job_timeout(settings, timeout)  # fail fast pre-submit
    _job_id, result = _collect_with_admission_retry(
        deadline,
        lambda: submit_sql(host, port, sql, catalog, settings),
        lambda jid, left: wait_for_job(host, port, jid, left,
                                       on_progress=on_progress),
        job_id_out=job_id_out,
        cancel_fn=lambda jid, reason: cancel_job(host, port, jid,
                                                 reason))
    _deliver_metrics(result, metrics_out)
    return _fetch_result_frames(result)


def fetch_job_progress(host: str, port: int, job_id: str
                       ) -> Optional[dict]:
    """One live progress snapshot for a job (ctx.job_progress()):
    the extended GetJobStatus's progress field, or None when the
    scheduler's tracker doesn't know the job."""
    client = SchedulerClient(host, port)
    try:
        result = client.GetJobStatus(pb.GetJobStatusParams(job_id=job_id))
    finally:
        client.close()
    if not result.HasField("progress"):
        return None
    from .. import serde as _serde

    which = result.status.WhichOneof("status")
    status = {"queued": "queued", "running": "running",
              "completed": "completed", "failed": "failed",
              "cancelled": "cancelled"}.get(which, "unknown")
    snap = _serde.job_progress_from_proto(result.progress, job_id,
                                          status=status)
    if status == "completed":
        # same race as _emit_progress: the completed KV can be visible
        # before the tracker's finish() freezes (or while its TTL cache
        # holds a pre-terminal snapshot) — a completed job must never
        # read below 1.0
        from ..observability.progress import force_completed

        force_completed(snap)
    return snap


def fetch_job_profile(host: str, port: int, job_id: str,
                      client: "SchedulerClient | None" = None) -> dict:
    """Fetch the job's merged profile artifact from the scheduler
    (distributed profiler). Raises ClusterError when the scheduler
    holds no profile data for the job. Pass ``client`` to reuse one
    channel across a polling loop."""
    import json

    own = client is None
    if own:
        client = SchedulerClient(host, port)
    try:
        res = client.GetJobProfile(pb.GetJobProfileParams(job_id=job_id))
    finally:
        if own:
            client.close()
    if res.error:
        raise ClusterError(res.error)
    return json.loads(res.artifact_json.decode())


def fetch_system_table(host: str, port: int, table: str) -> list:
    """Fetch one system.* table's rows from the scheduler's snapshot
    (GetSystemTable RPC) — what a remote context's system-table scans
    read, so they see cluster state instead of the client process."""
    import json

    client = SchedulerClient(host, port)
    try:
        res = client.GetSystemTable(pb.GetSystemTableParams(table=table))
    finally:
        client.close()
    if res.error:
        raise ClusterError(res.error)
    return json.loads(res.rows_json.decode())


def _deliver_metrics(result: pb.GetJobStatusResult,
                     metrics_out: Optional[list]) -> None:
    if metrics_out is None:
        return
    sm = result.status.completed.stage_metrics
    if sm:
        from ..observability.metrics import QueryMetrics

        metrics_out.append(QueryMetrics(serde.stage_metrics_from_proto(sm)))


def _fetch_result_frames(result: pb.GetJobStatusResult):
    import pandas as pd

    from ..io import ipc
    locations = sorted(
        result.status.completed.partition_location,
        key=lambda l: l.partition_id.partition_id,
    )
    # latency ledger: the client envelope separates moving result bytes
    # (result_transfer) from turning them into host arrays/DataFrames
    # (host_decode); stamps no-op outside an active collect window
    from ..observability.ledger import ledger_phase

    frames = []
    for loc in locations:
        with ledger_phase("result_transfer"):
            if loc.path and os.path.exists(loc.path):
                raw = open(loc.path, "rb").read()
            else:
                raw = fetch_partition_bytes(
                    loc.executor_meta.host, loc.executor_meta.port,
                    loc.partition_id.job_id, loc.partition_id.stage_id,
                    loc.partition_id.partition_id,
                )
        with ledger_phase("host_decode"):
            names, arrays, nulls, dicts, kinds = \
                ipc.read_partition_arrays(raw)
            cols = {}
            for name in names:
                kind, scale = kinds.get(name, ("", 0))
                from ..columnar import decode_physical_array

                if kind.startswith("list:"):
                    from ..columnar import decode_list_rows

                    cols[name] = decode_list_rows(
                        arrays[name], kind.split(":", 1)[1], scale,
                        nulls[name]
                    )
                    continue
                cols[name] = decode_physical_array(
                    arrays[name],
                    "utf8" if name in dicts else kind,
                    scale,
                    dicts.get(name),
                    nulls[name],
                )
            frames.append(pd.DataFrame(cols))
    if not frames:
        return pd.DataFrame()
    with ledger_phase("host_decode"):
        return pd.concat(frames, ignore_index=True)
