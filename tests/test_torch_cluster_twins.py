"""The JAX package's cluster tests that touch the cluster path, as twins
on the port (``LocalCluster(device="cpu")``), with the same inputs and
expectations:

- ``tests/test_distributed.py``: ``test_poll_work_direct``,
  ``test_cluster_query_end_to_end`` and
  ``test_cluster_shuffle_over_sockets_only`` (cases of
  ``test_cluster_group_by``: they differ only in how shuffle files are
  read; a third case has the scheduler plan the SQL text, as
  ``tests/test_server_sql.py`` does), ``test_cluster_join_query``,
  ``test_cluster_hash_repartition_shuffle`` and
  ``test_cluster_task_failure_fails_job``;
- ``tests/test_adaptive.py``: ``test_cluster_coalesce_dispatches_fewer_tasks``,
  ``test_cluster_join_demotion`` and ``test_cluster_skew_split``;
- ``tests/test_admission.py``:
  ``test_quota_queues_with_visible_position_then_admits``;
- restart recovery over ``SqliteBackend``: a job accepted and planned by
  one cluster whose scheduler then stops is run to completion by a
  ``LocalCluster`` rebuilt over the same file
  (``tests/test_controlplane.py``'s recovery, end to end);
- a remote context's progress, per-stage metrics and ``df.profile()``;
- cancel of a running cluster job (``tests/test_lifecycle.py``'s
  mid-stage cancel): the collect raises ``QueryCancelled``, the job is
  terminal ``cancelled`` in ``system.queries``, the executors drop its
  outputs and a follow-up query on the same cluster is right.

Tolerances: as in the JAX package's tests (exact for ints and strings,
rtol 1e-9 for decimal sums read back as floats).
"""

import os
import threading
import time

import numpy as np
import pandas as pd
import pytest

from ballista_tpu_torch import Decimal, Int64, Utf8, col, count, schema, sum_
from ballista_tpu_torch import serde
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.distributed.executor import LocalCluster
from ballista_tpu_torch.distributed.scheduler import SchedulerService
from ballista_tpu_torch.distributed.state import (MemoryBackend,
                                                  SchedulerState,
                                                  SqliteBackend)
from ballista_tpu_torch.errors import ClusterError, QueryCancelled
from ballista_tpu_torch.io import TblSource
from ballista_tpu_torch.logical import LogicalPlanBuilder
from ballista_tpu_torch.physical.shuffle import ShuffleReaderExec
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.testing.faults import reload_faults

from torch_warm_path import pinned_threads


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """One torch, ingest and scanner thread: a cluster runs up to four
    tasks at once, and the tier's timing-gated tests share the cores."""
    with pinned_threads(1):
        yield


@pytest.fixture(scope="module")
def cluster():
    c = LocalCluster(num_executors=2, concurrent_tasks=2, device="cpu")
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def serial_cluster():
    """One executor, one slot: a completed build side reliably precedes
    any probe-side dispatch (the join-demotion window)."""
    c = LocalCluster(num_executors=1, concurrent_tasks=1, device="cpu")
    yield c
    c.shutdown()


def _remote(c, **settings):
    return BallistaContext.remote("localhost", c.port, device="cpu",
                                  **settings)


def _mem_table(tmp_path):
    p = tmp_path / "t.tbl"
    lines = [f"{i}|{(i % 7) + 0.25:.2f}|k{i % 3}|" for i in range(100)]
    p.write_text("\n".join(lines) + "\n")
    s = schema(("a", Int64), ("b", Decimal(2)), ("c", Utf8))
    return TblSource(str(p), s, device="cpu")


def _expected_groups():
    a = np.arange(100)
    return (pd.DataFrame({"c": [f"k{i % 3}" for i in a],
                          "b": (a % 7) + 0.25})
            .groupby("c").agg(s=("b", "sum"), n=("b", "size"))
            .reset_index().sort_values("c"))


def _write_tbl(path, rows):
    with open(path, "w") as fh:
        for r in rows:
            fh.write("|".join(str(x) for x in r) + "|\n")


def _wait_until(cond, timeout: float, msg: str):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(msg)


# ---------------------------------------------------------------------------
# tests/test_distributed.py
# ---------------------------------------------------------------------------


def test_poll_work_direct(tmp_path):
    svc = SchedulerService(SchedulerState(MemoryBackend()))
    src = _mem_table(tmp_path)
    plan = (LogicalPlanBuilder.scan("t", src)
            .aggregate([col("c")], [sum_(col("b")).alias("s")])
            .build())
    params = pb.ExecuteQueryParams()
    params.logical_plan.CopyFrom(serde.plan_to_proto(plan))
    job_id = svc.ExecuteQuery(params).job_id
    assert len(job_id) == 7
    _wait_until(lambda: svc.state.stage_ids(job_id), 10,
                "planning never finished")
    poll = pb.PollWorkParams(can_accept_task=True)
    poll.metadata.id = "e1"
    poll.metadata.host = "localhost"
    poll.metadata.port = 7777
    result = svc.PollWork(poll)
    assert result.HasField("task")
    assert result.task.task_id.job_id == job_id
    got = svc.GetExecutorsMetadata(pb.GetExecutorsMetadataParams())
    assert [e.id for e in got.metadata] == ["e1"]
    svc.close_health()


@pytest.mark.parametrize("sockets_only,settings", [
    (False, {}), (True, {}), (False, {"plan.server": "on"})],
    ids=["end_to_end", "shuffle_over_sockets_only", "server_planned_sql"])
def test_cluster_group_by(cluster, tmp_path, monkeypatch, sockets_only,
                          settings):
    """``test_cluster_query_end_to_end``; with every shuffle fetch forced
    over the data-plane socket (``test_cluster_shuffle_over_sockets_only``);
    and with the SQL text planned by the scheduler (``plan.server``,
    ``remote_sql_collect``)."""
    monkeypatch.setattr(ShuffleReaderExec, "FORCE_REMOTE", sockets_only)
    ctx = _remote(cluster, **settings)
    ctx.register_source("t", _mem_table(tmp_path))
    got = ctx.sql("select c, sum(b) as s, count(*) as n from t "
                  "group by c order by c").collect()
    exp = _expected_groups()
    np.testing.assert_array_equal(got["c"], exp["c"])
    np.testing.assert_allclose(got["s"], exp["s"], rtol=1e-9)
    np.testing.assert_array_equal(got["n"], exp["n"])


def test_remote_progress_metrics_and_profile(cluster, tmp_path):
    """What a remote context asks the scheduler for after a query: the
    job's progress (complete), its per-stage metrics, and the merged
    profile artifact of ``df.profile()``."""
    import json

    ctx = _remote(cluster)
    ctx.register_source("t", _mem_table(tmp_path))
    df = ctx.sql("select c, count(*) as n from t group by c")
    path = df.profile(str(tmp_path / "profile.json"))
    job = ctx._last_job_id
    snap = ctx.job_progress()
    assert snap["job_id"] == job and snap["fraction"] == 1.0, snap
    qm = ctx.last_query_metrics()
    assert qm is not None and qm.stage_ids() == sorted(
        cluster.state.stage_ids(job))
    with open(path) as fh:
        art = json.load(fh)
    assert art["traceEvents"], sorted(art)


def test_cluster_join_query(cluster, tmp_path):
    d = tmp_path / "dim.tbl"
    d.write_text("".join(f"{i}|cat{i % 2}|\n" for i in range(3)))
    f = tmp_path / "fact.tbl"
    f.write_text("".join(f"{i}|{i % 3}|{i + 0.5:.2f}|\n" for i in range(30)))
    dim_s = schema(("dkey", Int64), ("cat", Utf8))
    fact_s = schema(("fid", Int64), ("fkey", Int64), ("v", Decimal(2)))
    ctx = _remote(cluster)
    ctx.register_source("dim", TblSource(str(d), dim_s, device="cpu"),
                        primary_key="dkey")
    ctx.register_source("fact", TblSource(str(f), fact_s, device="cpu"))
    got = ctx.sql("select cat, sum(v) as sv from fact, dim "
                  "where fkey = dkey group by cat order by cat").collect()
    a = np.arange(30)
    fact_df = pd.DataFrame({"fkey": a % 3, "v": a + 0.5})
    fact_df["cat"] = fact_df.fkey.map(lambda k: f"cat{k % 2}")
    exp = fact_df.groupby("cat").v.sum().reset_index().sort_values("cat")
    np.testing.assert_array_equal(got["cat"], exp["cat"])
    np.testing.assert_allclose(got["sv"], exp["v"], rtol=1e-9)


def test_cluster_hash_repartition_shuffle(cluster, tmp_path):
    ctx = _remote(cluster)
    ctx.register_source("t", _mem_table(tmp_path))
    df = (ctx.table("t").repartition(3, [col("c")])
          .aggregate([col("c")], [sum_(col("b")).alias("s"),
                                  count().alias("n")])
          .sort(col("c")))
    got = df.collect()
    exp = _expected_groups()
    np.testing.assert_array_equal(got["c"], exp["c"])
    np.testing.assert_allclose(got["s"], exp["s"], rtol=1e-9)
    np.testing.assert_array_equal(got["n"], exp["n"])


def test_cluster_task_failure_fails_job(cluster, tmp_path):
    p = tmp_path / "bad.tbl"
    p.write_text("1|\nnot-a-number|\n")  # parse error at execution time
    ctx = _remote(cluster)
    ctx.register_source("bad", TblSource(str(p), schema(("a", Int64)),
                                         device="cpu"))
    with pytest.raises(ClusterError, match="failed"):
        ctx.sql("select sum(a) as s from bad").collect()


# ---------------------------------------------------------------------------
# tests/test_adaptive.py
# ---------------------------------------------------------------------------


def _submit(port, df, settings):
    from ballista_tpu_torch.distributed.client import (_fetch_result_frames,
                                                       submit_plan,
                                                       wait_for_job)
    from ballista_tpu_torch.execution import resolve_scalar_subqueries

    job = submit_plan("localhost", port,
                      resolve_scalar_subqueries(df.plan), settings)
    res = wait_for_job("localhost", port, job, timeout=120)
    return job, _fetch_result_frames(res)


def _task_counts(state, job):
    return {sid: len(state.get_task_statuses(job, sid))
            for sid in state.stage_ids(job)}


def test_cluster_coalesce_dispatches_fewer_tasks(cluster, tmp_path):
    p = tmp_path / "t.tbl"
    _write_tbl(p, [(i, f"{(i % 7) + 0.25:.2f}", f"k{i % 5}")
                   for i in range(1000)])
    src = TblSource(str(p), schema(("a", Int64), ("b", Decimal(2)),
                                   ("c", Utf8)), device="cpu")
    results, counts = {}, {}
    for label, settings in (("on", {}), ("off", {"adaptive.enabled": "0"})):
        ctx = _remote(cluster, **settings)
        ctx.register_source("t", src)
        df = ctx.table("t").repartition(8, [col("c")]).aggregate(
            [col("c")], [sum_(col("b")).alias("s")])
        job, frame = _submit(cluster.port, df, ctx.settings)
        results[label] = frame.sort_values("c").reset_index(drop=True)
        counts[label] = _task_counts(cluster.state, job)
        if label == "on":
            shuffle_sid = min(counts[label])
            t = cluster.state.get_task_statuses(job, shuffle_sid)[0]
            assert len(t.stats["shuffle_partition_bytes"]) == 8
            replanned = [sid for sid in cluster.state.stage_ids(job)
                         if cluster.state.get_stage_plan(job, sid).version]
            assert replanned, "no stage was adaptively re-planned"
    assert sum(counts["on"].values()) < sum(counts["off"].values())
    assert max(counts["off"].values()) == 8
    np.testing.assert_array_equal(results["on"]["c"], results["off"]["c"])
    np.testing.assert_allclose(results["on"]["s"], results["off"]["s"],
                               rtol=1e-9)


def _register_join_tables(ctx, tmp_path):
    dim = tmp_path / "dim.tbl"
    if not dim.exists():
        _write_tbl(dim, [(i, f"cat{i % 4}") for i in range(50)])
    fact = tmp_path / "fact.tbl"
    if not fact.exists():
        _write_tbl(fact, [(i, i % 50, f"{(i % 9) + 0.5:.2f}")
                          for i in range(5000)])
    ctx.register_source("dim", TblSource(
        str(dim), schema(("dkey", Int64), ("cat", Utf8)), device="cpu"),
        primary_key="dkey")
    ctx.register_source("fact", TblSource(
        str(fact), schema(("fid", Int64), ("fkey", Int64),
                          ("v", Decimal(2))), device="cpu"))


def test_cluster_join_demotion(serial_cluster, tmp_path):
    sql = ("select cat, sum(v) as sv from fact, dim "
           "where fkey = dkey and fid < 30 group by cat order by cat")
    frames = {}
    for label, settings in (
        ("on", {"join.partitioned.threshold": "10"}),
        ("off", {"join.partitioned.threshold": "10",
                 "adaptive.enabled": "false"}),
    ):
        ctx = _remote(serial_cluster, **settings)
        _register_join_tables(ctx, tmp_path)
        job, frame = _submit(serial_cluster.port, ctx.sql(sql), ctx.settings)
        frames[label] = frame.sort_values("cat").reset_index(drop=True)
        if label == "on":
            state = serial_cluster.state
            versions = {sid: state.get_stage_plan(job, sid).version
                        for sid in state.stage_ids(job)}
            assert sum(1 for v in versions.values() if v > 0) >= 2, versions
            specless = [sid for sid in state.stage_ids(job)
                        if versions[sid] > 0
                        and state.get_stage_plan(job, sid).shuffle_spec
                        is None]
            assert specless, versions
            probe_sid = specless[0]
            consumer = next(
                sid for sid in state.stage_ids(job)
                if (state.get_stage_plan(job, sid).reader_layouts or {})
                .get(probe_sid))
            layout = state.get_stage_plan(
                job, consumer).reader_layouts[probe_sid]
            assert all(len(ranges) == 1 and ranges[0][3] == ranges[0][2] + 1
                       for ranges in layout), layout
    np.testing.assert_array_equal(frames["on"]["cat"], frames["off"]["cat"])
    np.testing.assert_allclose(frames["on"]["sv"], frames["off"]["sv"],
                               rtol=1e-9)


def test_cluster_skew_split(cluster, tmp_path):
    dim_dir = tmp_path / "dimskew"
    dim_dir.mkdir()
    for part in range(2):  # 2 scan partitions -> 2 shuffle producers
        _write_tbl(dim_dir / f"{part}.tbl",
                   [(7 if i % 10 else i % 50, f"s{i % 6}")
                    for i in range(1500)])
    fact = tmp_path / "factskew.tbl"
    _write_tbl(fact, [(i, i % 50, f"{(i % 9) + 0.5:.2f}")
                      for i in range(5000)])
    dim_s = schema(("dkey", Int64), ("seg", Utf8))
    fact_s = schema(("fid", Int64), ("fkey", Int64), ("v", Decimal(2)))
    sql = ("select seg, sum(v) as sv from fact, dim "
           "where fkey = dkey group by seg order by seg")
    frames = {}
    for label, settings in (
        ("on", {"join.partitioned.threshold": "100",
                "adaptive.broadcast": "off",
                "adaptive.target_partition_bytes": "4000",
                "adaptive.skew_factor": "2"}),
        ("off", {"join.partitioned.threshold": "100",
                 "adaptive.enabled": "off"}),
    ):
        ctx = _remote(cluster, **settings)
        ctx.register_source("dim", TblSource(str(dim_dir), dim_s,
                                             device="cpu"))
        ctx.register_source("fact", TblSource(str(fact), fact_s,
                                              device="cpu"))
        job, frame = _submit(cluster.port, ctx.sql(sql), ctx.settings)
        frames[label] = frame.sort_values("seg").reset_index(drop=True)
        if label == "on":
            state = cluster.state
            layouts = [state.get_stage_plan(job, sid).reader_layouts
                       for sid in state.stage_ids(job)
                       if state.get_stage_plan(job, sid).reader_layouts]
            assert layouts, "no adaptive reader layout was recorded"
            assert any(r[3] != 0 for layout in layouts
                       for dep in layout.values()
                       for ranges in dep for r in ranges), layouts
    np.testing.assert_array_equal(frames["on"]["seg"], frames["off"]["seg"])
    np.testing.assert_allclose(frames["on"]["sv"], frames["off"]["sv"],
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# admission, recovery, cancel
# ---------------------------------------------------------------------------


def _agg_params(src, settings=None):
    plan = (LogicalPlanBuilder.scan("t", src)
            .aggregate([col("c")], [sum_(col("a")).alias("s")])
            .build())
    params = pb.ExecuteQueryParams()
    params.logical_plan.CopyFrom(serde.plan_to_proto(plan))
    for k, v in (settings or {}).items():
        params.settings[k] = v
    return params


def _parts_table(tmp_path, rows: int = 120, parts: int = 2):
    d = tmp_path / "t"
    d.mkdir(exist_ok=True)
    for part in range(parts):
        lines = [f"{i}|k{i % 7}|" for i in range(rows) if i % parts == part]
        (d / f"part{part}.tbl").write_text("\n".join(lines) + "\n")
    return TblSource(str(d), schema(("a", Int64), ("c", Utf8)),
                     device="cpu")


def _expected_sums(rows: int = 120) -> pd.DataFrame:
    df = pd.DataFrame({"a": range(rows),
                       "c": [f"k{i % 7}" for i in range(rows)]})
    return (df.groupby("c", as_index=False)["a"].sum()
            .rename(columns={"a": "s"}).sort_values("c")
            .reset_index(drop=True))


def test_quota_queues_with_visible_position_then_admits(tmp_path):
    svc = SchedulerService(SchedulerState(MemoryBackend()))
    src = _parts_table(tmp_path)
    s = {"session.id": "sess-q", "admission.max_session_jobs": "1"}
    r1 = svc.ExecuteQuery(_agg_params(src, s))
    r2 = svc.ExecuteQuery(_agg_params(src, s))
    assert not r1.error and not r2.error
    _wait_until(lambda: svc.state.stage_ids(r1.job_id), 10,
                "first job never planned")
    gs = svc.GetJobStatus(pb.GetJobStatusParams(job_id=r2.job_id))
    assert gs.status.WhichOneof("status") == "queued"
    assert gs.status.queued.queue_position == 1
    assert gs.status.queued.reason == "session-concurrency"
    assert svc.state.stage_ids(r2.job_id) == []  # planning deferred
    rows = {r["job_id"]: r
            for r in svc.systables.table_rows("system.queries")}
    assert rows[r2.job_id]["status"] == "queued"
    assert rows[r2.job_id]["queue_position"] == 1
    svc.CancelJob(pb.CancelJobParams(job_id=r1.job_id, reason="client"))
    _wait_until(lambda: svc.admission.queue_depth() == 0
                and svc.state.stage_ids(r2.job_id), 10,
                "queued job never admitted after slot freed")
    svc.CancelJob(pb.CancelJobParams(job_id=r2.job_id, reason="client"))
    svc.close_health()


def test_recovery_over_sqlite_finishes_the_job(tmp_path):
    from ballista_tpu_torch.distributed.client import (_fetch_result_frames,
                                                       wait_for_job)

    db = str(tmp_path / "state.db")
    src = _parts_table(tmp_path)
    first = LocalCluster(num_executors=0, device="cpu",
                         backend=SqliteBackend(db))
    try:
        job = first.service.ExecuteQuery(_agg_params(src)).job_id
        _wait_until(lambda: first.state.stage_ids(job), 10,
                    "planning never finished")
    finally:
        first.shutdown()  # no executor ever ran a task: the job is live
    second = LocalCluster(num_executors=1, concurrent_tasks=2,
                          device="cpu", backend=SqliteBackend(db))
    try:
        rep = second.service.recover()
        assert rep.jobs_inflight == 1 and not rep.errors
        res = wait_for_job("localhost", second.port, job, timeout=60)
        got = _fetch_result_frames(res).sort_values("c").reset_index(
            drop=True)
    finally:
        second.shutdown()
    exp = _expected_sums()
    np.testing.assert_array_equal(got["c"], exp["c"])
    np.testing.assert_array_equal(got["s"], exp["s"])


def test_cancel_a_running_cluster_job(cluster, tmp_path, monkeypatch):
    monkeypatch.setenv("BALLISTA_FAULTS", "executor.task.start=delay:800")
    reload_faults()
    try:
        ctx = _remote(cluster)
        ctx.register_source("t", _parts_table(tmp_path))
        df = ctx.sql("select c, sum(a) as s from t group by c")
        box = {}

        def run():
            try:
                box["out"] = df.collect()
            except BaseException as e:  # noqa: BLE001 - checked below
                box["err"] = e

        t = threading.Thread(target=run)
        t.start()
        _wait_until(lambda: any(e._task_tokens for e in cluster.executors),
                    30, "no task started")
        assert ctx.cancel("test") == 1
        t.join(timeout=60)
        assert not t.is_alive()
        assert isinstance(box.get("err"), QueryCancelled), box
        job = ctx._last_job_id or box["err"].job_id
        _wait_until(lambda: not any(e._task_tokens
                                    for e in cluster.executors), 30,
                    "cancelled tasks still hold their slots")
        for e in cluster.executors:
            assert not os.path.exists(os.path.join(e.config.work_dir, job))
    finally:
        monkeypatch.delenv("BALLISTA_FAULTS")
        reload_faults()
    rows = ctx.sql("select job_id, status, cancel_reason from "
                   "system.queries").to_pydict()
    mine = [i for i, j in enumerate(rows["job_id"]) if j == job]
    assert mine and rows["status"][mine[-1]] == "cancelled"
    assert rows["cancel_reason"][mine[-1]] == "test"
    got = ctx.sql("select c, sum(a) as s from t group by c "
                  "order by c").collect()
    exp = _expected_sums()
    np.testing.assert_array_equal(got["c"], exp["c"])
    np.testing.assert_array_equal(got["s"], exp["s"])
