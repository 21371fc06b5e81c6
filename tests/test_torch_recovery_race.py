"""The port's scheduler stops its planning threads with the cluster.

``SchedulerService`` plans each admitted job on a thread of its own,
which writes the stage rows, the task rows, the ready queue and, last,
the journal's planned marker. ``LocalCluster.shutdown`` used to return
while such a thread was still writing, so a scheduler rebuilt over the
same sqlite file could run ``recover()`` on a half-written plan: it
found no planned marker, replayed the planning, and the job it should
have resumed counted as relaunched
(``test_torch_cluster_twins.py::test_recovery_over_sqlite_finishes_the_job``
under load). Here a delay on every task-row write (the ``state.save``
fault point) holds the planning thread inside that window on every run.
"""

import threading
import time

import numpy as np
import pandas as pd
import pytest

from ballista_tpu_torch import Int64, Utf8, col, schema, serde, sum_
from ballista_tpu_torch.distributed.executor import LocalCluster
from ballista_tpu_torch.distributed.scheduler import SchedulerService
from ballista_tpu_torch.distributed.state import (MemoryBackend,
                                                  SchedulerState,
                                                  SqliteBackend)
from ballista_tpu_torch.io import TblSource
from ballista_tpu_torch.logical import LogicalPlanBuilder
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.testing.faults import reload_faults

from torch_warm_path import pinned_threads

ROWS, PARTS = 120, 2
SAVE_DELAY_MS = 150


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """One torch, ingest and scanner thread, as in the other cluster
    files."""
    with pinned_threads(1):
        yield


@pytest.fixture
def slow_task_rows(monkeypatch):
    """Every task-row write of the scheduler's state sleeps."""
    monkeypatch.setenv("BALLISTA_FAULTS",
                       f"state.save=delay:{SAVE_DELAY_MS}")
    reload_faults()
    yield
    monkeypatch.delenv("BALLISTA_FAULTS")
    reload_faults()


def _table(tmp_path):
    d = tmp_path / "t"
    d.mkdir(exist_ok=True)
    for part in range(PARTS):
        lines = [f"{i}|k{i % 7}|" for i in range(ROWS) if i % PARTS == part]
        (d / f"part{part}.tbl").write_text("\n".join(lines) + "\n")
    return TblSource(str(d), schema(("a", Int64), ("c", Utf8)),
                     device="cpu")


def _params(src):
    plan = (LogicalPlanBuilder.scan("t", src)
            .aggregate([col("c")], [sum_(col("a")).alias("s")])
            .build())
    params = pb.ExecuteQueryParams()
    params.logical_plan.CopyFrom(serde.plan_to_proto(plan))
    return params


def _wait_until(cond, timeout: float, msg: str):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(msg)


def _expected_sums() -> pd.DataFrame:
    df = pd.DataFrame({"a": range(ROWS),
                       "c": [f"k{i % 7}" for i in range(ROWS)]})
    return (df.groupby("c", as_index=False)["a"].sum()
            .rename(columns={"a": "s"}).sort_values("c")
            .reset_index(drop=True))


def test_shutdown_leaves_a_planned_job_for_recovery(tmp_path,
                                                    slow_task_rows):
    """Shut down after the first stage row, while task rows are still
    being written: the restarted scheduler resumes the job (inflight,
    not relaunched) and runs it to the right sums."""
    from ballista_tpu_torch.distributed.client import (_fetch_result_frames,
                                                       wait_for_job)

    db = str(tmp_path / "state.db")
    src = _table(tmp_path)
    first = LocalCluster(num_executors=0, device="cpu",
                         backend=SqliteBackend(db))
    try:
        job = first.service.ExecuteQuery(_params(src)).job_id
        _wait_until(lambda: first.state.stage_ids(job), 10,
                    "planning never wrote a stage")
        assert not first.service.journal.is_planned(job)  # mid-plan
    finally:
        first.shutdown()
    assert first.service.journal.is_planned(job)
    assert not first.service._planning_threads
    second = LocalCluster(num_executors=1, concurrent_tasks=2,
                          device="cpu", backend=SqliteBackend(db))
    try:
        rep = second.service.recover()
        assert rep.jobs_inflight == 1 and rep.relaunched == 0
        assert not rep.errors
        res = wait_for_job("localhost", second.port, job, timeout=60)
        got = _fetch_result_frames(res).sort_values("c").reset_index(
            drop=True)
    finally:
        second.shutdown()
    exp = _expected_sums()
    np.testing.assert_array_equal(got["c"], exp["c"])
    np.testing.assert_array_equal(got["s"], exp["s"])


def test_join_planning_is_bounded(tmp_path):
    """A planning thread that does not end within the bound leaves
    ``join_planning`` False after about the bound, and True once it
    ends."""
    svc = SchedulerService(SchedulerState(MemoryBackend()), device="cpu")
    release = threading.Event()
    started = threading.Event()

    def stuck_plan(*args):
        started.set()
        release.wait(30)

    svc._plan_job = stuck_plan
    try:
        svc._launch_job(("job-x", None, {}, None, None))
        assert started.wait(10)
        t0 = time.monotonic()
        assert svc.join_planning(timeout=0.3) is False
        assert 0.25 <= time.monotonic() - t0 < 5
    finally:
        release.set()
    assert svc.join_planning(timeout=10) is True
    assert not svc._planning_threads
    svc.close_health()
