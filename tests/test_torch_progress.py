"""Standalone live progress in the port (``df.to_pydict(on_progress=)``,
``df.collect(on_progress=)``, ``ctx.job_progress()``:
``observability/progress.py``'s ``LocalProgressSampler`` and the
collect's query handle) against the JAX package's, on the CPU over the
same slow in-memory table (each partition's scan sleeps, so the sampler
sees the query in flight) and on TPC-H SF0.002 q5:

- every snapshot has the JAX package's keys (``JOB_PROGRESS_KEYS``,
  ``STAGE_PROGRESS_KEYS``, equal in both packages), the fractions never
  fall, and the last snapshot is ``completed`` with fraction exactly 1.0
  and one completed task, as the JAX package's last snapshot is;
- the result with a sampler equals the result without one;
- ``ctx.job_progress()`` from another thread sees the in-flight collect
  in the same shape, and returns None for an unknown job;
- a failing collect's last snapshot is ``failed``.
"""

import threading
import time

import numpy as np
import pytest

from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.datatypes import Int64, Utf8, schema
from ballista_tpu_torch.io.memory import MemTableSource
from ballista_tpu_torch.observability import progress as port_progress

from torch_warm_path import generate_tpch, pinned_threads, port_ctx, sql

ROWS, PARTS = 6000, 4
DATA = {"a": list(range(ROWS)), "c": [f"k{i % 7}" for i in range(ROWS)]}
QUERY = "select c, sum(a) as s from t group by c order by c"


@pytest.fixture(scope="module", autouse=True)
def _pinned():
    with pinned_threads(2):
        yield


@pytest.fixture
def fast_interval(monkeypatch):
    monkeypatch.setenv("BALLISTA_PROGRESS_INTERVAL_SECS", "0.05")


def _slow_port_ctx(delay: float = 0.12):
    class Slow(MemTableSource):
        def scan(self, p, projection=None):
            time.sleep(delay)
            return super().scan(p, projection)

    inner = MemTableSource.from_pydict(
        schema(("a", Int64), ("c", Utf8)), DATA, num_partitions=PARTS,
        device="cpu")
    ctx = BallistaContext.standalone(device="cpu")
    ctx.register_source("t", Slow(inner._schema, inner._partitions))
    return ctx


def _slow_reference_ctx(delay: float = 0.12):
    from ballista_tpu import Int64 as RInt64, Utf8 as RUtf8, schema as rs
    from ballista_tpu.client import BallistaContext as ReferenceContext
    from ballista_tpu.io.memory import MemTableSource as RMem

    class Slow(RMem):
        def scan(self, p, projection=None):
            time.sleep(delay)
            return super().scan(p, projection)

    inner = RMem.from_pydict(rs(("a", RInt64), ("c", RUtf8)), DATA,
                             num_partitions=PARTS)
    ctx = ReferenceContext.standalone()
    ctx.register_source("t", Slow(inner._schema, inner._partitions))
    return ctx


def _assert_shape(snap: dict) -> None:
    assert set(snap) == set(port_progress.JOB_PROGRESS_KEYS), snap.keys()
    for st in snap["stages"]:
        assert set(st) == set(port_progress.STAGE_PROGRESS_KEYS), st.keys()


def test_snapshot_keys_equal_reference():
    from ballista_tpu.observability import progress as ref_progress

    assert port_progress.JOB_PROGRESS_KEYS == ref_progress.JOB_PROGRESS_KEYS
    assert port_progress.STAGE_PROGRESS_KEYS == \
        ref_progress.STAGE_PROGRESS_KEYS


@pytest.mark.parametrize("frame", [False, True],
                         ids=["to_pydict", "collect"])
def test_on_progress_shape_and_final_fraction(fast_interval, frame):
    ctx = _slow_port_ctx()
    samples = []
    df = ctx.sql(QUERY)
    out = (df.collect(on_progress=samples.append) if frame
           else df.to_pydict(on_progress=samples.append))
    assert list(out["c"]) == [f"k{i}" for i in range(7)]
    assert len(samples) >= 2, samples
    for s in samples:
        _assert_shape(s)
    fractions = [s["fraction"] for s in samples]
    assert fractions == sorted(fractions), fractions
    last = samples[-1]
    assert last["fraction"] == 1.0 and last["status"] == "completed"
    assert last["stages"][0]["tasks_completed"] == 1
    assert last["job_id"] == ctx.last_query_ledger()["job_id"]
    # the JAX package's last snapshot of the same query
    ref_samples = []
    ref_out = _slow_reference_ctx().sql(QUERY).collect(
        on_progress=ref_samples.append)
    assert list(ref_out["s"]) == list(out["s"])
    ref_last = ref_samples[-1]
    for key in ("status", "fraction"):
        assert last[key] == ref_last[key]
    assert [(st["stage_id"], st["tasks_total"], st["tasks_completed"])
            for st in last["stages"]] == \
        [(st["stage_id"], st["tasks_total"], st["tasks_completed"])
         for st in ref_last["stages"]]


def test_result_with_the_sampler_equals_without(fast_interval, tmp_path):
    data_dir = generate_tpch(str(tmp_path))
    ctx = port_ctx(data_dir)
    plain = ctx.sql(sql("q5")).to_pydict()
    fresh = port_ctx(data_dir)
    samples = []
    sampled = fresh.sql(sql("q5")).to_pydict(on_progress=samples.append)
    assert list(sampled) == list(plain)
    for c in plain:
        assert list(sampled[c]) == list(plain[c]), c
    assert samples and samples[-1]["fraction"] == 1.0


def test_job_progress_sees_the_collect_in_flight(fast_interval):
    ctx = _slow_port_ctx(delay=0.25)
    box = {}

    def run():
        try:
            box["out"] = ctx.sql("select sum(a) as s from t").to_pydict()
        except BaseException as e:  # noqa: BLE001
            box["err"] = e

    th = threading.Thread(target=run)
    th.start()
    seen = None
    try:
        deadline = time.time() + 10
        while seen is None and time.time() < deadline:
            seen = ctx.job_progress()
            time.sleep(0.02)
    finally:
        th.join(60)
    assert not th.is_alive(), (
        "test_job_progress_sees_the_collect_in_flight: the collect did not "
        "end within 60 s")
    assert "err" not in box, box.get("err")
    assert int(box["out"]["s"][0]) == int(np.sum(DATA["a"]))
    assert seen is not None
    _assert_shape(seen)
    assert seen["status"] == "running" and seen["fraction"] < 1.0
    assert ctx.job_progress("not-a-job") is None


def test_failed_collect_reports_failed(fast_interval):
    ctx = BallistaContext.standalone(device="cpu")
    ctx.register_memtable("t", schema(("a", Int64)), {"a": [1, 2, 3]})
    samples = []
    with pytest.raises(Exception):
        ctx.sql("select a / (a - a) as z from t").to_pydict(
            on_progress=samples.append)
    assert samples and samples[-1]["status"] == "failed"
