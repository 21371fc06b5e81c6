"""The port's latency ledger and compile attribution against the JAX
package's, on the CPU at TPC-H SF0.002 (the counterpart of
``tests/test_latency_ledger.py``, without its overhead gate):

- a first q1 collect on a cleared governor attributes compile time: the
  flight recorder's window gives a ``compile_trace_lower`` lane above 0
  and ``ctx.last_query_ledger()`` a ``compile`` phase above 0, as the
  JAX package's do on the same query; a warm collect's ``compile`` is 0.
  The port's governor emits ``compile.capture`` records and
  ``first_call_seconds``: a reader that looks for the JAX governor's
  ``compile.jit`` or ``compile_seconds``/``trace_seconds`` counts 0
  (ROADMAP queue 3 item 9);
- the fixed schemas: ``LEDGER_PHASES`` and ``LANE_NAMES`` equal the JAX
  package's, and every ledger carries every phase;
- standalone, the phases plus the unattributed remainder sum to the
  wall (within 1e-4 s), ``collect()`` stamps ``host_decode``, the ledger
  lands in the process log behind ``system.latency``, and
  ``BALLISTA_LEDGER=0`` records nothing;
- through a port ``LocalCluster``: ``last_query_ledger()`` fetches the
  scheduler's ``system.latency`` rows of the job and merges the client
  envelope (origin ``client``, ``host_decode`` from the client, the
  executors' ``shuffle_write`` and ``compile``), with the JAX cluster's
  phase set;
- standalone profiles: ``df.profile()`` writes an artifact with the JAX
  package's keys, lanes and operators, and ``BALLISTA_PROFILE=<dir>``
  one artifact a collect, named in ``system.queries``.
"""

import json
import os
import time

import pytest

from ballista_tpu_torch.compile import governor as port_governor
from ballista_tpu_torch.distributed.executor import LocalCluster
from ballista_tpu_torch.observability import export as port_export
from ballista_tpu_torch.observability import ledger as port_ledger
from ballista_tpu_torch.observability import tracing as port_tracing
from ballista_tpu_torch.testing.tpch_schema import register_tpch

from torch_warm_path import generate_tpch, pinned_threads, port_ctx, sql


@pytest.fixture(scope="module", autouse=True)
def _pinned():
    # one thread: this file runs a cluster's task threads
    with pinned_threads(1):
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("tpch_ledger")))


@pytest.fixture
def ledger_env():
    """Restore ledger enablement however a test sets it, and leave the
    process ledger logs fresh on both sides."""
    from ballista_tpu.observability import ledger as ref_ledger

    saved = os.environ.get("BALLISTA_LEDGER")
    for mod in (port_ledger, ref_ledger):
        mod.reset_process_log()
    yield
    if saved is None:
        os.environ.pop("BALLISTA_LEDGER", None)
    else:
        os.environ["BALLISTA_LEDGER"] = saved
    for mod in (port_ledger, ref_ledger):
        mod.reconfigure()
        mod.reset_process_log()


def _reference_ctx(tpch_dir):
    from ballista_tpu.client import BallistaContext as ReferenceContext
    from benchmarks.tpch.schema_def import register_tpch as register_ref

    ref = ReferenceContext.standalone()
    register_ref(ref, tpch_dir, "tbl")
    return ref


def _total(led):
    return sum(led["phases"].values()) + led["unattributed_seconds"]


def test_first_collect_attributes_compile(tpch_dir, ledger_env):
    from ballista_tpu.compile import governor as ref_governor

    ctx = port_ctx(tpch_dir)
    port_governor().clear()
    t0, w0 = time.time(), time.perf_counter()
    ctx.sql(sql("q1")).to_pydict()
    wall = time.perf_counter() - w0
    # the lanes of the collect's flight-recorder window, as the
    # standalone recorder and the profiler compute them
    lanes = port_export.compute_lanes({
        "wall_seconds": wall, "phases": {}, "compile": {},
        "records": port_tracing.ring_records(since=t0)})["lanes"]
    assert lanes["compile_trace_lower"] > 0.0, lanes
    led = ctx.last_query_ledger()
    assert led["phases"]["compile"] > 0.0, led
    ctx._plan_cache.clear()
    rows = ctx.sql("select job_id, lane, seconds from system.query_lanes"
                   ).to_pydict()
    mine = {lane: s for j, lane, s in zip(rows["job_id"], rows["lane"],
                                          rows["seconds"])
            if j == led["job_id"]}
    assert mine["compile_trace_lower"] > 0.0, mine
    # the JAX package attributes its first q1 the same way
    ref = _reference_ctx(tpch_dir)
    ref_governor().clear()
    ref.sql(sql("q1")).collect()
    assert ref.last_query_ledger()["phases"]["compile"] > 0.0
    # a warm collect compiles nothing
    ctx.sql(sql("q1")).to_pydict()
    warm = ctx.last_query_ledger()
    assert warm["phases"]["compile"] == 0.0, warm
    assert abs(_total(warm) - warm["wall_seconds"]) < 1e-4, warm


def test_fixed_schemas_equal_reference():
    from ballista_tpu.observability import export as ref_export
    from ballista_tpu.observability import ledger as ref_ledger

    assert port_ledger.LEDGER_PHASES == ref_ledger.LEDGER_PHASES
    assert port_export.LANE_NAMES == ref_export.LANE_NAMES
    assert set(port_export.LANE_SPANS.values()) <= \
        set(port_export.LANE_NAMES)
    from ballista_tpu_torch.compile import compile_stats

    assert set(port_export.COMPILE_STATS) <= set(compile_stats())


@pytest.mark.parametrize("frame", [False, True],
                         ids=["to_pydict", "collect"])
def test_standalone_phases_sum_to_wall(tpch_dir, ledger_env, frame):
    ctx = port_ctx(tpch_dir)
    df = ctx.sql(sql("q3"))
    out = df.collect() if frame else df.to_pydict()
    assert len(out["l_orderkey"]) == 10
    led = ctx.last_query_ledger()
    assert led["origin"] == "standalone" and led["status"] == "completed"
    assert set(led["phases"]) == set(port_ledger.LEDGER_PHASES)
    assert abs(_total(led) - led["wall_seconds"]) < 1e-4, led
    assert led["phases"]["planning"] > 0.0
    # the DataFrame is made inside the collect, under host_decode
    assert (led["phases"]["host_decode"] > 0.0) == frame
    for phase in ("queue_wait", "shuffle_fetch", "shuffle_write"):
        assert led["phases"][phase] == 0.0
    last = port_ledger.process_ledger_log().last()
    assert last is not None and last["job_id"] == led["job_id"]
    ctx._plan_cache.clear()
    rows = ctx.sql("select job_id, phase, seconds from system.latency"
                   ).to_pydict()
    phases = {p for j, p in zip(rows["job_id"], rows["phase"])
              if j == led["job_id"]}
    assert phases == set(port_ledger.LEDGER_PHASES) | {"unattributed"}
    # the JAX package's ledger of the same query has the same shape
    ref = _reference_ctx(tpch_dir)
    ref.sql(sql("q3")).collect()
    ref_led = ref.last_query_ledger()
    assert set(ref_led) == set(led)
    assert set(ref_led["phases"]) == set(led["phases"])


def test_ledger_off_records_nothing(tpch_dir, ledger_env):
    os.environ["BALLISTA_LEDGER"] = "0"
    port_ledger.reconfigure()
    before = len(port_ledger.process_ledger_log().entries())
    ctx = port_ctx(tpch_dir)
    ctx.sql(sql("q6")).to_pydict()
    assert ctx.last_query_ledger() is None
    assert len(port_ledger.process_ledger_log().entries()) == before


def test_remote_ledger_merges_the_client_envelope(tpch_dir, ledger_env):
    cluster = LocalCluster(num_executors=2, concurrent_tasks=2,
                           device="cpu")
    try:
        from ballista_tpu_torch.client import BallistaContext

        ctx = BallistaContext.remote("localhost", cluster.port,
                                     device="cpu")
        register_tpch(ctx, tpch_dir, tables=["lineitem"])
        port_governor().clear()
        out = ctx.sql(sql("q1")).collect()
        assert len(out) == 4
        led = ctx.last_query_ledger()
        assert led is not None and led["job_id"] == ctx._last_job_id
        assert led["origin"] == "client" and led["status"] == "completed"
        assert set(led["phases"]) == set(port_ledger.LEDGER_PHASES)
        # the executors' side: shuffle files and first calls
        assert led["phases"]["shuffle_write"] > 0.0, led
        assert led["phases"]["compile"] > 0.0, led
        # the client's side: the result's decode into pandas
        assert led["phases"]["host_decode"] > 0.0, led
        assert led["unattributed_seconds"] >= 0.0
        ctx._plan_cache.clear()
        rows = ctx.sql("select job_id, origin, phase from system.latency"
                       ).collect()
        mine = rows[rows["job_id"] == led["job_id"]]
        assert set(mine["phase"]) == \
            set(port_ledger.LEDGER_PHASES) | {"unattributed"}
        assert set(mine["origin"]) == {"cluster"}
    finally:
        cluster.shutdown()


def test_standalone_profile_artifact_equals_reference_shape(tpch_dir,
                                                            tmp_path):
    """``df.profile()`` standalone: the JAX package's artifact keys, the
    named lanes covering the wall, a first collect's compile lane above
    0 (on a cleared governor) and the operators' metrics."""
    from ballista_tpu.compile import governor as ref_governor

    ctx = port_ctx(tpch_dir)
    port_governor().clear()
    path = ctx.sql(sql("q3")).profile(path=str(tmp_path / "mine.json"),
                                      label="q3")
    art = json.load(open(path))
    ref = _reference_ctx(tpch_dir)
    ref_governor().clear()
    theirs = json.load(open(ref.sql(sql("q3")).profile(
        path=str(tmp_path / "theirs.json"), label="q3")))
    assert set(art) == set(theirs)
    assert art["schema"] == theirs["schema"] and art["label"] == "q3"
    assert set(art["lanes"]) == set(port_export.LANE_NAMES)
    wall = art["wall_seconds"]
    covered = (min(art["measured_seconds"], wall)
               + art["lanes"]["xla_execute_other"])
    assert abs(covered - wall) <= wall * 0.01 + 1e-6, art["lanes"]
    assert art["lanes"]["compile_trace_lower"] > 0.0
    assert art["compile"][port_export.COMPILE_SECONDS] > 0.0
    assert any("HashAggregateExec" in r["operator"]
               for r in art["operators"])
    assert {r["operator"].split(":")[0] for r in art["operators"]} == \
        {r["operator"].split(":")[0] for r in theirs["operators"]}


def test_ballista_profile_writes_an_artifact_a_collect(tpch_dir, tmp_path,
                                                       monkeypatch):
    out_dir = tmp_path / "profiles"
    monkeypatch.setenv("BALLISTA_PROFILE", str(out_dir))
    ctx = port_ctx(tpch_dir)
    ctx.sql(sql("q6")).to_pydict()
    ctx.sql(sql("q1")).to_pydict()
    files = sorted(out_dir.glob("ballista-profile-query-*.json"))
    assert len(files) == 2
    for f in files:
        art = json.load(open(f))
        assert 0.0 <= art["attributed_fraction"] <= 1.0
        assert set(art["lanes"]) == set(port_export.LANE_NAMES)
    # the collect's record names its artifact
    ctx._plan_cache.clear()
    rows = ctx.sql("select profile_artifact from system.queries").to_pydict()
    assert {str(f) for f in files} <= set(rows["profile_artifact"])
