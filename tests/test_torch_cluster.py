"""The port's cluster path (``ballista_tpu_torch/distributed/{scheduler,
executor,state,client}.py``, ``BallistaContext.remote``) against the JAX
package's, on the CPU at SF0.002 (two files a table, so scan stages run
two tasks):

- q1, q3, q5 and q13, with hash shuffles forced
  (``join.partitioned.threshold=100``, ``agg.partitions=4``), through
  ``LocalCluster(num_executors=2, concurrent_tasks=2, device="cpu")``
  and ``BallistaContext.remote``
  equal the JAX package's ``LocalCluster`` on the same files and the
  pandas oracle, and both executors ran tasks;
- the wire: the port scheduler's stage DAG (each stage's plan, task
  count, dependencies and shuffle spec) and every ``TaskDefinition`` it
  hands out (plan, ``shuffle_hash_exprs``, ``shuffle_output_partitions``)
  serialize to the JAX scheduler's bytes, once the values that differ
  from run to run are set equal: job ids, executor ids, hosts, ports and
  the executors' work directories (a path keeps its part below the job
  id). Every shuffle and partition file the port's executors write is
  byte-identical to the JAX executors' file of the same stage, partition
  and output;
- ``system.*`` tables read through the port's cluster have the JAX
  cluster's columns;
- the metrics port: ``snapshot_rows`` never reads a pending count that
  is not ready, ``values()`` resolves every pending count in one copy;
- ``LocalCluster()``, ``ExecutorConfig()`` and the executor binary
  default to "cuda" and raise here, where there is no card;
- the modules copied verbatim equal the JAX package's text with the
  package name replaced (one, whose docstring drops history references,
  its code);
- the executor binary's mesh-group options are accepted and checked:
  ``--mesh-group-size`` above 1 without the group's coordinator and
  channel, and the other mesh-group flags without a group, exit with
  argparse's error naming them (a group itself runs in
  ``test_torch_mesh_group_e2e.py``); ``scheduler_main`` starts with etcd state
  (``--state etcd:``, ``--etcd-urls``, over the in-process
  ``FakeEtcdServer``) and with ``--flight-port``, and drains on SIGTERM;
- ``python -m ballista_tpu_torch.distributed.executor_main --local
  --device cpu``, with torch reporting four cards, reports one device,
  answers q1 through ``BallistaContext.remote`` and exits 0 through the
  drain path on SIGTERM.

Card-only (``test_cuda_*``, skipped here, run by
``testing/card_checks.py``; the JAX package is imported only inside the
fixtures that run it, so they import without it): a cluster q5 on the
card with the progress sampler running every 10 ms equals the
standalone q5 on the card.

Tolerances: int, decimal, date and string columns exactly; float
columns within rtol 1e-6 (``assert_equals_reference``, and against the
oracle with atol 1e-6 as ``tests/test_torch_tpch.py``).
"""

import glob
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.distributed.executor import (ExecutorConfig,
                                                     LocalCluster)
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.observability import metrics as port_metrics
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.testing.tpch_schema import register_tpch

from torch_warm_path import (assert_equals_reference, fresh_registries,
                             generate_tpch, pinned_threads, port_ctx, sql)

QUERIES = ["q1", "q3", "q5", "q13"]
# hash shuffles forced (co-partitioned joins, a shuffled aggregate), so
# the stages write shuffle files and the replanner sees histograms
SHUFFLED = {"join.partitioned.threshold": "100", "agg.partitions": "4"}
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """One torch, ingest and scanner thread: a cluster runs up to four
    tasks at once, and the tier's timing-gated tests share the cores."""
    with pinned_threads(1):
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("cluster_tpch")))


@pytest.fixture(scope="module")
def clusters():
    """The port's and the JAX package's LocalCluster, each recording
    every TaskDefinition its scheduler hands out."""
    from ballista_tpu.distributed.executor import LocalCluster as RefCluster
    from ballista_tpu.distributed.scheduler import \
        SchedulerService as RefService
    from ballista_tpu_torch.distributed.scheduler import SchedulerService

    handed = {}

    def recording(cls):
        real = cls._task_definition

        def task_definition(self, task, meta):
            td = real(self, task, meta)
            handed[(task.job_id, task.stage_id, task.partition_id)] = \
                td.SerializeToString()
            return td
        return task_definition

    # fresh dictionary registries in both packages: the shuffle files'
    # stamps must not depend on what other test files of this worker
    # process scanned before (torch_warm_path.fresh_registries)
    with pytest.MonkeyPatch.context() as mp, fresh_registries():
        for cls in (SchedulerService, RefService):
            mp.setattr(cls, "_task_definition", recording(cls))
        port = LocalCluster(num_executors=2, concurrent_tasks=2,
                            device="cpu")
        ref = RefCluster(num_executors=2, concurrent_tasks=2)
        try:
            yield port, ref, handed
        finally:
            port.shutdown()
            ref.shutdown()


@pytest.fixture(scope="module")
def contexts(clusters, tpch_dir):
    from ballista_tpu.client import BallistaContext as RefContext
    from benchmarks.tpch.schema_def import \
        register_tpch as register_reference

    port, ref, _ = clusters
    mine = BallistaContext.remote("localhost", port.port, device="cpu",
                                  **SHUFFLED)
    register_tpch(mine, tpch_dir)
    theirs = RefContext.remote("localhost", ref.port, **SHUFFLED)
    register_reference(theirs, tpch_dir, "tbl")
    return mine, theirs


@pytest.fixture(scope="module")
def oracle_tables(tpch_dir):
    from benchmarks.tpch import oracle

    return {q: oracle.ORACLES[q](oracle.load_tables(tpch_dir)).reset_index(
        drop=True) for q in QUERIES}


@pytest.fixture(scope="module")
def runs(contexts):
    """q -> (port result, JAX result, port job id, JAX job id), each
    query run once on each cluster."""
    mine, theirs = contexts
    cache = {}

    def get(q):
        if q not in cache:
            got = mine.sql(sql(q)).to_pydict()
            want = theirs.sql(sql(q)).collect()
            cache[q] = (got, want, mine._last_job_id, theirs._last_job_id)
        return cache[q]

    return get


def _assert_equals_oracle(got, exp: pd.DataFrame):
    assert list(got) == list(exp.columns)
    for c in exp.columns:
        e = exp[c]
        if e.dtype.kind == "M":
            e = e.values.astype("datetime64[D]")
        g = got[c]
        if np.asarray(e).dtype.kind in "fc":
            np.testing.assert_allclose(np.asarray(g, dtype=float),
                                       np.asarray(e, dtype=float),
                                       rtol=1e-6, atol=1e-6, err_msg=c)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(e),
                                          err_msg=c)


@pytest.mark.parametrize("q", QUERIES)
def test_cluster_equals_reference_cluster_and_oracle(clusters, runs,
                                                     oracle_tables, q):
    port, _, _ = clusters
    got, want, job, _ = runs(q)
    assert_equals_reference(got, want)
    _assert_equals_oracle(got, oracle_tables[q])
    stages = port.state.stage_ids(job)
    assert len(stages) >= 2, stages
    scan_tasks = max(len(port.state.get_task_statuses(job, sid))
                     for sid in stages)
    assert scan_tasks >= 2  # a scan stage ran one task per file


def test_both_executors_ran_tasks(clusters, runs):
    for q in QUERIES:
        runs(q)
    port, _, _ = clusters
    done = [e.tasks_completed for e in port.executors]
    assert all(n > 0 for n in done), done


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------


def _normalize(msg, job: str):
    """Set the run-to-run values of a protobuf message equal, in place:
    job ids, executor ids, hosts, ports, and work-directory paths (kept
    below the job id)."""
    for fd, val in msg.ListFields():
        if fd.type == fd.TYPE_MESSAGE:
            for m in (val if fd.is_repeated else [val]):
                _normalize(m, job)
        elif fd.is_repeated:
            continue
        elif fd.name == "job_id":
            setattr(msg, fd.name, "JOB")
        elif fd.name == "executor_id" or (
                fd.name == "id" and msg.DESCRIPTOR.name == "ExecutorMetadata"):
            setattr(msg, fd.name, "EXECUTOR")
        elif fd.name == "host":
            setattr(msg, fd.name, "HOST")
        elif fd.name == "port":
            setattr(msg, fd.name, 0)
        elif fd.name == "path" and f"/{job}/" in val:
            setattr(msg, fd.name, val.split(f"/{job}/", 1)[1])
    return msg


def _stage_rows(state, job):
    out = {}
    for sid in state.stage_ids(job):
        row = state.get_stage_plan(job, sid)
        node = pb.PhysicalPlanNode()
        node.ParseFromString(row.plan_bytes)
        spec = row.shuffle_spec
        out[sid] = (_normalize(node, job).SerializeToString(),
                    row.num_partitions, tuple(row.deps),
                    spec and (tuple(spec[0]), spec[1]), row.version,
                    row.reader_layouts)
    return out


def _task_definitions(handed, job):
    out = {}
    for (j, sid, p), raw in handed.items():
        if j == job:
            td = pb.TaskDefinition()
            td.ParseFromString(raw)
            out[(sid, p)] = _normalize(td, job).SerializeToString()
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_stage_dag_and_task_definitions_equal_reference(clusters, runs, q):
    port, ref, handed = clusters
    _, _, job, ref_job = runs(q)
    mine, theirs = _stage_rows(port.state, job), _stage_rows(ref.state,
                                                             ref_job)
    assert mine == theirs
    tds, ref_tds = (_task_definitions(handed, job),
                    _task_definitions(handed, ref_job))
    assert tds and sorted(tds) == sorted(ref_tds)
    for key in tds:
        assert tds[key] == ref_tds[key], (q, key)
    assert any(pb.TaskDefinition.FromString(v).shuffle_output_partitions
               for v in tds.values())


def _job_files(cluster, job):
    files = {}
    for e in cluster.executors:
        root = os.path.join(e.config.work_dir, job)
        for path in glob.glob(os.path.join(root, "**", "*.arrow"),
                              recursive=True):
            with open(path, "rb") as fh:
                files[os.path.relpath(path, root)] = fh.read()
    return files


@pytest.mark.parametrize("q", QUERIES)
def test_shuffle_files_equal_reference(clusters, runs, q):
    port, ref, _ = clusters
    _, _, job, ref_job = runs(q)
    mine, theirs = _job_files(port, job), _job_files(ref, ref_job)
    assert mine and sorted(mine) == sorted(theirs)
    assert any("shuffle-" in k for k in mine)
    for k in mine:
        assert mine[k] == theirs[k], (q, k)


def test_system_tables_have_the_reference_columns(contexts, runs):
    runs("q1")
    mine, theirs = contexts
    for table in ("system.queries", "system.executors", "system.stages",
                  "system.tasks", "system.sessions"):
        got = mine.sql(f"select * from {table}").to_pydict()
        want = theirs.sql(f"select * from {table}").collect()
        assert list(got) == list(want.columns), table
    execs = mine.sql("select executor_id, num_devices from "
                     "system.executors").to_pydict()
    assert len(execs["executor_id"]) == 2
    assert list(execs["num_devices"]) == [1, 1]


# ---------------------------------------------------------------------------
# the ported modules
# ---------------------------------------------------------------------------


class _NeverReady:
    """A stand-in for a card count's event that has not completed."""

    def query(self):
        return False


def test_snapshot_rows_never_reads_a_pending_count(monkeypatch):
    fetches = []
    real = port_metrics._fetch_counts

    def counting(counts):
        fetches.append(len(counts))
        return real(counts)

    monkeypatch.setattr(port_metrics, "_fetch_counts", counting)
    ms = port_metrics.MetricsSet()

    class _Batch:
        def __init__(self, n):
            self.num_rows = torch.tensor(n, dtype=torch.int32)

    for n in (3, 4, 5):
        ms.record_output_batch(_Batch(n))
    ms._pending_rows[1].ready = _NeverReady()
    # ready counts are read from host memory; the unready one stays
    # pending, and nothing is copied
    assert ms.snapshot_rows() == 8
    assert ms.snapshot_rows() == 8
    assert len(ms._pending_rows) == 3 and fetches == []
    # values(): every pending count, in one copy
    assert ms.values()["output_rows"] == 12
    assert fetches == [3] and not ms._pending_rows


def test_values_resolve_every_operator_in_one_copy(monkeypatch):
    fetches = []
    real = port_metrics._fetch_counts
    monkeypatch.setattr(port_metrics, "_fetch_counts",
                        lambda c: fetches.append(len(c)) or real(c))
    sets = [port_metrics.MetricsSet() for _ in range(3)]

    class _Batch:
        def __init__(self, n):
            self.num_rows = torch.tensor(n, dtype=torch.int32)

    for i, ms in enumerate(sets):
        for n in range(i + 1):
            ms.record_output_batch(_Batch(10 + n))
    port_metrics.resolve_all_pending(sets)
    assert fetches == [6]
    assert [ms.values()["output_rows"] for ms in sets] == [10, 21, 33]


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs there")
    with pytest.raises(ExecutionError, match="no CUDA device"):
        ExecutorConfig(work_dir=str(tmp_path))
    with pytest.raises(ExecutionError, match="no CUDA device"):
        LocalCluster()
    with pytest.raises(ExecutionError, match="no CUDA device"):
        BallistaContext.remote("localhost", 1)


def test_scheduler_refuses_a_mesh_fleet():
    """Not any more: a fleet reporting a mesh gets mesh-fused stages
    (``test_torch_mesh_*.py``). Without a mesh the stages are returned
    as they are, and a stage set with nothing to fuse passes through a
    mesh width untouched instead of raising."""
    from ballista_tpu_torch.distributed.scheduler import _fuse_mesh_stages

    assert _fuse_mesh_stages(["a"], 1) == ["a"]
    assert _fuse_mesh_stages([], 2) == []


def _replan_in_order(pkg: str, tpch_dir: str):
    """q3's stages (hash shuffles forced) saved into a fresh scheduler
    state of package ``pkg``, then the re-planner run as the scheduler
    runs it when stage 1 (the build of stage 5's join) completes before
    stage 2 (the build of stage 4's, whose probe is stage 3): returns
    (stage 4's task count, the producers stage 5's probe layout reads
    from stage 4)."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    types = mod("distributed.types")
    pkg_serde = mod("serde")
    planner = mod("distributed.planner")
    if pkg == "ballista_tpu_torch":
        ctx = port_ctx(tpch_dir, **SHUFFLED)
        phys = mod("execution").plan_logical(ctx.sql(sql("q3")).plan,
                                             ctx._planner_options())
    else:
        from ballista_tpu.client import BallistaContext as RefContext
        from ballista_tpu.physical.planner import PlannerOptions
        from benchmarks.tpch.schema_def import \
            register_tpch as register_reference

        ctx = RefContext.standalone(**SHUFFLED)
        register_reference(ctx, tpch_dir, "tbl")
        phys = mod("execution").plan_logical(
            ctx.sql(sql("q3")).plan, PlannerOptions.from_settings(SHUFFLED))
    state_mod = mod("distributed.state")
    state = state_mod.SchedulerState(state_mod.MemoryBackend(), "order")
    job = "order"
    state.save_job_settings(job, SHUFFLED)
    for st in planner.DistributedPlanner().plan_query_stages(job, phys):
        deps = [sid for u in planner.find_unresolved_shuffles(st.child)
                for sid in u.query_stage_ids]
        spec = None
        if st.shuffle_output_partitions:
            spec = ([pkg_serde.expr_to_proto(e).SerializeToString()
                     for e in st.shuffle_hash_exprs or []],
                    st.shuffle_output_partitions)
        n = st.output_partitioning().num_partitions
        state.save_stage_plan(
            job, st.stage_id,
            pkg_serde.physical_to_proto(st.child).SerializeToString(), n,
            deps, spec)
        for p in range(n):
            state.save_task_status(types.TaskStatus(
                types.PartitionId(job, st.stage_id, p)))
    replan = mod("adaptive.replanner").replan_on_stage_complete
    for done, blocked in ((1, 5), (2, 4)):
        for p in range(state.get_stage_plan(job, done).num_partitions):
            state.save_task_status(types.TaskStatus(
                types.PartitionId(job, done, p), state="completed",
                stats={"num_rows": 10, "num_bytes": 1000}))
        replan(state, job, done, [], [blocked])
    layout = state.get_stage_plan(job, 5).reader_layouts[4]
    return state.get_stage_plan(job, 4).num_partitions, len(layout)


def test_demotion_keeps_a_laid_out_probe_stage(tpch_dir):
    """When stage 5's join is demoted first, its probe reads are laid out
    one task of stage 4 each; stage 4's own demotion must then leave its
    task count alone, or stage 5's tasks past the new count fail (the
    cluster's q3 failed that way under load). The JAX package's
    re-planner shrinks stage 4 (a reference fault, ROADMAP queue 3)."""
    tasks, producers = _replan_in_order("ballista_tpu_torch", tpch_dir)
    assert tasks == producers == 8
    ref_tasks, ref_producers = _replan_in_order("ballista_tpu", tpch_dir)
    assert (ref_tasks, ref_producers) == (2, 8)


VERBATIM = [
    "distributed/config.py", "distributed/state.py",
    "distributed/admission.py", "distributed/client.py",
    "distributed/controlplane/__init__.py",
    "distributed/controlplane/costs.py",
    "distributed/controlplane/journal.py",
    "observability/__init__.py", "observability/registry.py",
    "observability/health.py", "observability/export.py",
    "observability/ledger.py", "observability/profiler.py",
    "observability/distributed.py", "observability/progress.py",
]
# copies whose docstrings drop the JAX package's history references:
# their code (the syntax tree without docstrings) is compared
SAME_CODE = ["distributed/controlplane/autoscaler.py"]
# copies whose compile readers read the port's governor
# (observability/export.py: COMPILE_SPAN, COMPILE_SECONDS, COMPILE_STATS)
# instead of the JAX governor's names: every hunk that differs reads
# those on the port's side and the JAX names on the reference's
COMPILE_READERS = ["observability/export.py", "observability/profiler.py",
                   "observability/distributed.py"]
_PORT_COMPILE_NAMES = ("COMPILE_", "compile.capture")
_JAX_COMPILE_NAMES = ("compile.jit", "compile_seconds", "trace_seconds",
                      "backend_compiles", "COMPILE_")


def _differing_hunks(mine: str, theirs: str):
    import difflib

    a, b = theirs.splitlines(), mine.splitlines()
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, a, b, autojunk=False).get_opcodes():
        if tag != "equal":
            yield "\n".join(a[i1:i2]), "\n".join(b[j1:j2])


def _code(text: str) -> str:
    """The syntax tree of a module without its docstrings."""
    import ast

    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            body.pop(0)
    return ast.dump(tree)


def _texts(module):
    with open(os.path.join(ROOT, "ballista_tpu", module)) as fh:
        theirs = fh.read().replace("ballista_tpu", "ballista_tpu_torch")
    with open(os.path.join(ROOT, "ballista_tpu_torch", module)) as fh:
        return fh.read(), theirs


@pytest.mark.parametrize("module", VERBATIM + SAME_CODE)
def test_copied_module_equals_the_reference(module):
    mine, theirs = _texts(module)
    if module in SAME_CODE:
        assert _code(mine) == _code(theirs)
    elif module in COMPILE_READERS:
        hunks = list(_differing_hunks(mine, theirs))
        assert hunks
        for old, new in hunks:
            assert any(n in new for n in _PORT_COMPILE_NAMES), new
            assert not old or any(n in old for n in _JAX_COMPILE_NAMES), old
    else:
        assert mine == theirs


# ---------------------------------------------------------------------------
# the binary
# ---------------------------------------------------------------------------


# ``python -m`` of the executor binary on a host that reports four cards
_FOUR_CARDS = (
    "import runpy, sys, torch\n"
    "torch.cuda.device_count = lambda: 4\n"
    "sys.argv[0] = 'executor_main'\n"
    "runpy.run_module('ballista_tpu_torch.distributed.executor_main',"
    " run_name='__main__', alter_sys=True)\n")


def test_executor_binary_answers_q1_and_drains(tpch_dir):
    """The binary runs as ``python -m`` does, on a host whose torch
    reports four cards: the executor reports its one device, so the
    scheduler plans no mesh and q1 runs."""
    env = dict(os.environ, PYTHONPATH=ROOT, BALLISTA_INGEST_THREADS="2",
               BALLISTA_SCAN_THREADS="2", OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-c", _FOUR_CARDS,
         "--local", "--device", "cpu", "--concurrent-tasks", "2",
         "--metrics-port", "-1"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    try:
        port = None
        deadline = time.time() + 60
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"embedded scheduler on localhost:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port, "".join(lines)
        ctx = BallistaContext.remote("localhost", port, device="cpu")
        register_tpch(ctx, tpch_dir, tables=["lineitem"])
        got = ctx.sql(sql("q1")).to_pydict()
        want = port_ctx(tpch_dir).sql(sql("q1")).to_pydict()
        assert list(got) == list(want)
        for c in want:
            if want[c].dtype.kind == "f":
                np.testing.assert_allclose(got[c], want[c], rtol=1e-6)
            else:
                assert list(got[c]) == list(want[c]), c
        execs = ctx.sql("select num_devices from system.executors"
                        ).to_pydict()
        assert list(execs["num_devices"]) == [1]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(lines)
    assert "(graceful drain)" in text, text
    assert proc.returncode == 0, text


# the mesh-group options of the executor binary: accepted (no
# "unrecognized arguments"), and a group misconfigured by them exits
# with argparse's error (exit 2) before anything starts
_MESH_GROUP_FLAGS = ["--num-devices", "4", "--mesh-group-rank", "1",
                     "--mesh-group-coordinator", "localhost:1",
                     "--mesh-group-channel", "localhost:2",
                     "--mesh-local-devices", "2"]


@pytest.mark.parametrize("binary,args,expected", [
    ("executor_main", ["--local", "--device", "cpu",
                       "--mesh-group-size", "2"],
     ["--mesh-group-size 2 needs --mesh-group-coordinator and "
      "--mesh-group-channel"]),
    ("executor_main", ["--local", "--device", "cpu"] + _MESH_GROUP_FLAGS,
     ["--mesh-group-rank, --mesh-group-coordinator, --mesh-group-channel, "
      "--mesh-local-devices configure a mesh group: they need "
      "--mesh-group-size above 1"]),
], ids=["mesh_group", "mesh_group_flags"])
def test_unported_binary_options_raise(binary, args, expected):
    proc = subprocess.run(
        [sys.executable, "-m", f"ballista_tpu_torch.distributed.{binary}",
         "--metrics-port", "-1"] + args,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "unrecognized arguments" not in proc.stderr, proc.stderr[-2000:]
    for text in expected:
        assert text in proc.stderr, proc.stderr[-2000:]


@pytest.fixture
def fake_etcd():
    from ballista_tpu_torch.distributed.etcd import FakeEtcdServer

    server = FakeEtcdServer()
    yield f"localhost:{server.port}"
    server.stop()


@pytest.mark.parametrize("args,expected", [
    (["--state", "etcd:{etcd}"], ["(backend=etcd"]),
    (["--flight-port", "0", "--device", "cpu"],
     ["Arrow Flight SQL endpoint on"]),
    (["--config-backend", "etcd", "--etcd-urls", "{etcd}"],
     ["(backend=etcd"]),
], ids=["etcd_state", "flight_port", "etcd_urls"])
def test_scheduler_binary_state_and_flight_options(fake_etcd, args,
                                                   expected):
    """etcd state and the Flight endpoint: the binary starts with each,
    prints what it serves, and exits 0 through the drain path on
    SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "ballista_tpu_torch.distributed.scheduler_main", "--port", "0",
         "--metrics-port", "-1"] + [a.format(etcd=fake_etcd) for a in args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                any(t in ln for ln in lines) for t in expected):
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(lines)
    for t in expected + ["draining (new submissions are shed)"]:
        assert t in text, (proc.returncode, text)
    assert proc.returncode == 0, text


# ---------------------------------------------------------------------------
# card only
# ---------------------------------------------------------------------------


def test_cuda_cluster_q5_with_the_sampler_equals_standalone(tmp_path,
                                                            monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 -m ballista_tpu_torch."
                    "testing.card_checks)")
    from ballista_tpu_torch.compile.governor import governor

    d = generate_tpch(str(tmp_path / "tpch"))
    governor().clear()
    monkeypatch.setenv("BALLISTA_PROGRESS_INTERVAL_SECS", "0.01")
    cluster = LocalCluster(num_executors=2, concurrent_tasks=2,
                           device="cuda")
    try:
        ctx = BallistaContext.remote("localhost", cluster.port)
        register_tpch(ctx, d)
        got = ctx.sql(sql("q5")).to_pydict()
    finally:
        cluster.shutdown()
    sa = BallistaContext.standalone()
    register_tpch(sa, d)
    want = sa.sql(sql("q5")).to_pydict()
    assert list(got) == list(want)
    assert list(got["n_name"]) == list(want["n_name"])
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=1e-6)


_SCHEDULER_ONLY = r"""
import sys, time
import torch
from ballista_tpu_torch import serde
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.distributed.scheduler import SchedulerService
from ballista_tpu_torch.distributed.state import MemoryBackend, SchedulerState
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.testing.tpch_schema import register_tpch

ctx = BallistaContext.remote("localhost", 1, device="cpu",
                             **{"join.partitioned.threshold": "100"})
register_tpch(ctx, sys.argv[1])
svc = SchedulerService(SchedulerState(MemoryBackend()))
params = pb.ExecuteQueryParams()
params.logical_plan.CopyFrom(serde.plan_to_proto(ctx.sql(sys.argv[2]).plan))
for k, v in ctx.settings.items():
    params.settings[k] = v
job = svc.ExecuteQuery(params).job_id
deadline = time.time() + 60
while not svc.state.stage_ids(job) and time.time() < deadline:
    time.sleep(0.05)
poll = pb.PollWorkParams(can_accept_task=True)
poll.metadata.id, poll.metadata.host, poll.metadata.port = "e1", "h", 1
assert svc.PollWork(poll).HasField("task")
svc.close_health()
print("cuda initialized:", torch.cuda.is_initialized())
"""


def test_cuda_scheduler_creates_no_cuda_context(tmp_path):
    """On a host with a card, planning a query, cutting it into stages
    and handing out a task (each deserialized on the scheduler) leave
    CUDA uninitialized in the scheduler's process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 -m ballista_tpu_torch."
                    "testing.card_checks)")
    d = generate_tpch(str(tmp_path / "tpch"))
    proc = subprocess.run(
        [sys.executable, "-c", _SCHEDULER_ONLY, d, sql("q5")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "cuda initialized: False" in proc.stdout, proc.stdout
