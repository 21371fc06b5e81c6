"""Stage planning and staged execution through Arrow IPC shuffle files in
the port (``distributed/planner.py``, ``physical/shuffle.py``, the
executor's writes, ``testing/stages.py``) against the JAX package.

At SF0.002 (two files a table), for q1, q3, q5 and q13:

- the port's stage DAG (stage ids, partition counts, shuffle fan-out,
  node classes) equals the JAX package's ``DistributedPlanner`` output,
  with the default settings and with hash shuffles forced
  (``join.partitioned.threshold=100``, ``agg.partitions=4``);
- the port's ``LocalCluster`` (``device="cpu"``) with hash shuffles
  forced, reading shuffle files from the local path and through the
  Python data plane, equals the port's standalone collect, the JAX
  package's result and the pandas oracle; every task plan an executor
  deserialized has its leaves on the executor's device; a second run
  of the query builds no new governed program (dictionary identity
  survives the shuffle reads);
- ``run_staged`` finishes a query whose first stage the JAX package ran
  and wrote (what a cluster cannot express);
- a ``ShuffleReaderExec`` with an adaptive layout (coalesced buckets, a
  bucket split by producers) over the JAX package's shuffle files reads
  what the JAX package's reader reads.

Tolerances: int, decimal, date and string columns exactly; float columns
within rtol 1e-6 (``assert_equals_reference``, and against the oracle
with atol 1e-6 as ``tests/test_torch_tpch.py``).
"""

import numpy as np
import pandas as pd
import pytest

from ballista_tpu import serde as ref_serde
from ballista_tpu.client import BallistaContext as ReferenceContext
from ballista_tpu.distributed.planner import \
    DistributedPlanner as RefPlanner
from ballista_tpu.execution import plan_logical as reference_plan
from ballista_tpu.physical.planner import PlannerOptions as RefOptions
from benchmarks.tpch import oracle
from benchmarks.tpch.schema_def import register_tpch as register_reference

from ballista_tpu_torch import serde
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.compile import compile_stats
from ballista_tpu_torch.distributed.executor import Executor, LocalCluster
from ballista_tpu_torch.distributed.planner import DistributedPlanner
from ballista_tpu_torch.distributed.types import PartitionLocation
from ballista_tpu_torch.execution import plan_logical
from ballista_tpu_torch.physical.shuffle import ShuffleReaderExec
from ballista_tpu_torch.testing.stages import run_staged, stage_dag
from ballista_tpu_torch.testing.tpch_schema import register_tpch

from torch_warm_path import (assert_equals_reference, generate_tpch,
                             pinned_threads, port_ctx, sql)

QUERIES = ["q1", "q3", "q5", "q13"]
SHUFFLED = {"join.partitioned.threshold": "100", "agg.partitions": "4"}


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """One torch, ingest and scanner thread: a cluster runs up to four
    tasks at once, and the tier's timing-gated tests share the cores."""
    with pinned_threads(1):
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("stages_tpch")))


def _reference(tpch_dir, settings):
    ref = ReferenceContext.standalone(**settings)
    register_reference(ref, tpch_dir, "tbl")
    return ref


@pytest.fixture(scope="module")
def contexts(tpch_dir):
    return {name: (port_ctx(tpch_dir, **s), _reference(tpch_dir, s))
            for name, s in (("default", {}), ("shuffled", SHUFFLED))}


@pytest.fixture(scope="module")
def oracle_tables(tpch_dir):
    return oracle.load_tables(tpch_dir)


@pytest.fixture(scope="module")
def expected(contexts, oracle_tables):
    """q -> (standalone port, JAX package, oracle) results with hash
    shuffles forced, each computed once."""
    port, ref = contexts["shuffled"]
    cache = {}

    def get(q):
        if q not in cache:
            cache[q] = (port.sql(sql(q)).to_pydict(),
                        ref.sql(sql(q)).collect(),
                        oracle.ORACLES[q](oracle_tables).reset_index(
                            drop=True))
        return cache[q]

    return get


def _reference_stages(ref, q, job_id):
    phys = reference_plan(ref.sql(sql(q)).plan,
                          RefOptions.from_settings(ref.settings))
    return RefPlanner().plan_query_stages(job_id, phys)


@pytest.mark.parametrize("settings", ["default", "shuffled"])
@pytest.mark.parametrize("q", QUERIES)
def test_stage_dag_equals_reference(contexts, q, settings):
    port, ref = contexts[settings]
    phys = plan_logical(port.sql(sql(q)).plan, port._planner_options())
    mine = stage_dag(DistributedPlanner().plan_query_stages("j", phys))
    assert mine == stage_dag(_reference_stages(ref, q, "j"))
    if settings == "shuffled" and q != "q13":
        assert any(fan for _, _, fan, _ in mine), mine


def _assert_close(got, want, tag):
    assert list(got) == list(want), tag
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.shape == w.shape, (tag, c)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f"{tag}.{c}")
        elif w.dtype.kind == "O":
            assert list(g) == list(w), (tag, c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{tag}.{c}")


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


@pytest.fixture(scope="module")
def clusters():
    """remote -> a LocalCluster on the CPU: ``None`` reads shuffle files
    from the local path, ``"python"`` runs the Python data-plane server
    in every executor (every read then goes through it)."""
    with pytest.MonkeyPatch.context() as mp:
        local = LocalCluster(num_executors=2, concurrent_tasks=2,
                             device="cpu")
        mp.setenv("BALLISTA_NATIVE_DATAPLANE", "off")
        python = LocalCluster(num_executors=2, concurrent_tasks=2,
                              device="cpu")
    try:
        yield {None: local, "python": python}
    finally:
        local.shutdown()
        python.shutdown()


@pytest.fixture()
def task_plans(monkeypatch):
    """Every task plan an executor runs, as deserialized and fused."""
    plans = []
    real = Executor.execute_partition

    def recording(self, pid, plan, shuffle=None):
        plans.append(plan)
        return real(self, pid, plan, shuffle)

    monkeypatch.setattr(Executor, "execute_partition", recording)
    return plans


def _cluster_run(cluster, tpch_dir, q):
    ctx = BallistaContext.remote("localhost", cluster.port, device="cpu",
                                 **SHUFFLED)
    register_tpch(ctx, tpch_dir)
    return ctx, ctx.sql(sql(q)).to_pydict()


@pytest.mark.parametrize("remote", [None, "python"])
@pytest.mark.parametrize("q", QUERIES)
def test_staged_equals_standalone_reference_and_oracle(
        clusters, tpch_dir, expected, task_plans, monkeypatch, q, remote):
    cluster = clusters[remote]
    monkeypatch.setattr(ShuffleReaderExec, "FORCE_REMOTE",
                        remote is not None)
    ctx, result = _cluster_run(cluster, tpch_dir, q)
    standalone, reference, exp = expected(q)
    _assert_close(result, standalone, q)
    assert_equals_reference(result, reference)
    _assert_equals_oracle(result, exp)
    assert len(cluster.state.stage_ids(ctx._last_job_id)) >= 2
    assert task_plans
    for plan in task_plans:
        for node in _leaves(plan):
            dev = getattr(node, "device", None) or node.source.device
            assert dev.type == "cpu", type(node).__name__
    fetched = sum(int(op["metrics"].get("remote_fetches", 0))
                  for op in ctx.last_query_metrics().operators())
    assert (fetched > 0) == (remote is not None)
    servers = {type(e._data_plane).__name__ for e in cluster.executors}
    assert servers == ({"NativeDataPlane"} if remote is None
                       else {"DataPlaneServer"})


def _leaves(plan):
    if not plan.children():
        return [plan]
    return [x for c in plan.children() for x in _leaves(c)]


@pytest.mark.parametrize("q", ["q3", "q5"])
def test_second_staged_run_builds_no_program(clusters, tpch_dir, q):
    _, first = _cluster_run(clusters[None], tpch_dir, q)
    built = compile_stats()["programs_built"]
    _, second = _cluster_run(clusters[None], tpch_dir, q)
    assert compile_stats()["programs_built"] == built
    _assert_close(second, first, q)


def _reference_write_stage(ref, stage, work_dir):
    """The JAX package runs one stage (no inputs) and writes its output as
    its executor does (``execute_partition``/``_write_shuffled``);
    returns the port's per-producer locations of the files."""
    import jax.numpy as jnp

    from ballista_tpu.distributed.dataplane import (partition_path,
                                                    shuffle_path)
    from ballista_tpu.io import ipc as ref_ipc
    from ballista_tpu.kernels.expr_eval import Evaluator
    from ballista_tpu.physical.fusion import maybe_fuse
    from ballista_tpu.physical.operators import compute_partition_ids

    plan = maybe_fuse(stage.child)
    n_out = stage.shuffle_output_partitions
    locs = []
    for p in range(stage.output_partitioning().num_partitions):
        if n_out:
            ev = Evaluator(plan.output_schema())
            writers = [ref_ipc.PartitionWriter(
                shuffle_path(work_dir, stage.job_id, stage.stage_id, p, q),
                schema=plan.output_schema()) for q in range(n_out)]
            offset = 0
            for b in plan.execute(p):
                ids = compute_partition_ids(b, stage.shuffle_hash_exprs,
                                            n_out, offset, ev)
                for q in range(n_out):
                    writers[q].write_batch(b.with_selection(
                        jnp.logical_and(b.selection, ids == q)))
                offset += b.num_rows_host()
            stats = {"num_rows": 0, "num_batches": 0, "num_bytes": 0}
            for w in writers:
                st = w.close()
                for k in stats:
                    stats[k] += st[k]
            path = shuffle_path(work_dir, stage.job_id, stage.stage_id, p,
                                n_out - 1)
        else:
            path = partition_path(work_dir, stage.job_id, stage.stage_id, p)
            stats = ref_ipc.write_partition(path, list(plan.execute(p)))
        locs.append(PartitionLocation(stage.job_id, stage.stage_id, p,
                                      "reference", "", 0, path=path,
                                      stats=stats))
    return locs


@pytest.mark.parametrize("q", ["q1", "q5"])
def test_port_finishes_a_query_the_reference_began(contexts, expected,
                                                  tmp_path, q):
    port, ref = contexts["shuffled"]
    job = f"mixed{q}"
    first = _reference_stages(ref, q, job)[0]
    locs = _reference_write_stage(ref, first, str(tmp_path))
    run = run_staged(port, sql(q), str(tmp_path), job_id=job,
                     written={first.stage_id: locs})
    assert run.stages[0].stage_id != first.stage_id
    assert run.stages[0].bytes_read > 0 or any(
        s.bytes_read for s in run.stages)
    standalone, reference, _ = expected(q)
    _assert_close(run.result, standalone, q)
    assert_equals_reference(run.result, reference)


LAYOUTS = {
    "coalesced": [[(0, 2, 0, 0)], [(2, 4, 0, 0)]],
    "split": [[(0, 1, 0, 1)], [(0, 1, 1, 2)], [(1, 4, 0, 0)]],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_adaptive_reader_layout_equals_reference(contexts, tmp_path, layout):
    from ballista_tpu.distributed.types import \
        PartitionLocation as RefLocation
    from ballista_tpu.physical.shuffle import \
        ShuffleReaderExec as RefReader
    from ballista_tpu_torch.testing.stages import _expand_shuffle_locations

    port, ref = contexts["shuffled"]
    stage = _reference_stages(ref, "q1", "adapt")[0]
    assert stage.shuffle_output_partitions == 4
    assert stage.output_partitioning().num_partitions == 2
    locs = _expand_shuffle_locations(
        _reference_write_stage(ref, stage, str(tmp_path)), 4)
    ref_locs = [RefLocation(**vars(loc)) for loc in locs]
    schema = serde.schema_from_proto(
        ref_serde.schema_to_proto(stage.output_schema()))
    mine = ShuffleReaderExec(locs, schema, read_partitions=LAYOUTS[layout],
                             device="cpu")
    theirs = RefReader(ref_locs, stage.output_schema(),
                       read_partitions=LAYOUTS[layout])
    n = mine.output_partitioning().num_partitions
    assert n == theirs.output_partitioning().num_partitions == \
        len(LAYOUTS[layout])
    for p in range(n):
        got = [b.to_pydict() for b in mine.execute(p)]
        want = [b.to_pydict() for b in theirs.execute(p)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, {k: np.asarray(v) for k, v in w.items()},
                          f"{layout}[{p}]")
