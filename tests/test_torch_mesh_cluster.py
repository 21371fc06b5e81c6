"""TPC-H q1, q3 and q5 through the port's mesh-fused stages on the CPU
(SF0.002, two files a table, hash shuffles forced), against the JAX
package's scheduler and the unfused cluster:

- a port ``LocalCluster`` whose executors report 8 slots and the JAX
  ``LocalCluster`` with 8 virtual CPU devices give the same fused stage
  DAG: stage ids, each stage's plan (serialized bytes, once job ids,
  executor ids, hosts, ports and work directories are set equal, and its
  display), task count, dependencies, shuffle spec and ``mesh_devices``;
  q1 fuses into ``MeshAggExec``, q3 and q5 into ``MeshJoinExec`` stages;
- the results equal the port's unfused cluster, the JAX mesh cluster and
  ``benchmarks/tpch/oracle.py``;
- the mesh programs replay: under ``testing/capture_check.py::
  emulated_graphs`` (the card's warm-up, capture and replay on the CPU)
  a repeated q1 and q5 replay every mesh program they run and answer as
  the eager run did, and under ``simulated_capture`` no mesh program
  reads a device value on the host or uploads one.

Tolerances: int, decimal, date and string columns exactly; float columns
within rtol 1e-6 (against the oracle with atol 1e-6, as
``tests/test_torch_tpch.py``).
"""

import numpy as np
import pytest

from ballista_tpu_torch import serde
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.distributed.executor import LocalCluster
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.testing.tpch_schema import register_tpch

from torch_warm_path import (assert_equals_reference, fresh_registries,
                             generate_tpch, pinned_threads, sql)

QUERIES = ["q1", "q3", "q5"]
SHUFFLED = {"join.partitioned.threshold": "100", "agg.partitions": "4"}
N_SLOTS = 8


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    with pinned_threads(1):
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("mesh_cluster_tpch")))


@pytest.fixture(scope="module")
def clusters(tpch_dir, eight_devices):
    """(port mesh context, port unfused context, JAX mesh context) and
    the port mesh and JAX clusters."""
    from ballista_tpu.client import BallistaContext as RefContext
    from ballista_tpu.distributed.executor import LocalCluster as RefCluster
    from benchmarks.tpch.schema_def import \
        register_tpch as register_reference

    with fresh_registries():
        mesh = LocalCluster(num_executors=2, concurrent_tasks=2,
                            num_devices=N_SLOTS, device="cpu")
        plain = LocalCluster(num_executors=2, concurrent_tasks=2,
                             device="cpu")
        ref = RefCluster(num_executors=2, concurrent_tasks=2,
                         num_devices=N_SLOTS)
        try:
            claim = dict(SHUFFLED, **{"mesh.devices": str(N_SLOTS)})
            mine = BallistaContext.remote("localhost", mesh.port,
                                          device="cpu", **claim)
            register_tpch(mine, tpch_dir)
            unfused = BallistaContext.remote("localhost", plain.port,
                                             device="cpu", **SHUFFLED)
            register_tpch(unfused, tpch_dir)
            theirs = RefContext.remote("localhost", ref.port, **claim)
            register_reference(theirs, tpch_dir, "tbl")
            yield (mine, unfused, theirs), mesh, ref
        finally:
            mesh.shutdown()
            plain.shutdown()
            ref.shutdown()


@pytest.fixture(scope="module")
def runs(clusters):
    (mine, unfused, theirs), _, _ = clusters
    cache = {}

    def get(q):
        if q not in cache:
            got = mine.sql(sql(q)).to_pydict()
            job = mine._last_job_id
            plain = unfused.sql(sql(q)).to_pydict()
            want = theirs.sql(sql(q)).collect()
            cache[q] = (got, plain, want, job, theirs._last_job_id)
        return cache[q]

    return get


def _normalize(msg, job: str):
    """Set the run-to-run values of a protobuf message equal, in place."""
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


def _stages(state, job, from_proto):
    out = {}
    for sid in state.stage_ids(job):
        row = state.get_stage_plan(job, sid)
        node = pb.PhysicalPlanNode()
        node.ParseFromString(row.plan_bytes)
        spec = row.shuffle_spec
        out[sid] = (_normalize(node, job).SerializeToString(),
                    from_proto(node).pretty(), row.num_partitions,
                    tuple(row.deps), spec and (tuple(spec[0]), spec[1]),
                    row.mesh_devices)
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_fused_stage_dag_equals_reference(clusters, runs, q):
    from ballista_tpu import serde as rserde

    _, mesh, ref = clusters
    _, _, _, job, ref_job = runs(q)
    mine = _stages(mesh.state, job,
                   lambda n: serde.physical_from_proto(n, device="cpu"))
    theirs = _stages(ref.state, ref_job, rserde.physical_from_proto)
    assert list(mine) == list(theirs)
    for sid in mine:
        assert mine[sid] == theirs[sid], (sid, mine[sid][1],
                                          theirs[sid][1])
    text = "".join(v[1] for v in mine.values())
    assert ("MeshAggExec" if q == "q1" else "MeshJoinExec") in text
    assert any(v[-1] == N_SLOTS for v in mine.values())


def _assert_equal_port(got, want):
    assert list(got) == list(want)
    for c in want:
        if np.asarray(want[c]).dtype.kind == "f":
            np.testing.assert_allclose(got[c], want[c], rtol=1e-6,
                                       err_msg=c)
        else:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)


@pytest.mark.parametrize("q", QUERIES)
def test_results_equal_unfused_reference_and_oracle(runs, tpch_dir, q):
    from benchmarks.tpch import oracle

    got, plain, want, _, _ = runs(q)
    _assert_equal_port(got, plain)
    assert_equals_reference(got, want)
    exp = oracle.ORACLES[q](oracle.load_tables(tpch_dir)).reset_index(
        drop=True)
    assert list(got) == list(exp.columns)
    for c in exp.columns:
        e = exp[c]
        if e.dtype.kind == "M":
            e = e.values.astype("datetime64[D]")
        if np.asarray(e).dtype.kind in "fc":
            np.testing.assert_allclose(np.asarray(got[c], dtype=float),
                                       np.asarray(e, dtype=float),
                                       rtol=1e-6, atol=1e-6, err_msg=c)
        else:
            np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(e),
                                          err_msg=c)


def _gov():
    """The governor module (the package re-exports a function under the
    same name)."""
    import importlib

    return importlib.import_module("ballista_tpu_torch.compile.governor")


def _mesh_programs():
    g = _gov().governor()
    with g._lock:
        return [(ns, gf) for ns, space in g._spaces.items()
                if ns.startswith("mesh.") for gf in space.values()]


def test_mesh_programs_replay_under_emulated_graphs(clusters, runs,
                                                    monkeypatch):
    from ballista_tpu_torch.testing.capture_check import emulated_graphs

    gov = _gov()
    (mine, _, _), _, _ = clusters
    eager = {q: runs(q)[0] for q in ("q1", "q5")}
    with emulated_graphs(monkeypatch):
        for q in ("q1", "q5"):
            df = mine.sql(sql(q))
            _assert_equal_port(df.to_pydict(), eager[q])  # captures
            _assert_equal_port(df.to_pydict(), eager[q])  # replays
        progs = _mesh_programs()
        names = {ns for ns, _ in progs}
        assert {"mesh.agg_spmd", "mesh.join_spmd"} <= names, names
        for ns, gf in progs:
            assert gf.programs, ns
            for p in gf.programs.values():
                assert isinstance(p, gov._GraphProgram), ns
                assert p.calls >= 2, (ns, p.calls)


def test_mesh_programs_read_nothing_on_the_host(clusters, runs):
    from ballista_tpu_torch.testing.capture_check import simulated_capture

    (mine, _, _), _, _ = clusters
    with simulated_capture():
        for q in QUERIES:
            _assert_equal_port(mine.sql(sql(q)).to_pydict(), runs(q)[0])
        assert {"mesh.agg_spmd", "mesh.join_spmd"} <= \
            {ns for ns, _ in _mesh_programs()}
