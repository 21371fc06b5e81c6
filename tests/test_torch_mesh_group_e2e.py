"""The port's mesh group end to end: twin of
``tests/test_mesh_group_e2e.py``.

A fused SQL aggregation spans TWO executor PROCESSES that share one
8-slot mesh (4 CPU slots each): the port's ``scheduler_main`` sees the
group as one executor reporting 8 slots and fuses the shuffle stage pair
into a ``MeshAggExec``; the leader broadcasts the task over the group
channel and the row exchange crosses the process boundary through the
group's gloo collectives. No shuffle files anywhere; results equal
pandas. The same cluster then runs a partitioned join fused across the
process mesh (``MeshJoinExec``).

Integer and string columns: exact.
"""

import os
import re
import signal
import socket
import subprocess

import numpy as np
import pandas as pd
import pytest

from ballista_tpu_torch import Int64, Utf8, schema
from tests.procutil import spawn_module as _spawn

from torch_warm_path import pinned_threads


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    with pinned_threads(1):
        yield


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _shuffle_files(tmp_path):
    files = []
    for w in ("w0", "w1"):
        for _root, _, fs in os.walk(tmp_path / w):
            files += [f for f in fs if f.startswith("shuffle-")]
    return files


@pytest.mark.sf02  # heavyweight: spawns a 3-process cluster
def test_fused_aggregation_across_process_mesh(tmp_path):
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.io.text import TblSource

    repo = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, OMP_NUM_THREADS="1", BALLISTA_INGEST_THREADS="1",
               BALLISTA_SCAN_THREADS="1")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    # multi-file table -> table-wide dictionaries (content-identical
    # across the group's processes, required for fused utf8 keys)
    d = tmp_path / "t"
    d.mkdir()
    rng = np.random.default_rng(23)
    keys = [f"g{k}" for k in rng.integers(0, 29, 900)]
    vals = rng.integers(0, 500, 900)
    for part in range(3):
        rows = [f"{keys[i]}|{vals[i]}|" for i in range(900) if i % 3 == part]
        (d / f"p{part}.tbl").write_text("\n".join(rows) + "\n")

    coord = _free_port()
    chan = _free_port()
    procs = []
    try:
        sched = _spawn(["ballista_tpu_torch.distributed.scheduler_main",
                        "--bind-host", "localhost", "--port", "0",
                        "--device", "cpu", "--metrics-port", "-1"], env)
        procs.append(sched)
        line = sched.wait_for(lambda ln: "listening on" in ln)
        m = re.search(r"listening on [^:]+:(\d+)", line)
        assert m, f"no port in scheduler output: {line!r}"
        sport = m.group(1)

        common = ["--scheduler-host", "localhost",
                  "--scheduler-port", sport, "--device", "cpu",
                  "--metrics-port", "-1", "--concurrent-tasks", "2",
                  "--mesh-group-size", "2",
                  "--mesh-group-coordinator", f"localhost:{coord}",
                  "--mesh-group-channel", f"localhost:{chan}",
                  "--mesh-local-devices", "4"]
        leader = _spawn(["ballista_tpu_torch.distributed.executor_main",
                         *common, "--mesh-group-rank", "0",
                         "--work-dir", str(tmp_path / "w0")], env)
        procs.append(leader)
        follower = _spawn(["ballista_tpu_torch.distributed.executor_main",
                           *common, "--mesh-group-rank", "1",
                           "--work-dir", str(tmp_path / "w1")], env)
        procs.append(follower)

        # the leader polls only after the follower joined
        polling = leader.wait_for(lambda ln: "polling" in ln, timeout=90)
        assert "mesh group of 2 x 4 devices" in polling, leader.text

        # claim the mesh width, so planning waits for the leader's first
        # poll instead of racing it (unclaimed + unregistered: unfused)
        ctx = BallistaContext.remote("localhost", int(sport), device="cpu",
                                     **{"agg.partitions": "8",
                                        "mesh.devices": "8"})
        ctx.register_source("t", TblSource(
            str(d), schema(("k", Utf8), ("v", Int64)), device="cpu"))
        got = ctx.sql("select k, sum(v) as sv, count(*) as n from t "
                      "group by k order by k").to_pydict()
        exp = pd.DataFrame({"k": keys, "v": vals}).groupby("k").agg(
            sv=("v", "sum"), n=("v", "size")).reset_index().sort_values("k")
        np.testing.assert_array_equal(got["k"], exp["k"])
        np.testing.assert_array_equal(np.asarray(got["sv"], np.int64),
                                      exp["sv"].astype(np.int64))
        np.testing.assert_array_equal(np.asarray(got["n"], np.int64),
                                      exp["n"].astype(np.int64))
        assert _shuffle_files(tmp_path) == []

        # same cluster, q5 shape: a partitioned JOIN fused across the
        # process mesh (MeshJoinExec's exchanges cross the boundary too)
        dim = tmp_path / "dim"
        dim.mkdir()
        (dim / "p0.tbl").write_text(
            "".join(f"{i}|cat{i % 4}|\n" for i in range(13)))
        fact = tmp_path / "fact"
        fact.mkdir()
        fk = rng.integers(0, 13, 400)
        fv = rng.integers(0, 100, 400)
        for part in range(2):
            rows = [f"{i}|{fk[i]}|{fv[i]}|\n" for i in range(400)
                    if i % 2 == part]
            (fact / f"p{part}.tbl").write_text("".join(rows))
        ctx2 = BallistaContext.remote(
            "localhost", int(sport), device="cpu",
            **{"join.partitioned.threshold": "1", "join.partitions": "8",
               "agg.partitions": "8", "mesh.devices": "8"})
        ctx2.register_source("dim", TblSource(
            str(dim), schema(("dkey", Int64), ("cat", Utf8)), device="cpu"),
            primary_key="dkey")
        ctx2.register_source("fact", TblSource(
            str(fact), schema(("fid", Int64), ("fkey", Int64),
                              ("v", Int64)), device="cpu"))
        got2 = ctx2.sql("select cat, sum(v) as sv, count(*) as n from "
                        "fact, dim where fkey = dkey group by cat "
                        "order by cat").to_pydict()
        fd = pd.DataFrame({"fkey": fk, "v": fv})
        fd["cat"] = fd.fkey.map(lambda k: f"cat{k % 4}")
        exp2 = fd.groupby("cat").agg(sv=("v", "sum"), n=("v", "size")) \
            .reset_index().sort_values("cat")
        np.testing.assert_array_equal(got2["cat"], exp2["cat"])
        np.testing.assert_array_equal(np.asarray(got2["sv"], np.int64),
                                      exp2["sv"].astype(np.int64))
        np.testing.assert_array_equal(np.asarray(got2["n"], np.int64),
                                      exp2["n"].astype(np.int64))
        assert _shuffle_files(tmp_path) == [], "join wrote shuffle files"
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
