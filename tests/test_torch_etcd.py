"""The port's etcd state backend (``distributed/etcd.py`` and
``proto/etcd_pb2.py``, copies of the JAX package's) and layered config
(the counterpart of ``tests/test_etcd_config.py``). No etcd binary runs
here, so the backend speaks to the in-process ``FakeEtcdServer``, which
serves the same etcd v3 wire protocol:

- key/value round trips, prefix reads, lease expiry, the distributed
  lock (mutual exclusion, the keepalive outliving the TTL, a lost lease
  failing loudly);
- the scheduler's state machine over etcd, rehydrated by a standby;
- the wire: the port's backend reads and writes the same keys as the JAX
  package's backend on one server (each reads what the other wrote);
- a port ``LocalCluster`` on etcd state answers q1 equal to the
  standalone port;
- layered config precedence and coercion errors.
"""

import threading
import time

import pytest

from ballista_tpu_torch.distributed.config import layered_config
from ballista_tpu_torch.distributed.etcd import (EtcdBackend,
                                                 FakeEtcdServer,
                                                 prefix_range_end)
from ballista_tpu_torch.distributed.state import SchedulerState
from ballista_tpu_torch.distributed.types import ExecutorMeta

from torch_warm_path import (assert_equals_reference, generate_tpch,
                             pinned_threads, port_ctx, sql)


@pytest.fixture(scope="module", autouse=True)
def _pinned():
    # one thread: this file runs a cluster's task threads
    with pinned_threads(1):
        yield


@pytest.fixture()
def server():
    s = FakeEtcdServer()
    yield s
    s.stop()


@pytest.fixture()
def etcd(server):
    backend = EtcdBackend(f"localhost:{server.port}")
    yield backend
    backend.close()


def test_prefix_range_end():
    assert prefix_range_end(b"/a") == b"/b"
    assert prefix_range_end(b"/a\xff") == b"/b"
    assert prefix_range_end(b"\xff") == b"\0"


def test_etcd_kv_roundtrip(etcd):
    etcd.put("/ballista/ns/a", b"1")
    etcd.put("/ballista/ns/b", b"2")
    etcd.put("/other", b"3")
    assert etcd.get("/ballista/ns/a") == b"1"
    assert etcd.get("/missing") is None
    assert etcd.get_from_prefix("/ballista/ns/") == [
        ("/ballista/ns/a", b"1"), ("/ballista/ns/b", b"2")]
    etcd.delete("/ballista/ns/a")
    assert etcd.get("/ballista/ns/a") is None


def test_etcd_lease_expiry(etcd):
    etcd.put("/lease/k", b"v", lease_secs=1)
    assert etcd.get("/lease/k") == b"v"
    time.sleep(1.2)
    assert etcd.get("/lease/k") is None
    assert etcd.get_from_prefix("/lease/") == []


def test_etcd_distributed_lock_mutual_exclusion(etcd):
    order = []

    def worker(tag):
        with etcd.lock():
            order.append((tag, "in"))
            time.sleep(0.05)
            order.append((tag, "out"))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads), (
        "test_etcd_distributed_lock_mutual_exclusion: a worker did not end "
        "within 30 s")
    for i in range(0, len(order), 2):
        assert order[i][0] == order[i + 1][0]
        assert order[i][1] == "in" and order[i + 1][1] == "out"


def test_lock_keepalive_outlives_ttl(server):
    backend = EtcdBackend(f"localhost:{server.port}", lock_ttl_secs=1)
    try:
        with backend.lock() as lk:
            time.sleep(2.2)  # > 2 TTLs
            assert lk.held(), "keepalive failed to renew the lock lease"
            assert server._st.alive(lk._lease)
    finally:
        backend.close()


def test_lock_lost_lease_fails_loudly(server):
    from ballista_tpu_torch.errors import ClusterError
    from ballista_tpu_torch.proto import etcd_pb2 as epb

    backend = EtcdBackend(f"localhost:{server.port}", lock_ttl_secs=1)
    try:
        with pytest.raises(ClusterError, match="mutual exclusion"):
            with backend.lock() as lk:
                backend._revoke(epb.LeaseRevokeRequest(ID=lk._lease))
                deadline = time.time() + 3
                while lk.held() and time.time() < deadline:
                    time.sleep(0.05)
                assert not lk.held(), "lost lease never detected"
    finally:
        backend.close()


def test_scheduler_state_over_etcd(etcd):
    state = SchedulerState(etcd, "ha")
    state.save_executor_metadata(ExecutorMeta("e1", "host1", 1234, 1))
    metas = state.get_executors_metadata()
    assert [m.id for m in metas] == ["e1"] and metas[0].num_devices == 1
    state2 = SchedulerState(etcd, "ha")
    assert [m.id for m in state2.get_executors_metadata()] == ["e1"]


def test_port_and_reference_backends_share_one_server(server, etcd):
    """Both backends speak one wire protocol: the JAX package's backend
    reads the port's writes and the other way round."""
    from ballista_tpu.distributed.etcd import EtcdBackend as RefBackend

    ref = RefBackend(f"localhost:{server.port}")
    try:
        etcd.put("/x/port", b"p")
        ref.put("/x/ref", b"r")
        assert ref.get("/x/port") == b"p"
        assert etcd.get_from_prefix("/x/") == ref.get_from_prefix("/x/") \
            == [("/x/port", b"p"), ("/x/ref", b"r")]
    finally:
        ref.close()


def test_cluster_on_etcd_state_answers_q1(etcd, tmp_path):
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.distributed.executor import (Executor,
                                                         ExecutorConfig)
    from ballista_tpu_torch.distributed.scheduler import serve_scheduler
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    data_dir = generate_tpch(str(tmp_path / "tpch"))
    state = SchedulerState(etcd, "etcd-q1")
    sched, svc, port = serve_scheduler(state, "localhost", 0,
                                       metrics_port=-1)
    ex = Executor(ExecutorConfig(
        scheduler_host="localhost", scheduler_port=port,
        work_dir=str(tmp_path / "work"), concurrent_tasks=2,
        device="cpu", metrics_port=-1))
    ex.start()
    try:
        ctx = BallistaContext.remote("localhost", port, device="cpu")
        register_tpch(ctx, data_dir, tables=["lineitem"])
        got = ctx.sql(sql("q1")).collect()
        want = port_ctx(data_dir).sql(sql("q1")).to_pydict()
        assert list(got) == list(want)
        assert_equals_reference(want, got)
        assert [m.id for m in state.get_executors_metadata()] == [ex.id]
    finally:
        ex.stop()
        svc.close_health()
        sched.stop(grace=1)


def test_layered_config_precedence(tmp_path):
    pytest.importorskip("tomllib")
    cfg_file = tmp_path / "scheduler.toml"
    cfg_file.write_text('port = 6000\nnamespace = "filens"\n')
    defaults = {"port": 50050, "namespace": "default", "bind_host": "0.0.0.0"}
    out = layered_config("scheduler", defaults, str(cfg_file), env={})
    assert out["port"] == 6000 and out["namespace"] == "filens"
    assert out["bind_host"] == "0.0.0.0"
    out = layered_config("scheduler", defaults, str(cfg_file),
                         env={"BALLISTA_SCHEDULER_PORT": "7000"})
    assert out["port"] == 7000
    out = layered_config("scheduler", defaults, str(cfg_file),
                         env={"BALLISTA_SCHEDULER_PORT": "7000"},
                         cli={"port": "8000", "namespace": None})
    assert out["port"] == 8000 and out["namespace"] == "filens"


def test_layered_config_bad_coercion():
    with pytest.raises(ValueError, match="port"):
        layered_config("scheduler", {"port": 1},
                       env={"BALLISTA_SCHEDULER_PORT": "not-a-number"})
