"""The port's Arrow Flight front-end (``distributed/flight.py``, a copy of
the JAX package's, and ``scheduler_main --flight-port``) on the CPU (the
counterpart of ``tests/test_flight.py``). A stock ``pyarrow.flight``
client speaks to it, as the reference's JDBC driver does:

- raw SQL bytes as the ``DoGet`` ticket stream back the port's result,
  schema first; ``GetFlightInfo`` echoes the command as the ticket; a
  proto ``Action`` ticket streams a partition file the port wrote; a
  failing query surfaces as a ``FlightError``; a ``to_timestamp`` keeps
  its time of day;
- the scheduler binary (``python -m ballista_tpu_torch.distributed.
  scheduler_main --flight-port 0 --device cpu``, two in-process
  executors on the CPU): tables registered by ``CREATE EXTERNAL TABLE``
  tickets, TPC-H SF0.002 q1 and ``EXPLAIN q1`` equal the port's
  standalone results, and q11, q15 and q22 (one scalar subquery each,
  resolved by the binary's loopback context on its ``--device``) equal
  the JAX package's;
- the JAX package's Flight client reads the port's server and the port's
  module equals the JAX package's text.
"""

import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

paflight = pytest.importorskip("pyarrow.flight")

from ballista_tpu_torch.client import BallistaContext  # noqa: E402
from ballista_tpu_torch.datatypes import Int64, Utf8, schema  # noqa: E402
from ballista_tpu_torch.distributed.flight import serve_flight  # noqa: E402
from ballista_tpu_torch.io import TblSource  # noqa: E402
from ballista_tpu_torch.testing.tpch_schema import tpch_ddl  # noqa: E402

from torch_warm_path import (assert_equals_reference,  # noqa: E402
                             generate_tpch, pinned_threads, port_ctx,
                             reference_result, sql)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def _pinned():
    # one thread: this file runs a cluster's task threads
    with pinned_threads(1):
        yield


@pytest.fixture()
def sql_server(tmp_path):
    d = tmp_path / "t"
    d.mkdir()
    (d / "p0.tbl").write_text(
        "".join(f"k{i % 4}|{i}|\n" for i in range(200)))
    ctx = BallistaContext.standalone(device="cpu")
    ctx.register_source("t", TblSource(str(d), schema(("k", Utf8),
                                                      ("v", Int64)),
                                       device="cpu"))

    def execute_sql(text):
        return ctx.sql(text).collect()

    server, port = serve_flight("127.0.0.1", 0, execute_sql=execute_sql)
    yield ctx, port
    server.shutdown()


def test_jdbc_driver_byte_exchange(sql_server):
    ctx, port = sql_server
    client = paflight.connect(f"grpc://127.0.0.1:{port}")
    text = "select k, sum(v) as sv from t group by k order by k"
    reader = client.do_get(paflight.Ticket(text.encode("utf-8")))
    assert reader.schema.names == ["k", "sv"]
    got = reader.read_all().to_pandas()
    exp = ctx.sql(text).to_pydict()
    np.testing.assert_array_equal(got["k"], exp["k"])
    np.testing.assert_array_equal(got["sv"].astype(np.int64), exp["sv"])


def test_get_flight_info_endpoint_echoes_command(sql_server):
    _, port = sql_server
    client = paflight.connect(f"grpc://127.0.0.1:{port}")
    info = client.get_flight_info(
        paflight.FlightDescriptor.for_command(b"select count(*) as n from t"))
    assert len(info.endpoints) == 1
    reader = client.do_get(info.endpoints[0].ticket)
    assert int(reader.read_all()["n"][0].as_py()) == 200


def test_fetch_partition_ticket(tmp_path):
    from ballista_tpu_torch.columnar import ColumnBatch
    from ballista_tpu_torch.distributed.dataplane import partition_path
    from ballista_tpu_torch.io import ipc
    from ballista_tpu_torch.proto import ballista_pb2 as pb

    s = schema(("a", Int64), ("name", Utf8))
    b = ColumnBatch.from_pydict(
        s, {"a": [1, 2, 3], "name": ["x", "y", "x"]}, device="cpu")
    path = partition_path(str(tmp_path), "jobX", 2, 0)
    os.makedirs(os.path.dirname(path))
    ipc.write_partition(path, [b])
    server, port = serve_flight("127.0.0.1", 0, work_dir=str(tmp_path))
    try:
        client = paflight.connect(f"grpc://127.0.0.1:{port}")
        action = pb.Action()
        action.fetch_partition.job_id = "jobX"
        action.fetch_partition.stage_id = 2
        action.fetch_partition.partition_id = 0
        got = client.do_get(paflight.Ticket(
            action.SerializeToString())).read_all().to_pandas()
        assert list(got["a"]) == [1, 2, 3]
        assert list(got["name"]) == ["x", "y", "x"]
    finally:
        server.shutdown()


def test_sql_error_surfaces_as_flight_error(sql_server):
    _, port = sql_server
    client = paflight.connect(f"grpc://127.0.0.1:{port}")
    with pytest.raises(paflight.FlightError):
        client.do_get(
            paflight.Ticket(b"select nope from missing_table")).read_all()


def test_timestamp_ns_precision_preserved(sql_server):
    ctx, port = sql_server
    ctx.register_memtable("tstab", schema(("s", Utf8)),
                          {"s": ["2024-01-02T10:30:45"]})
    client = paflight.connect(f"grpc://127.0.0.1:{port}")
    got = client.do_get(paflight.Ticket(
        b"select to_timestamp(s) as t from tstab")).read_all().to_pandas()
    assert str(got["t"][0]) == "2024-01-02 10:30:45"


def test_flight_module_equals_the_reference():
    for module in ("distributed/flight.py", "distributed/etcd.py",
                   "proto/etcd_pb2.py", "proto/etcd.proto"):
        with open(os.path.join(ROOT, "ballista_tpu", module)) as fh:
            theirs = fh.read().replace("ballista_tpu", "ballista_tpu_torch")
        with open(os.path.join(ROOT, "ballista_tpu_torch", module)) as fh:
            assert fh.read() == theirs, module


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("tpch_flight")))


@pytest.fixture(scope="module")
def binary_flight(tpch_dir):
    """The scheduler binary with its Flight endpoint on the CPU
    (``--device cpu``) and two in-process executors, with the tables
    the queries read registered the way a Flight client does: DDL
    tickets."""
    from ballista_tpu_torch.distributed.executor import (Executor,
                                                         ExecutorConfig)

    env = dict(os.environ, PYTHONPATH=ROOT, BALLISTA_INGEST_THREADS="1",
               BALLISTA_SCAN_THREADS="1", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "ballista_tpu_torch.distributed.scheduler_main", "--port", "0",
         "--bind-host", "127.0.0.1", "--flight-port", "0", "--device",
         "cpu", "--metrics-port", "-1"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    executors, lines = [], []
    try:
        ports = {}
        deadline = time.time() + 90
        while len(ports) < 2 and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            for key, pat in (("grpc", r"listening on [\d.]+:(\d+)"),
                             ("flight", r"Flight SQL endpoint on "
                                        r"[\d.]+:(\d+)")):
                m = re.search(pat, line)
                if m:
                    ports[key] = int(m.group(1))
        assert len(ports) == 2, "".join(lines)
        for _ in range(2):
            e = Executor(ExecutorConfig(
                scheduler_host="127.0.0.1", scheduler_port=ports["grpc"],
                concurrent_tasks=2, device="cpu"))
            e.start()
            executors.append(e)
        client = paflight.connect(f"grpc://127.0.0.1:{ports['flight']}")
        for table in ("lineitem", "nation", "supplier", "partsupp",
                      "customer", "orders"):
            status = client.do_get(paflight.Ticket(
                tpch_ddl(table, tpch_dir).encode())).read_all()
            assert status["status"].to_pylist() == ["OK"]
        yield client
    finally:
        for e in executors:
            e.stop()
        proc.send_signal(signal.SIGINT)
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


def test_binary_flight_q1_equals_standalone(binary_flight, tpch_dir):
    got = binary_flight.do_get(
        paflight.Ticket(sql("q1").encode())).read_all().to_pandas()
    assert_equals_reference(port_ctx(tpch_dir).sql(sql("q1")).to_pydict(),
                            got)


def test_binary_flight_explain_equals_standalone(binary_flight, tpch_dir):
    text = "EXPLAIN " + sql("q1")
    got = binary_flight.do_get(
        paflight.Ticket(text.encode())).read_all().to_pydict()
    want = port_ctx(tpch_dir).sql(text).to_pydict()
    assert got["plan_type"] == list(want["plan_type"])
    assert got["plan"] == list(want["plan"])


@pytest.mark.parametrize("q", ["q11", "q15", "q22"])
def test_binary_flight_scalar_subquery_equals_reference(binary_flight,
                                                        tpch_dir, q):
    got = binary_flight.do_get(
        paflight.Ticket(sql(q).encode())).read_all().to_pandas()
    assert_equals_reference({c: got[c].to_numpy() for c in got.columns},
                            reference_result(tpch_dir, q))


def test_reference_client_reads_the_port_server(sql_server):
    """The JAX package's side of the wire (its own module's client
    helpers are pyarrow's): the same ticket bytes give the same table."""
    from ballista_tpu.distributed.flight import _table_from_pydict

    ctx, port = sql_server
    client = paflight.connect(f"grpc://127.0.0.1:{port}")
    text = "select k, count(*) as n from t group by k order by k"
    got = client.do_get(paflight.Ticket(text.encode())).read_all()
    want = _table_from_pydict(
        {k: np.asarray(v) for k, v in ctx.sql(text).to_pydict().items()})
    assert got.to_pydict() == want.to_pydict()
