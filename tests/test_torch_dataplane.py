"""The port's data plane (``ballista_tpu_torch/distributed/{dataplane,
spill}.py``, ``native/shuffle_server.cpp``) as the JAX package's tests hold
its own (``tests/test_io_dataplane.py``, ``tests/test_spill.py``):

- network-supplied path components are validated and traversal is
  rejected, by the Python server and by the port's own C++ server;
- the port's C++ server, built from the checkout with ``g++``
  (``native_build.build_shuffle_server``), serves the same bytes as the
  Python server for the same partition and shuffle files, whole and as a
  chunk stream, and ``start_data_plane`` starts it by default;
- the spill pool rotates and unlinks segments, detects truncated and torn
  writes, and the chunk buffer spills past its budget and replays in
  order, releasing every charge.

Tolerance: exact (bytes).
"""

import os

import numpy as np
import pytest

import ballista_tpu_torch as bt
from ballista_tpu_torch.columnar import ColumnBatch
from ballista_tpu_torch.distributed import dataplane, spill
from ballista_tpu_torch.errors import IoError
from ballista_tpu_torch.io import ipc


def test_path_component_ok():
    assert dataplane.path_component_ok("abc123-XY_z")
    assert not dataplane.path_component_ok("")
    assert not dataplane.path_component_ok("..")
    assert not dataplane.path_component_ok("../other")
    assert not dataplane.path_component_ok("/etc")
    assert not dataplane.path_component_ok("a/b")
    assert not dataplane.path_component_ok("a" * 129)


@pytest.fixture(scope="module")
def work_dir(tmp_path_factory):
    """A work directory with one partition file and one shuffle file, and
    a file outside it that a traversal would reach."""
    root = tmp_path_factory.mktemp("dataplane")
    secret = root / "secret" / "1" / "0" / "data.arrow"
    secret.parent.mkdir(parents=True)
    secret.write_bytes(b"SECRET")
    work = root / "work"
    s = bt.schema(("v", bt.Int64), ("k", bt.Utf8))
    batch = ColumnBatch.from_pydict(
        s, {"v": list(range(3000)), "k": [f"k{i % 13}" for i in range(3000)]},
        device="cpu")
    ipc.write_partition(
        dataplane.partition_path(str(work), "jobx", 1, 0), [batch])
    ipc.write_partition(
        dataplane.shuffle_path(str(work), "jobx", 1, 0, 2), [batch])
    return str(work)


@pytest.fixture(params=["python", "native"])
def server(request, work_dir):
    srv = dataplane.start_data_plane("localhost", 0, work_dir,
                                     native=request.param == "native")
    want = ("NativeDataPlane" if request.param == "native"
            else "DataPlaneServer")
    assert type(srv).__name__ == want
    try:
        yield srv
    finally:
        srv.close()


def test_server_rejects_traversal(server, work_dir):
    secret_root = os.path.join(os.path.dirname(work_dir), "secret")
    for job, kw in (("../secret", {}), (secret_root, {}),
                    ("../secret", {"shuffle_output": 0})):
        with pytest.raises(IoError, match="bad job id"):
            dataplane.fetch_partition_bytes("localhost", server.port, job, 1,
                                            0, **kw)
    with pytest.raises(IoError, match="no such|bad"):
        dataplane.fetch_partition_bytes("localhost", server.port, "missing",
                                        1, 0)


@pytest.mark.parametrize("shuffle_output", [None, 2])
def test_servers_serve_the_files_bytes(server, work_dir, shuffle_output):
    path = (dataplane.partition_path(work_dir, "jobx", 1, 0)
            if shuffle_output is None
            else dataplane.shuffle_path(work_dir, "jobx", 1, 0, 2))
    want = open(path, "rb").read()
    whole = dataplane.fetch_partition_bytes(
        "localhost", server.port, "jobx", 1, 0,
        shuffle_output=shuffle_output)
    assert whole == want
    chunks = list(dataplane.fetch_partition_chunks(
        "localhost", server.port, "jobx", 1, 0,
        shuffle_output=shuffle_output, window_bytes=8192, chunk_bytes=4096))
    assert b"".join(chunks) == want
    assert max(len(c) for c in chunks) <= 4096
    _, arrays, _, dicts, _ = ipc.read_partition_arrays_from_chunks(chunks)
    assert list(arrays["v"][:3]) == [0, 1, 2]


def test_native_server_is_the_default(work_dir, monkeypatch):
    monkeypatch.delenv("BALLISTA_NATIVE_DATAPLANE", raising=False)
    srv = dataplane.start_data_plane("localhost", 0, work_dir)
    try:
        assert isinstance(srv, dataplane.NativeDataPlane)
        assert os.path.basename(dataplane._native_server_bin()).startswith(
            "shuffle_server-")
    finally:
        srv.close()
    monkeypatch.setenv("BALLISTA_NATIVE_DATAPLANE", "off")
    srv = dataplane.start_data_plane("localhost", 0, work_dir)
    try:
        assert isinstance(srv, dataplane.DataPlaneServer)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# spill pool and chunk buffer
# ---------------------------------------------------------------------------


def test_spill_pool_rotates_and_unlinks(tmp_path):
    pool = spill.SpillPool(str(tmp_path), max_file_bytes=1000)
    refs = [pool.append(bytes([i]) * 600) for i in range(4)]
    assert pool.segments_created >= 2
    for i, r in enumerate(refs):
        assert r.read() == bytes([i]) * 600
    live = {r._seg.path for r in refs}
    for r in refs:
        r.release()
    pool.close()
    for path in live:
        assert not os.path.exists(path), f"segment survived release: {path}"


def test_truncated_spill_segment_detected(tmp_path):
    pool = spill.SpillPool(str(tmp_path), max_file_bytes=1 << 20)
    ref = pool.append(b"x" * 500)
    with open(ref._seg.path, "r+b") as fh:
        fh.truncate(100)
    with pytest.raises(IoError):
        ref.read()
    ref.release()
    pool.close()


def test_torn_write_mid_segment_detected(tmp_path, monkeypatch):
    from ballista_tpu_torch.testing.faults import reload_faults

    monkeypatch.setenv("BALLISTA_FAULTS", "shuffle.spill.write=drop-once")
    reload_faults()
    try:
        pool = spill.SpillPool(str(tmp_path), max_file_bytes=1 << 20)
        torn = pool.append(b"A" * 1000)   # drop-once: 500 bytes on disk
        after = pool.append(b"B" * 1000)  # appends at the real end
        with pytest.raises(IoError, match="torn"):
            torn.read()
        assert after.read() == b"B" * 1000
        torn.release()
        after.release()
        pool.close()
    finally:
        monkeypatch.delenv("BALLISTA_FAULTS")
        reload_faults()


def test_chunk_buffer_spills_and_replays_in_order(tmp_path, monkeypatch):
    monkeypatch.setenv("BALLISTA_SHUFFLE_MEM_BUDGET", "8192")
    monkeypatch.setenv("BALLISTA_SHUFFLE_SPILL_DIR", str(tmp_path))
    spill._reset_pool()
    gov = spill.governor()
    base = gov.stats()["spilled_bytes_total"]
    buf = spill.ChunkBuffer()
    chunks = [bytes([i]) * 3000 for i in range(8)]  # 24 KB >> budget
    for c in chunks:
        buf.put(c)
    assert buf.spilled_bytes > 0, "a tiny budget must divert to disk"
    assert gov.stats()["spilled_bytes_total"] > base
    assert b"".join(buf.chunks()) == b"".join(chunks)
    buf.close()
    assert gov.inflight_bytes == 0
    spill._reset_pool()


def test_remote_read_spills_and_equals_local(work_dir, tmp_path,
                                             monkeypatch):
    """A shuffle reader forced onto the data plane with a tiny budget
    spills the fetched chunks and reads what the local path reads."""
    from ballista_tpu_torch.distributed.types import PartitionLocation
    from ballista_tpu_torch.physical.shuffle import ShuffleReaderExec

    monkeypatch.setenv("BALLISTA_SHUFFLE_MEM_BUDGET", "8192")
    monkeypatch.setenv("BALLISTA_SHUFFLE_SPILL_DIR", str(tmp_path))
    monkeypatch.setenv("BALLISTA_SHUFFLE_CHUNK_BYTES", "4096")
    spill._reset_pool()
    s = bt.schema(("v", bt.Int64), ("k", bt.Utf8))
    srv = dataplane.start_data_plane("localhost", 0, work_dir, native=False)
    try:
        loc = PartitionLocation(
            "jobx", 1, 0, "e", "localhost", srv.port,
            path=dataplane.partition_path(work_dir, "jobx", 1, 0))
        local = ShuffleReaderExec([loc], s, device="cpu")
        remote = ShuffleReaderExec([loc], s, device="cpu")
        monkeypatch.setattr(ShuffleReaderExec, "FORCE_REMOTE", True)
        got = [b.to_pydict() for b in remote.execute(0)]
        monkeypatch.setattr(ShuffleReaderExec, "FORCE_REMOTE", False)
        want = [b.to_pydict() for b in local.execute(0)]
    finally:
        srv.close()
        spill._reset_pool()
    assert remote.metrics().values()["spilled_bytes"] > 0
    assert remote.metrics().values()["remote_fetches"] == 1
    assert local.metrics().values()["local_reads"] == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["v"], w["v"])
        assert list(g["k"]) == list(w["k"])
