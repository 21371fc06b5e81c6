"""Shuffle data plane: socket protocol for partition fetch.

The port's copy of the JAX package's ``distributed/dataplane.py``; only
the native daemon's binary differs: the port builds its own copy of
``native/shuffle_server.cpp`` (``native_build.build_shuffle_server``).
The role Arrow Flight ``do_get`` plays in Ballista (FetchPartition). Wire
format (also spoken by the native C++ server, ``native/shuffle_server.cpp``):

  request:  u32_be length | ballista_tpu.Action protobuf
  response: u8 status (0=ok, 1=error) | u64_be length | payload
            payload = Arrow IPC file bytes (ok) or utf-8 error message

Streaming extension (docs/shuffle.md): a request whose Action carries
``stream_window > 0`` asks for a flow-controlled chunk stream instead
of one whole-partition payload. A server that understands it (the
Python server here) answers with status byte 2 followed by frames

  u32_be n | n chunk bytes        (one bounded chunk)
  u32_be 0                        (clean end of stream)
  u32_be 0xFFFFFFFF | u32_be len | message   (mid-stream error)

and suspends once more than ``stream_window`` bytes are in flight
unacknowledged — the reader acks each consumed chunk with a bare
``u32_be n``. The native C++ daemon predates the field, skips it
(protobuf unknown-field semantics) and answers with the legacy framing;
clients consume that body in bounded chunk reads, so memory stays
bounded on either server.

Python server threads serve from the executor work_dir; the C++ server is a
drop-in replacement on the same protocol.
"""

from __future__ import annotations

import os
import socket
import socketserver
import struct
import threading
from collections import deque
from typing import Iterator, Optional

from ..errors import IoError
from ..proto import ballista_pb2 as pb

# job ids whose in-flight chunk streams must abort (the executor marks
# them on a CancelJob broadcast): the server-side stream writer checks
# per chunk, so cancellation propagates INTO mid-flight transfers
# instead of waiting for the file to finish streaming
_cancelled_lock = threading.Lock()
_cancelled_jobs: deque = deque(maxlen=256)


def mark_job_cancelled(job_id: str) -> None:
    with _cancelled_lock:
        if job_id not in _cancelled_jobs:
            _cancelled_jobs.append(job_id)


def job_stream_cancelled(job_id: str) -> bool:
    with _cancelled_lock:
        return job_id in _cancelled_jobs


def path_component_ok(s: str) -> bool:
    """Network-supplied path components must be short alnum/-/_ tokens
    (mirrors shuffle_server.cpp path_component_ok; job ids are 7-char
    alphanumeric). Rejects traversal ('..'), separators, and absolute
    paths (os.path.join would discard work_dir for those)."""
    return (
        0 < len(s) <= 128
        and all((c.isascii() and c.isalnum()) or c in "-_" for c in s)
    )


def partition_path(work_dir: str, job_id: str, stage_id: int,
                   partition_id: int) -> str:
    # layout mirrors the reference's work_dir/{job}/{stage}/{part}/data.arrow
    # (reference: flight_service.rs:104-126)
    return os.path.join(work_dir, job_id, str(stage_id), str(partition_id),
                        "data.arrow")


def shuffle_file_name(output_partition: int) -> str:
    # single source of truth for the shuffle file naming scheme (the C++
    # server mirrors it; see shuffle_server.cpp)
    return f"shuffle-{output_partition}.arrow"


def shuffle_path(work_dir: str, job_id: str, stage_id: int,
                 producer_partition: int, output_partition: int) -> str:
    # hash-shuffled stages write one file per consumer partition
    return os.path.join(work_dir, job_id, str(stage_id),
                        str(producer_partition),
                        shuffle_file_name(output_partition))


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    from ..lifecycle import check_cancel

    buf = bytearray()
    while len(buf) < n:
        # a cancelled query stops pulling between recvs even mid-frame
        # (no-op for server handler threads, which bind no token)
        check_cancel()
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise IoError("data plane connection closed early")
        buf.extend(chunk)
    return bytes(buf)


def _fetch_action(job_id: str, stage_id: int, partition_id: int,
                  shuffle_output: "int | None") -> pb.Action:
    action = pb.Action()
    if shuffle_output is not None:
        action.fetch_shuffle.producer.job_id = job_id
        action.fetch_shuffle.producer.stage_id = stage_id
        action.fetch_shuffle.producer.partition_id = partition_id
        action.fetch_shuffle.output_partition = shuffle_output
    else:
        action.fetch_partition.job_id = job_id
        action.fetch_partition.stage_id = stage_id
        action.fetch_partition.partition_id = partition_id
    return action


def fetch_partition_bytes(host: str, port: int, job_id: str, stage_id: int,
                          partition_id: int, timeout: float = 60.0,
                          shuffle_output: "int | None" = None) -> bytes:
    action = _fetch_action(job_id, stage_id, partition_id, shuffle_output)
    payload = action.SerializeToString()
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(struct.pack(">I", len(payload)) + payload)
        status = _recv_exact(sock, 1)[0]
        (length,) = struct.unpack(">Q", _recv_exact(sock, 8))
        body = _recv_exact(sock, length)
    if status != 0:
        raise IoError(f"fetch failed: {body.decode(errors='replace')}")
    return body


_STREAM_ERROR_FRAME = 0xFFFFFFFF


def fetch_partition_chunks(host: str, port: int, job_id: str,
                           stage_id: int, partition_id: int,
                           timeout: float = 60.0,
                           shuffle_output: "int | None" = None,
                           window_bytes: "int | None" = None,
                           chunk_bytes: "int | None" = None,
                           ) -> Iterator[bytes]:
    """Streaming fetch: yields the partition's bytes in bounded chunks.

    Negotiates the chunk-stream framing via ``Action.stream_window``; a
    legacy peer (the native C++ daemon) ignores the field and answers
    with the whole-payload framing, which is then consumed in
    ``chunk_bytes`` reads — either way no whole-partition buffer ever
    exists on this side, and the caller controls the pace (it pulls the
    generator), which IS the flow control: acks are sent only after the
    previous chunk was consumed, so a slow consumer idles the wire at
    ``window_bytes`` in flight, not at the partition size."""
    from ..lifecycle import check_cancel
    from .spill import shuffle_chunk_bytes, stream_window_bytes

    window = int(window_bytes or stream_window_bytes())
    piece = int(chunk_bytes or shuffle_chunk_bytes())
    action = _fetch_action(job_id, stage_id, partition_id, shuffle_output)
    action.stream_window = window
    action.stream_chunk = piece
    payload = action.SerializeToString()
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        sock.sendall(struct.pack(">I", len(payload)) + payload)
        status = _recv_exact(sock, 1)[0]
        if status == 1:
            (length,) = struct.unpack(">Q", _recv_exact(sock, 8))
            body = _recv_exact(sock, length)
            raise IoError(f"fetch failed: {body.decode(errors='replace')}")
        if status == 0:
            # legacy whole-payload framing (native server): the length
            # is known up front; consume the body in bounded reads
            (length,) = struct.unpack(">Q", _recv_exact(sock, 8))
            remaining = length
            while remaining > 0:
                # chunk-level cancellation: a fired token aborts the
                # fetch of a multi-GB legacy-framed body mid-transfer
                # even when the consumer forgets to check
                check_cancel()
                chunk = _recv_exact(sock, min(piece, remaining))
                remaining -= len(chunk)
                yield chunk
            return
        if status != 2:
            raise IoError(f"bad data-plane status byte {status}")
        while True:
            check_cancel()  # per-frame: cancel aborts mid-stream fetches
            (n,) = struct.unpack(">I", _recv_exact(sock, 4))
            if n == 0:
                return
            if n == _STREAM_ERROR_FRAME:
                (mlen,) = struct.unpack(">I", _recv_exact(sock, 4))
                msg = _recv_exact(sock, mlen)
                raise IoError(
                    f"stream failed: {msg.decode(errors='replace')}")
            chunk = _recv_exact(sock, n)
            yield chunk
            # ack AFTER the consumer resumed us: in-flight unacked
            # bytes measure what the reader has genuinely not absorbed.
            # A send failure is NOT a stream failure — a server that
            # already sent its end marker closes without draining the
            # trailing acks; the next frame read is the source of truth
            try:
                sock.sendall(struct.pack(">I", n))
            except OSError:
                pass
    finally:
        try:
            sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        from ..testing.faults import fault_point

        try:
            # "drop" = close without a response (the peer sees a dead
            # connection, exactly like a mid-transfer crash); "fail"
            # raises and is reported as an error response below. Only
            # the Python server has this point — the native C++ daemon
            # is out of fault-injection reach (tests arm it with
            # BALLISTA_NATIVE_DATAPLANE=off).
            if fault_point("dataplane.serve") == "drop":
                return
            (length,) = struct.unpack(">I", _recv_exact(self.request, 4))
            action = pb.Action()
            action.ParseFromString(_recv_exact(self.request, length))
            which = action.WhichOneof("action_type")
            if which == "fetch_partition":
                f = action.fetch_partition
                job_id = f.job_id
                path = partition_path(
                    self.server.work_dir, f.job_id, f.stage_id, f.partition_id
                )
            elif which == "fetch_shuffle":
                fs = action.fetch_shuffle
                job_id = fs.producer.job_id
                path = shuffle_path(
                    self.server.work_dir, fs.producer.job_id,
                    fs.producer.stage_id, fs.producer.partition_id,
                    fs.output_partition,
                )
            else:
                raise IoError(f"unsupported data-plane action {which}")
            if not path_component_ok(job_id):
                raise IoError("bad job id")
            if not os.path.exists(path):
                raise IoError(f"no such partition: {path}")
            if action.stream_window > 0 and self.server.stream_serve:
                self._serve_stream(path, job_id,
                                   int(action.stream_window),
                                   int(action.stream_chunk))
                return
            with open(path, "rb") as fh:
                body = fh.read()
            self.request.sendall(struct.pack(">BQ", 0, len(body)))
            self.request.sendall(body)
        except Exception as e:  # noqa: BLE001 - report to peer
            msg = str(e).encode()
            try:
                self.request.sendall(struct.pack(">BQ", 1, len(msg)) + msg)
            except OSError:
                pass

    def _serve_stream(self, path: str, job_id: str, window: int,
                      req_chunk: int = 0) -> None:
        """Flow-controlled chunk stream (status byte 2; framing in the
        module docstring). The writer suspends on the peer's acks once
        ``window`` bytes are unacknowledged, checks the cancelled-job
        registry per chunk (a CancelJob aborts mid-flight transfers, not
        just future ones) and exposes the ``dataplane.flow`` fault point
        (drop = close mid-stream like a crashed peer; fail = tagged
        error frame). Transport errors just end the handler — the peer
        sees a dead connection and takes its retry/recovery path."""
        from ..testing.faults import fault_point
        from .spill import shuffle_chunk_bytes

        sock = self.request
        # the reader's requested frame size, capped by this server's own
        # chunk bound (a peer must not force huge frames on us)
        piece = shuffle_chunk_bytes()
        if req_chunk > 0:
            piece = min(piece, req_chunk)
        sock.settimeout(60.0)  # ack reads must not wedge a dead peer
        sock.sendall(b"\x02")
        unacked = 0
        try:
            with open(path, "rb") as fh:
                while True:
                    if job_stream_cancelled(job_id):
                        self._stream_error(f"job {job_id} cancelled")
                        return
                    # "fail" raises out to the error frame below;
                    # "drop" = close mid-stream like a crashed peer
                    if fault_point("dataplane.flow", path=path) == "drop":
                        return
                    chunk = fh.read(piece)
                    if not chunk:
                        break
                    # window-bounded ack drain; the enclosing per-chunk
                    # loop re-checks the cancelled-job registry
                    # ballista: ignore[cancel-coverage]
                    while unacked + len(chunk) > window and unacked > 0:
                        (acked,) = struct.unpack(
                            ">I", _recv_exact(sock, 4))
                        unacked -= acked
                    sock.sendall(struct.pack(">I", len(chunk)) + chunk)
                    unacked += len(chunk)
            sock.sendall(struct.pack(">I", 0))
        except (OSError, IoError):
            return  # peer vanished mid-stream; nothing to report to
        except Exception as e:  # noqa: BLE001 - report mid-stream
            self._stream_error(f"{type(e).__name__}: {e}")

    def _stream_error(self, msg: str) -> None:
        data = msg.encode()
        try:
            self.request.sendall(
                struct.pack(">II", _STREAM_ERROR_FRAME, len(data)) + data)
        except OSError:
            pass


class DataPlaneServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    # tests flip this off to pin the legacy whole-payload framing (the
    # same path a native C++ peer answers with)
    stream_serve = True

    def __init__(self, host: str, port: int, work_dir: str):
        super().__init__((host, port), _Handler)
        self.work_dir = work_dir

    @property
    def port(self) -> int:
        return self.server_address[1]

    def close(self):
        """Stop serving AND close the listening socket — shutdown() alone
        leaves the OS accepting (and never answering) connections, so
        peers hang until their recv timeout instead of getting refused."""
        self.shutdown()
        self.server_close()


class NativeDataPlane:
    """The C++ shuffle server (native/shuffle_server.cpp) as the
    production data plane: a thread-per-connection daemon with zero GIL
    involvement, so partition serving never contends with task execution
    in the executor process (the reference's equivalent is the tokio
    Flight service, rust/executor/src/flight_service.rs:193-228). Same
    wire protocol and path layout as ``DataPlaneServer``."""

    def __init__(self, port: int, work_dir: str, bind_host: str = ""):
        import subprocess

        bin_path = _native_server_bin()
        if bin_path is None:
            raise IoError("native shuffle server not built")
        cmd = [bin_path, str(port), work_dir]
        if bind_host:
            cmd.append(bind_host)
        # The binary ties its lifetime to THIS process (PDEATHSIG +
        # getppid watch against SHUFFLE_SERVER_PARENT_PID), so a
        # SIGKILLed executor can't orphan a daemon wedging the
        # configured port — and no preexec_fn is needed here (fork
        # hooks deadlock in a multithreaded process).
        env = dict(os.environ)
        env["SHUFFLE_SERVER_PARENT_PID"] = str(os.getpid())
        self._proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env,
        )
        line = self._read_banner(timeout_s=10.0)
        try:
            self.port = int(line.split("port")[1].split()[0])
        except (IndexError, ValueError):
            self._proc.terminate()
            self._proc.wait(timeout=5)
            raise IoError(
                f"native shuffle server failed to start: {line!r}")
        self.work_dir = work_dir

    def _read_banner(self, timeout_s: float) -> str:
        """First stdout line with a deadline: a child that binds but
        never prints must fall back to the Python server, not hang the
        executor constructor."""
        import select

        fd = self._proc.stdout.fileno()
        ready, _, _ = select.select([fd], [], [], timeout_s)
        if not ready:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except Exception:  # noqa: BLE001 - escalate
                self._proc.kill()
            raise IoError(
                f"native shuffle server silent for {timeout_s:.0f}s")
        return self._proc.stdout.readline()

    def close(self):
        self._proc.terminate()
        try:
            self._proc.wait(timeout=5)
        except Exception:  # noqa: BLE001 - escalate to SIGKILL
            self._proc.kill()
            self._proc.wait(timeout=5)


def _native_server_bin() -> Optional[str]:
    """Path to the port's own shuffle_server build
    (``native/shuffle_server.cpp``, built by ``native_build`` into
    ``_build/`` at first use); None when it cannot be built."""
    from ..native_build import build_shuffle_server

    try:
        return build_shuffle_server()
    except Exception:  # noqa: BLE001 - the Python server takes over
        import logging

        logging.getLogger(__name__).warning(
            "native shuffle server build failed", exc_info=True)
        return None


def native_dataplane_enabled(value: Optional[str] = None) -> bool:
    """Single parse rule for the data-plane selector (env or config):
    'off'/'0'/'false' (any case) disables the native daemon."""
    if value is None:
        value = os.environ.get("BALLISTA_NATIVE_DATAPLANE", "on")
    return str(value).lower() not in ("off", "0", "false")


def start_data_plane(host: str, port: int, work_dir: str,
                     native: Optional[bool] = None):
    """Start the shuffle data plane; returns an object with .port/.close().

    The native C++ daemon is the default; ``BALLISTA_NATIVE_DATAPLANE=off``
    (or native=False) selects the in-process Python server, which also
    remains the automatic fallback when the binary can't be built."""
    if native is None:
        native = native_dataplane_enabled()
    if native:
        try:
            return NativeDataPlane(port, work_dir, bind_host=host)
        except Exception as e:  # noqa: BLE001 - fall back to Python server
            import logging

            logging.getLogger(__name__).warning(
                "native data plane unavailable (%s); using Python server", e)
    server = DataPlaneServer(host, port, work_dir)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="ballista-data-plane")
    t.start()
    return server
