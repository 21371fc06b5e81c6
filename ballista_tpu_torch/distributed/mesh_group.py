"""Executor mesh groups: one fused task, many processes, one mesh.

The port of the JAX package's ``distributed/mesh_group.py``, over host
sockets as there. A mesh group is a set of executor processes (one per
card or host) that joined one ``torch.distributed`` group
(``parallel/multihost.py``) and therefore see ONE global mesh of slots.
The group acts as a single logical executor:

- the LEADER (rank 0) polls the scheduler normally and reports the
  GLOBAL slot count, so mesh fusion plans against the whole group;
- when the leader receives a mesh-fused task it broadcasts the task
  bytes to the followers over the group channel, then every process
  enters the same program together, and its row exchange crosses
  process boundaries through the group's collectives (NCCL between
  cards, gloo between CPU processes) instead of the host data plane;
- outputs are gathered to every process (``physical/mesh_agg.py``
  ``_host_visible``), so the leader alone materializes and reports.

Limitations, as in the JAX package: group tasks run one at a time
(collectives must align across processes); a follower crash mid-task
can strand the leader inside a collective — the scheduler's task lease
reaping then re-queues the work, but the group itself must be
restarted.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import List, Optional

log = logging.getLogger("ballista.mesh_group")

_ACK_OK = 0
_ACK_FAILED = 1

# Longest a single group task may run on a follower before the leader
# gives up waiting for its ack. A timeout here is a GROUP failure (the
# SPMD streams desynchronize), so it is deliberately generous; override
# via BALLISTA_MESH_GROUP_ACK_TIMEOUT for larger-than-usual workloads.
import os as _os

ACK_TIMEOUT_SECS = float(
    _os.environ.get("BALLISTA_MESH_GROUP_ACK_TIMEOUT", 3600)
)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("mesh group channel closed")
        buf.extend(chunk)
    return bytes(buf)


class GroupLeader:
    """Rank-0 side of the group channel.

    Every broadcast carries a monotonically increasing sequence number
    that followers ECHO with their ack; ``wait_acks`` discards acks from
    older broadcasts, so a leader-side task failure (which skips waiting)
    can never desynchronize completion status onto the next task.
    """

    def __init__(self, bind_host: str, port: int, num_followers: int,
                 accept_timeout: float = 60.0):
        self.num_followers = num_followers
        self.lock = threading.Lock()  # one group task at a time
        self._srv = socket.create_server((bind_host, port))
        self.port = self._srv.getsockname()[1]
        self._conns: List[socket.socket] = []
        self._accept_timeout = accept_timeout
        self._seq = 0

    def wait_members(self) -> None:
        self._srv.settimeout(self._accept_timeout)
        while len(self._conns) < self.num_followers:
            conn, addr = self._srv.accept()
            # ack wait bound = the longest a group task may run on a
            # follower; generous because exceeding it desynchronizes the
            # group's SPMD streams (leader re-broadcasts while the
            # follower is still inside the old task's collectives)
            conn.settimeout(ACK_TIMEOUT_SECS)
            self._conns.append(conn)
            log.info("mesh group follower joined from %s (%d/%d)", addr,
                     len(self._conns), self.num_followers)

    def broadcast(self, payload: bytes) -> int:
        self._seq += 1
        for c in self._conns:
            c.sendall(struct.pack(">QI", self._seq, len(payload)) + payload)
        return self._seq

    def wait_acks(self, seq: Optional[int] = None) -> None:
        seq = self._seq if seq is None else seq
        errors = []
        for i, c in enumerate(self._conns):
            while True:
                (ack_seq,) = struct.unpack(">Q", _recv_exact(c, 8))
                status = _recv_exact(c, 1)[0]
                msg = b""
                if status != _ACK_OK:
                    (n,) = struct.unpack(">I", _recv_exact(c, 4))
                    msg = _recv_exact(c, n)
                if ack_seq < seq:
                    continue  # stale ack from a task the leader abandoned
                break
            if status != _ACK_OK:
                errors.append(
                    f"follower {i}: {msg.decode(errors='replace')}")
        if errors:
            raise RuntimeError("; ".join(errors))

    def close(self) -> None:
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._srv.close()


def run_follower(leader_host: str, leader_port: int, device="cpu",
                 connect_timeout: float = 60.0) -> None:
    """Follower loop: receive fused tasks from the leader and enter
    their programs in lockstep, with the plan's slots on ``device``;
    never talks to the scheduler. Returns when the leader closes the
    channel."""
    from ..physical.fusion import maybe_fuse
    from ..proto import ballista_pb2 as pb
    from .. import serde

    # retry with backoff: the group's init is a barrier, so the leader
    # only binds the channel after every member's init — a follower
    # leaving the barrier first would lose the race
    import time as _time

    deadline = _time.time() + connect_timeout
    while True:
        try:
            sock = socket.create_connection((leader_host, leader_port),
                                            timeout=5.0)
            break
        except OSError:
            if _time.time() >= deadline:
                raise
            _time.sleep(0.2)
    sock.settimeout(None)  # tasks arrive whenever the leader has one
    log.info("mesh group follower connected to %s:%d", leader_host,
             leader_port)
    while True:
        try:
            seq, n = struct.unpack(">QI", _recv_exact(sock, 12))
        except ConnectionError:
            log.info("mesh group channel closed; follower exiting")
            return
        td = pb.TaskDefinition()
        td.ParseFromString(_recv_exact(sock, n))
        try:
            # fused as the leader's executor fuses it, so both run the
            # same collectives in the same order
            plan = maybe_fuse(serde.physical_from_proto(td.plan,
                                                        device=device))
            nparts = plan.output_partitioning().num_partitions
            for p in range(nparts):
                for _ in plan.execute(p):
                    pass  # outputs are replicated; the leader materializes
            sock.sendall(struct.pack(">Q", seq) + bytes([_ACK_OK]))
        except Exception as e:  # noqa: BLE001 - report to the leader
            log.exception("follower task failed")
            msg = f"{type(e).__name__}: {e}".encode()
            sock.sendall(struct.pack(">Q", seq) + bytes([_ACK_FAILED])
                         + struct.pack(">I", len(msg)) + msg)
