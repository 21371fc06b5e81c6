"""etcd v3 HA state backend + an in-process fake etcd for tests.

The reference's HA story is an etcd backend with get/prefix/
put-with-lease and a distributed lock at /ballista_global_lock
(reference: rust/scheduler/src/state/etcd.rs:29-113). ``EtcdBackend``
speaks the same etcd v3 gRPC wire protocol (etcdserverpb.KV/Lease +
v3lockpb.Lock — see proto/etcd.proto, field numbers match etcd's).

HA model: ONE active scheduler + warm standbys. All durable state
(jobs, stages, tasks, executor metadata) lives in etcd, so a standby
started against the same namespace rehydrates and takes over after the
active dies. Active-ACTIVE scheduling is NOT supported: the event-driven
ready-queue is per-process (the reference achieves active-active only by
re-scanning every task under the global etcd lock on each poll —
state/mod.rs:182-260 — the very pattern this engine replaced for
scalability). The distributed lock below serves takeover/maintenance
sections; while held, a background LeaseKeepAlive stream renews the
lease so critical sections may exceed the TTL, and a keepalive failure
fails the section loudly instead of silently losing mutual exclusion.

No etcd binary ships in this environment, so tests run against
``FakeEtcdServer`` — an in-process implementation of the same four
services on the same wire protocol (the pattern the reference uses for
its scheduler tests: real service objects, direct or localhost calls).
"""

from __future__ import annotations

import threading
import time
from concurrent import futures
from typing import Dict, List, Optional, Tuple

import grpc

from ..proto import etcd_pb2 as epb
from .state import KvBackend

LOCK_NAME = b"/ballista_global_lock"  # reference: etcd.rs:93
_KV = "etcdserverpb.KV"
_LEASE = "etcdserverpb.Lease"
_LOCK = "v3lockpb.Lock"


def prefix_range_end(prefix: bytes) -> bytes:
    """etcd prefix convention: end = prefix with its last byte + 1."""
    b = bytearray(prefix)
    for i in reversed(range(len(b))):
        if b[i] < 0xFF:
            b[i] += 1
            return bytes(b[: i + 1])
    return b"\0"  # all-0xff prefix: scan to the end of keyspace


class EtcdBackend(KvBackend):
    """KvBackend over the etcd v3 API (first URL of ``urls`` is used)."""

    def __init__(self, urls: str, lock_ttl_secs: int = 15):
        target = urls.split(",")[0].strip()
        if "://" in target:
            target = target.split("://", 1)[1]
        self.channel = grpc.insecure_channel(target)
        self._lock_ttl = lock_ttl_secs
        # key -> lease id of the previous leased put, revoked on renewal
        # so heartbeat writes don't accrue orphan leases until TTL.
        # Leased puts serialize PER KEY (the race is per-key; a global
        # lock would convoy every executor's heartbeat behind ~3 etcd
        # RPCs of whichever arrived first); _key_leases_mu only guards
        # the lock-table itself
        self._key_leases: Dict[str, int] = {}
        self._key_locks: Dict[str, threading.Lock] = {}
        self._key_leases_mu = threading.Lock()

        def stub(service, method, resp_t):
            return self.channel.unary_unary(
                f"/{service}/{method}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_t.FromString,
            )

        self._range = stub(_KV, "Range", epb.RangeResponse)
        self._put = stub(_KV, "Put", epb.PutResponse)
        self._delete = stub(_KV, "DeleteRange", epb.DeleteRangeResponse)
        self._grant = stub(_LEASE, "LeaseGrant", epb.LeaseGrantResponse)
        self._revoke = stub(_LEASE, "LeaseRevoke", epb.LeaseRevokeResponse)
        self._keepalive = self.channel.stream_stream(
            f"/{_LEASE}/LeaseKeepAlive",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=epb.LeaseKeepAliveResponse.FromString,
        )
        self._lock = stub(_LOCK, "Lock", epb.LockResponse)
        self._unlock = stub(_LOCK, "Unlock", epb.UnlockResponse)

    # -- KvBackend -----------------------------------------------------------

    def get(self, key: str) -> Optional[bytes]:
        resp = self._range(epb.RangeRequest(key=key.encode()))
        return resp.kvs[0].value if resp.kvs else None

    def get_from_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        p = prefix.encode()
        resp = self._range(
            epb.RangeRequest(key=p, range_end=prefix_range_end(p))
        )
        return [(kv.key.decode(), kv.value) for kv in resp.kvs]

    def put(self, key: str, value: bytes, lease_secs: Optional[int] = None):
        if not lease_secs:
            self._put(epb.PutRequest(key=key.encode(), value=value))
            return
        # etcd lease TTLs are fixed at grant time (extending needs the
        # streaming KeepAlive RPC), so each leased write re-grants and
        # revokes the key's PREVIOUS lease to avoid accumulation. The
        # whole grant+put+record+revoke sequence is serialized per key:
        # two interleaved puts of the SAME key could otherwise record
        # the live lease as "old" and revoke it, deleting the key and
        # making the executor look dead until its next heartbeat.
        with self._key_leases_mu:
            klock = self._key_locks.setdefault(key, threading.Lock())
        with klock:
            lease_id = self._grant(
                epb.LeaseGrantRequest(TTL=lease_secs)
            ).ID
            self._put(epb.PutRequest(key=key.encode(), value=value,
                                     lease=lease_id))
            old = self._key_leases.get(key)
            self._key_leases[key] = lease_id
            if old:
                self._revoke(epb.LeaseRevokeRequest(ID=old))

    def delete(self, key: str):
        self._delete(epb.DeleteRangeRequest(key=key.encode()))

    def lock(self):
        """Distributed lock whose lease is KEPT ALIVE while held: a
        background thread runs the LeaseKeepAlive stream so critical
        sections longer than the TTL don't silently lose mutual
        exclusion. If the keepalive cannot reach etcd (or etcd reports
        the lease gone), mutual exclusion is no longer guaranteed — the
        section fails LOUDLY: ``held()`` flips False and ``__exit__``
        raises ClusterError instead of pretending the work was safe."""
        backend = self

        class _DistributedLock:
            def held(self_inner) -> bool:
                """True while mutual exclusion is still guaranteed. A
                keepalive ACK older than the TTL counts as lost even if
                the stream hasn't errored — a black-holed connection
                blocks in the read for TCP-retransmit timescales while
                the lease expires server-side."""
                if self_inner._lost.is_set():
                    return False
                if time.time() - self_inner._last_ack[0] > backend._lock_ttl:
                    self_inner._lost.set()
                    return False
                return True

            def __enter__(self_inner):
                lease = backend._grant(
                    epb.LeaseGrantRequest(TTL=backend._lock_ttl)
                ).ID
                self_inner._lease = lease
                self_inner._stop = threading.Event()
                self_inner._lost = threading.Event()
                self_inner._last_ack = [time.time()]
                interval = max(backend._lock_ttl / 3.0, 0.5)

                def keepalive():
                    stop = self_inner._stop

                    def requests():
                        while not stop.is_set():
                            yield epb.LeaseKeepAliveRequest(ID=lease)
                            stop.wait(interval)

                    try:
                        for resp in backend._keepalive(requests()):
                            if stop.is_set():
                                return
                            if resp.TTL <= 0:  # etcd: lease is gone
                                self_inner._lost.set()
                                return
                            self_inner._last_ack[0] = time.time()
                    except Exception:  # noqa: BLE001 - stream died
                        if not stop.is_set():
                            self_inner._lost.set()

                # keepalive starts BEFORE the Lock RPC: a contended
                # acquisition can wait behind the current holder for
                # longer than the TTL, and the lease must survive the
                # wait or etcd fails/poisons the acquisition
                self_inner._ka = threading.Thread(
                    target=keepalive, daemon=True, name="etcd-lock-keepalive"
                )
                self_inner._ka.start()
                try:
                    self_inner._key = backend._lock(
                        epb.LockRequest(name=LOCK_NAME, lease=lease)
                    ).key
                except Exception:
                    self_inner._stop.set()
                    backend._revoke(epb.LeaseRevokeRequest(ID=lease))
                    raise
                self_inner._last_ack[0] = time.time()
                return self_inner

            def __exit__(self_inner, *exc):
                still_held = self_inner.held()  # evaluate BEFORE teardown
                self_inner._stop.set()
                try:
                    backend._unlock(epb.UnlockRequest(key=self_inner._key),
                                    timeout=5.0)
                    backend._revoke(
                        epb.LeaseRevokeRequest(ID=self_inner._lease),
                        timeout=5.0)
                except Exception:  # noqa: BLE001 - etcd may be gone
                    pass
                self_inner._ka.join(timeout=2.0)
                if not still_held and exc == (None, None, None):
                    from ..errors import ClusterError

                    raise ClusterError(
                        "etcd lock lease was lost while held (keepalive "
                        "failed or TTL expired): the critical section ran "
                        "WITHOUT mutual exclusion and must not be trusted"
                    )
                return False

        return _DistributedLock()

    def close(self):
        self.channel.close()


# ---------------------------------------------------------------------------
# In-process fake etcd (tests / single-host development)
# ---------------------------------------------------------------------------


class _FakeEtcdState:
    def __init__(self):
        self.kv: Dict[bytes, Tuple[bytes, int]] = {}  # key -> (value, lease)
        self.leases: Dict[int, float] = {}  # id -> expiry
        self.lease_ttls: Dict[int, int] = {}  # id -> granted TTL (keepalive)
        self.next_lease = 1
        self.mu = threading.Lock()
        self.lock_mu = threading.Lock()  # the global lock itself

    def alive(self, lease_id: int) -> bool:
        if lease_id == 0:
            return True
        exp = self.leases.get(lease_id)
        return exp is not None and time.time() <= exp


class FakeEtcdServer:
    """Implements the KV/Lease/Lock subset on the real wire protocol."""

    def __init__(self, host: str = "localhost", port: int = 0):
        st = self._st = _FakeEtcdState()

        def Range(req: epb.RangeRequest, ctx=None):
            resp = epb.RangeResponse()
            with st.mu:
                if req.range_end == b"\0":
                    # etcd convention: range_end "\0" = to keyspace end
                    keys = sorted(k for k in st.kv if k >= req.key)
                elif req.range_end:
                    keys = sorted(
                        k for k in st.kv
                        if req.key <= k < req.range_end
                    )
                else:
                    keys = [req.key] if req.key in st.kv else []
                for k in keys:
                    v, lease = st.kv[k]
                    if not st.alive(lease):
                        continue
                    resp.kvs.add(key=k, value=v, lease=lease)
            resp.count = len(resp.kvs)
            return resp

        def Put(req: epb.PutRequest, ctx=None):
            with st.mu:
                st.kv[req.key] = (req.value, req.lease)
            return epb.PutResponse()

        def DeleteRange(req: epb.DeleteRangeRequest, ctx=None):
            resp = epb.DeleteRangeResponse()
            with st.mu:
                if req.range_end:
                    doomed = [k for k in st.kv
                              if req.key <= k < req.range_end]
                else:
                    doomed = [req.key] if req.key in st.kv else []
                for k in doomed:
                    del st.kv[k]
                resp.deleted = len(doomed)
            return resp

        def LeaseGrant(req: epb.LeaseGrantRequest, ctx=None):
            with st.mu:
                lid = req.ID or st.next_lease
                st.next_lease = max(st.next_lease, lid) + 1
                st.leases[lid] = time.time() + req.TTL
                st.lease_ttls[lid] = req.TTL
            return epb.LeaseGrantResponse(ID=lid, TTL=req.TTL)

        def LeaseRevoke(req: epb.LeaseRevokeRequest, ctx=None):
            with st.mu:
                st.leases.pop(req.ID, None)
                doomed = [k for k, (_, l) in st.kv.items() if l == req.ID]
                for k in doomed:
                    del st.kv[k]
            return epb.LeaseRevokeResponse()

        def LeaseKeepAlive(request_iterator, ctx=None):
            # etcd semantics: each ping extends an ALIVE lease to its
            # original TTL; a dead/unknown lease answers TTL=0.
            # (yield OUTSIDE the lock: a stalled stream consumer must
            # not pin st.mu across generator suspension)
            for req in request_iterator:
                with st.mu:
                    ttl = st.lease_ttls.get(req.ID)
                    if ttl is not None and st.alive(req.ID):
                        st.leases[req.ID] = time.time() + ttl
                        resp = epb.LeaseKeepAliveResponse(ID=req.ID, TTL=ttl)
                    else:
                        resp = epb.LeaseKeepAliveResponse(ID=req.ID, TTL=0)
                yield resp

        def Lock(req: epb.LockRequest, ctx=None):
            st.lock_mu.acquire()
            return epb.LockResponse(key=req.name + b"/held")

        def Unlock(req: epb.UnlockRequest, ctx=None):
            try:
                st.lock_mu.release()
            except RuntimeError:
                pass
            return epb.UnlockResponse()

        services = {
            _KV: {"Range": (Range, epb.RangeRequest),
                  "Put": (Put, epb.PutRequest),
                  "DeleteRange": (DeleteRange, epb.DeleteRangeRequest)},
            _LEASE: {"LeaseGrant": (LeaseGrant, epb.LeaseGrantRequest),
                     "LeaseRevoke": (LeaseRevoke, epb.LeaseRevokeRequest)},
            _LOCK: {"Lock": (Lock, epb.LockRequest),
                    "Unlock": (Unlock, epb.UnlockRequest)},
        }
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        for service, methods in services.items():
            handlers = {
                name: grpc.unary_unary_rpc_method_handler(
                    fn,
                    request_deserializer=req_t.FromString,
                    response_serializer=lambda m: m.SerializeToString(),
                )
                for name, (fn, req_t) in methods.items()
            }
            if service == _LEASE:
                handlers["LeaseKeepAlive"] = grpc.stream_stream_rpc_method_handler(
                    LeaseKeepAlive,
                    request_deserializer=epb.LeaseKeepAliveRequest.FromString,
                    response_serializer=lambda m: m.SerializeToString(),
                )
            self.server.add_generic_rpc_handlers(
                (grpc.method_handlers_generic_handler(service, handlers),)
            )
        self.port = self.server.add_insecure_port(f"{host}:{port}")
        self.server.start()

    def stop(self):
        self.server.stop(grace=None)
