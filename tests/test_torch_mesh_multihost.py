"""The port's multi-process mesh (``ballista_tpu_torch/parallel/
multihost.py``): twin of ``tests/test_multihost.py``.

Two processes x 2 CPU slots form one 4-slot mesh over a gloo process
group. Each process stacks only its own slots' seeded rows, hashes them
to destinations, exchanges them ACROSS the processes
(``all_to_all_rows`` over the global mesh: one ``all_to_all_single``),
aggregates per slot and all-gathers the group tables. Every process's
result must equal the JAX package's single-process 4-device mesh on the
same seeded data (the same arrays, element for element) and a numpy
oracle.

A group whose CUDA slots would share one card raises at ``init_group``
with the reason (NCCL refuses two ranks on one card; gloo cannot
exchange CUDA tensors): two processes claim one card's UUID here.

Integer outputs: exact.
"""

import json
import os
import socket
import textwrap

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CAP, G, LOCAL = 64, 7, 2


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def slot_rows(slot):
    """test_multihost's per-slot data."""
    rng = np.random.default_rng(100 + slot)
    keys = rng.integers(0, G, CAP).astype(np.int64)
    vals = rng.integers(0, 1000, CAP).astype(np.int64)
    live = rng.random(CAP) < 0.8
    return keys, vals, live


_WORKER = textwrap.dedent("""
    import json, sys
    pid = int(sys.argv[1]); nprocs = int(sys.argv[2]); port = sys.argv[3]
    sys.path.insert(0, "__REPO__"); sys.path.insert(0, "__REPO__/tests")
    import numpy as np
    import torch
    from ballista_tpu_torch.parallel import multihost
    from ballista_tpu_torch.parallel.mesh import SlotAxis
    from ballista_tpu_torch.kernels import mesh_shuffle
    from ballista_tpu_torch.kernels.aggregate import (AggInput,
                                                      grouped_aggregate)
    from test_torch_mesh_multihost import slot_rows, CAP, LOCAL

    multihost.init_group(f"localhost:{port}", nprocs, pid,
                         local_device_count=LOCAL, device="cpu")
    mesh = multihost.global_mesh()
    n_dev = mesh.size
    assert n_dev == LOCAL * nprocs, f"global mesh saw {n_dev} slots"
    axis = SlotAxis(mesh)
    local = multihost.local_slot_range(mesh)
    rows = [slot_rows(s) for s in local]
    k, v, live = (multihost.stack_local_to_global(
        [torch.from_numpy(r[i]) for r in rows], mesh) for i in range(3))
    dest = axis.map(lambda kk, ll: mesh_shuffle.destination_ids(
        kk, ll, n_dev), k, live)
    (k2, v2), live2, _ = mesh_shuffle.all_to_all_rows(
        [k, v], live, dest, axis, n_dev, CAP)

    def agg(kk, vv, ll):
        res = grouped_aggregate([kk], ll, [AggInput("sum", vv, None),
                                           AggInput("count", None, None)], 8)
        keys = torch.where(res.group_valid, kk[res.rep_indices.long()], -1)
        return keys, res.aggregates[0], res.aggregates[1]

    keys, sums, counts = axis.map(agg, k2, v2, live2)
    out = [axis.all_gather(x).reshape(-1).tolist()
           for x in (keys, sums, counts)]
    print("MULTIHOST_RESULT " + json.dumps(out), flush=True)
    multihost.shutdown_group()
    print(f"MULTIHOST_OK p{pid}", flush=True)
""")


def _spawn(script, args):
    from tests.procutil import spawn_script

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return spawn_script(["-c", script] + [str(a) for a in args], env)


def _jax_reference(nd):
    """The JAX package's single-process mesh over ``nd`` of the 8
    virtual devices, on the same slots: gathered keys, sums, counts."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from ballista_tpu.kernels import mesh_shuffle as ref
    from ballista_tpu.kernels.aggregate import AggInput, grouped_aggregate
    from ballista_tpu.parallel.mesh import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:nd]), ("data",))
    st = [np.stack([slot_rows(s)[i] for s in range(nd)]) for i in range(3)]

    @partial(shard_map, mesh=mesh, in_specs=(P("data"),) * 3,
             out_specs=P(), check_vma=False)
    def run(k, v, live):
        k, v, live = k[0], v[0], live[0]
        dest = ref.destination_ids(k, live, nd)
        (k2, v2), live2, _ = ref.all_to_all_rows([k, v], live, dest, "data",
                                                 nd, CAP)
        res = grouped_aggregate([k2], live2,
                                [AggInput("sum", v2, None),
                                 AggInput("count", None, None)], 8)
        keys = jnp.where(res.group_valid, jnp.take(k2, res.rep_indices), -1)
        return tuple(jax.lax.all_gather(x, "data").reshape(-1)
                     for x in (keys, res.aggregates[0], res.aggregates[1]))

    return [np.asarray(x).tolist() for x in jax.jit(run)(*st)]


@pytest.mark.sf02  # heavyweight: spawns a process group
def test_cross_process_mesh_shuffle_aggregation(eight_devices):
    nprocs = 2
    port = _free_port()
    script = _WORKER.replace("__REPO__", REPO)
    procs = [_spawn(script, [i, nprocs, port]) for i in range(nprocs)]
    try:
        for p in procs:
            p.wait_exit(timeout=180)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    want = _jax_reference(nprocs * LOCAL)
    oracle = {}
    for s in range(nprocs * LOCAL):
        k, v, live = slot_rows(s)
        for g in range(G):
            m = live & (k == g)
            if m.any():
                s0, c0 = oracle.get(g, (0, 0))
                oracle[g] = (s0 + int(v[m].sum()), c0 + int(m.sum()))
    for i, p in enumerate(procs):
        out = p.text
        assert p.popen.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK p{i}" in out, out[-3000:]
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("MULTIHOST_RESULT "))
        got = json.loads(line.split(" ", 1)[1])
        assert got == want, f"process {i}"
        groups = {k: (s, c) for k, s, c in zip(*got) if k >= 0}
        assert groups == oracle


_SHARED_CARD = textwrap.dedent("""
    import sys
    pid = int(sys.argv[1]); port = sys.argv[2]
    sys.path.insert(0, "__REPO__")
    from ballista_tpu_torch.errors import ExecutionError
    from ballista_tpu_torch.parallel import multihost
    # both processes name the same card
    multihost._card_id = lambda dev: "GPU-00000000-same-card"
    try:
        multihost.init_group(f"localhost:{port}", 2, pid,
                             local_device_count=2, device="cuda:0")
    except ExecutionError as e:
        print("RAISED " + str(e), flush=True)
        sys.exit(0)
    print("NO ERROR", flush=True)
    sys.exit(1)
""")


def test_group_sharing_a_card_raises():
    port = _free_port()
    script = _SHARED_CARD.replace("__REPO__", REPO)
    procs = [_spawn(script, [i, port]) for i in range(2)]
    try:
        for p in procs:
            p.wait_exit(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p in procs:
        assert p.popen.returncode == 0, p.text[-3000:]
        assert "RAISED mesh group processes share a card" in p.text
        assert "NCCL refuses two ranks on one card" in p.text
        assert "gloo cannot exchange CUDA tensors" in p.text
