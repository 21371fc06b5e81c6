"""Multi-process mesh: one stage program spanning executor processes.

The port of the JAX package's ``parallel/multihost.py``. There, executor
processes join one ``jax.distributed`` runtime and see one global device
mesh. Here they join one ``torch.distributed`` process group:

- every process owns the same number of local slots, all on its device,
  and the global mesh is processes x local slots, ordered by rank
  (``global_mesh``);
- the host-side group is gloo over a TCP store. CPU slots exchange their
  rows over it; CUDA slots exchange theirs over a second, NCCL group.
  NCCL refuses two ranks on one card, and gloo cannot exchange CUDA
  tensors, so a group whose CUDA slots share a card raises at
  ``init_group`` instead of routing rows through host memory;
- the collectives: ``host_max`` and ``all_max`` are an ``all_reduce``
  with MAX, ``gather`` (and ``replicate_stacked``) an ``all_gather``,
  and ``exchange`` one ``all_to_all_single`` of ``[local_src,
  global_dst, cap]`` send buffers.

In one process every function reduces to ``mesh.SlotAxis``'s tensor ops.
Every process runs the same program (multi-controller): the group's
leader broadcasts a fused task to the others (``distributed/
mesh_group.py``), all enter its collectives together, and a replicated
output lets the leader report the result.
"""

from __future__ import annotations

import socket
from typing import Dict, List, Optional, Sequence

import torch

from ..errors import ExecutionError

# the group this process joined: rank, world, local slots, device, the
# host (gloo) group and the group that carries row data
_GROUP: Dict[str, object] = {}


def init_group(coordinator: str, num_processes: int, process_id: int,
               local_device_count: Optional[int] = None,
               device="cpu") -> None:
    """Join this process to the mesh group at ``coordinator``
    (``host:port`` of rank 0's TCP store) with ``local_device_count``
    slots (default 1) on ``device``. Idempotent."""
    import torch.distributed as dist

    if _GROUP:
        return
    dev = torch.device(device)
    local = int(local_device_count or 1)
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    # every member's (host, card, slots), before any row moves
    ident = (socket.gethostname(), _card_id(dev), str(dev), local)
    idents: List[tuple] = [None] * num_processes  # type: ignore[list-item]
    dist.all_gather_object(idents, ident)
    problem = None
    cards = [i[:2] for i in idents]
    if len({i[3] for i in idents}) != 1:
        problem = (f"mesh group members own different slot counts "
                   f"{[i[3] for i in idents]}: every process needs the "
                   "same")
    elif dev.type == "cuda" and len(set(cards)) != len(cards):
        problem = ("mesh group processes share a card: NCCL refuses two "
                   "ranks on one card and gloo cannot exchange CUDA "
                   "tensors; run the slots in one process "
                   "(--num-devices) instead")
    if problem is not None:
        # every member sees the same identities and leaves here too
        dist.barrier()
        dist.destroy_process_group()
        raise ExecutionError(problem)
    data_group = None  # the default (gloo) group
    if dev.type == "cuda":
        data_group = dist.new_group(backend="nccl")
    _GROUP.update(rank=process_id, world=num_processes, local=local,
                  device=dev, devices=[i[2] for i in idents],
                  data_group=data_group)


def shutdown_group(barrier: bool = True) -> None:
    """Leave the mesh group: wait for every member (``barrier``), then
    destroy the process groups. A process group still alive when the
    interpreter exits aborts the process from its background threads
    ("terminate called without an active exception"); the barrier keeps
    rank 0, which serves the TCP store, from leaving first."""
    import torch.distributed as dist

    if not _GROUP:
        return
    if dist.is_initialized():
        if barrier:
            dist.barrier()
        dist.destroy_process_group()
    _GROUP.clear()


def _card_id(dev: torch.device) -> str:
    """What names a card across processes: its UUID ("" for the CPU)."""
    if dev.type != "cuda":
        return ""
    return str(torch.cuda.get_device_properties(dev).uuid)


def is_multiprocess() -> bool:
    return bool(_GROUP) and int(_GROUP["world"]) > 1


def global_mesh(axis: str = "data"):
    """The mesh over every process's slots, ordered by rank."""
    from .mesh import Mesh

    if not _GROUP:
        raise ExecutionError("no mesh group: call init_group first")
    local = int(_GROUP["local"])
    rank = int(_GROUP["rank"])
    devices = []
    for r, d in enumerate(_GROUP["devices"]):
        # the local slots name this process's device itself
        devices += [_GROUP["device"] if r == rank else d] * local
    return Mesh(devices, axis, range(rank * local, (rank + 1) * local),
                distributed=True, group=_GROUP["data_group"])


def local_slot_range(mesh) -> List[int]:
    """Global slot indices owned by THIS process."""
    return list(mesh.local_slots)


def _check_device(t: torch.Tensor, mesh) -> None:
    if t.device.type == "cuda" and mesh.group is None:
        raise ExecutionError(
            "gloo cannot exchange CUDA tensors: this mesh group was "
            "initialized for CPU slots")


def all_max(m: torch.Tensor, mesh) -> torch.Tensor:
    """0-d max over every process's 0-d ``m``."""
    import torch.distributed as dist

    _check_device(m, mesh)
    t = m.to(torch.int64).reshape(1).clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t[0].to(m.dtype)


def host_max(arr: torch.Tensor) -> int:
    """Max over a stacked tensor's entries on every process, as a host
    int every process holds."""
    local = int(arr.max())
    if not is_multiprocess():
        return local
    import torch.distributed as dist

    t = torch.tensor([local], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)  # the host (gloo) group
    return int(t[0])


def gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """``[local, ...]`` on every process -> ``[n_slots, ...]``."""
    import torch.distributed as dist

    _check_device(x, mesh)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(int(_GROUP["world"]))]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def exchange(x: torch.Tensor, mesh) -> torch.Tensor:
    """``[local_src, global_dst, ...]`` -> ``[local_dst, global_src,
    ...]`` across the group: one ``all_to_all_single``."""
    import torch.distributed as dist

    _check_device(x, mesh)
    world = int(_GROUP["world"])
    n_local = x.shape[0]
    rest = tuple(x.shape[2:])
    # destination-major, so each process's chunk is contiguous:
    # [world (dst process), local dst, local src, ...]
    send = x.transpose(0, 1).contiguous().reshape(
        (world, n_local, n_local) + rest)
    recv = torch.empty_like(send)  # [world (src process), dst, src, ...]
    dist.all_to_all_single(recv, send, group=mesh.group)
    return recv.transpose(0, 1).reshape((n_local, world * n_local) + rest)


def replicate_stacked(stacked, mesh):
    """Stacked local slots -> every slot's part on every process (an
    ``all_gather`` per leaf): the leader materializes a fused stage's
    (small) final output from it."""
    from .mesh import tree_map

    return tree_map(lambda x: gather(x, mesh), stacked)


def stack_local_to_global(slot_batches: Sequence, mesh):
    """Per-LOCAL-slot trees -> this process's part of the global stacked
    tree, on its device (other slots live on their processes)."""
    from .mesh import stack, tree_map

    if len(slot_batches) != mesh.n_local:
        raise ExecutionError(f"{len(slot_batches)} local slot batches for "
                             f"{mesh.n_local} local slots")
    dev = mesh.device
    return stack([tree_map(lambda x: x.to(dev), b) for b in slot_batches])
