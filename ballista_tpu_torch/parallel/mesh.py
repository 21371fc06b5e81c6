"""Mesh query runner: whole query stages as one program over slots.

The port of the JAX package's ``parallel/mesh.py``. There, a stage runs
as one SPMD XLA program under ``shard_map`` over a ``jax.sharding.Mesh``
and its collectives are ``lax`` ops over the mesh axis. Here:

- a ``Mesh`` is a list of slots, each a torch device. Repeats are
  allowed: ``make_mesh(n, device)`` gives n slots on one card (or the
  CPU). The slots of one process share its device; slots on other cards
  belong to other processes of a group (``multihost.py``);
- a stage's rows stay stacked: every leaf of a batch is a ``[n_slots,
  cap]`` tensor (``stack``/``slot``/``tree_map`` below), and each slot's
  work calls the port's single-device functions in a loop over slots
  (``SlotAxis.map``) inside one governed program, so a warm call on a
  card is one CUDA graph replay for all slots;
- the collectives are tensor ops on the stacked layout (``SlotAxis``):
  the ``lax.all_to_all`` of ``[src, dst, cap]`` send buffers swaps the
  first two axes, ``lax.pmax`` is a max over the slot axis, and an
  ``all_gather`` is the stacked tensor itself. In a process group they
  go through ``torch.distributed`` (``multihost.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..columnar import Column, ColumnBatch
from ..datatypes import Schema
from ..errors import ExecutionError
from ..kernels import mesh_shuffle

DATA_AXIS = "data"


class Mesh:
    """Slots of a (possibly multi-process) mesh.

    ``devices`` holds every slot's device, ordered by process rank;
    ``local_slots`` are the slots this process owns, which share one
    device. A mesh across processes is ``distributed``, and ``group`` is
    then the process group its rows travel over (None: the default
    group). Hashable by value, so governed keys may hold it."""

    __slots__ = ("devices", "axis_names", "local_slots", "distributed",
                 "group", "_key")

    def __init__(self, devices: Sequence, axis: str = DATA_AXIS,
                 local_slots: Optional[Sequence[int]] = None,
                 distributed: bool = False, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = (axis,)
        self.local_slots = tuple(range(len(self.devices))
                                 if local_slots is None else local_slots)
        self.distributed = distributed
        self.group = group
        if not self.devices or not self.local_slots:
            raise ExecutionError("a mesh needs at least one slot")
        local = {self.devices[i] for i in self.local_slots}
        if len(local) != 1:
            raise ExecutionError(
                f"the slots of one process share one device, got "
                f"{sorted(str(d) for d in local)}: slots on other cards "
                "belong to other processes of a group (parallel/multihost.py)")
        self._key = (tuple(str(d) for d in self.devices), axis,
                     self.local_slots, distributed, id(group))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def n_local(self) -> int:
        return len(self.local_slots)

    @property
    def device(self) -> torch.device:
        """The device of this process's slots."""
        return self.devices[self.local_slots[0]]

    def __hash__(self) -> int:
        return hash(self._key)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __repr__(self) -> str:
        return (f"Mesh({self.size} slots on {self.device}, local "
                f"{self.local_slots[0]}..{self.local_slots[-1]})")


def make_mesh(n_devices: int = 1, device="cuda",
              axis: str = DATA_AXIS) -> Mesh:
    """``n_devices`` slots on ``device``; in a process that joined a
    mesh group (``multihost.init_group``), the group's global mesh,
    which must have ``n_devices`` slots."""
    from . import multihost

    if multihost.is_multiprocess():
        mesh = multihost.global_mesh(axis)
        if mesh.size != n_devices:
            raise ExecutionError(
                f"need {n_devices} slots, the group's mesh has {mesh.size}")
        return mesh
    if n_devices < 1:
        raise ExecutionError(f"a mesh needs at least one slot, got "
                             f"{n_devices}")
    return Mesh([device] * n_devices, axis)


# ---------------------------------------------------------------------------
# the stacked layout: pytrees of batches, columns, tensors
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, *trees):
    """Apply ``fn`` to the tensors of structurally equal trees (batches,
    columns, tuples, lists; None stays None). Static
    parts (schemas, dtypes, dictionaries) come from the first tree;
    dictionaries must be the same object in every tree, as JAX's
    pytree structures must agree."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if t0 is None:
        return None
    if isinstance(t0, ColumnBatch):
        cols = [tree_map(fn, *cs) for cs in zip(*[t.columns for t in trees])]
        return ColumnBatch(t0.schema, cols,
                           fn(*[t.selection for t in trees]),
                           fn(*[t.num_rows for t in trees]))
    if isinstance(t0, Column):
        if any(t.dictionary is not t0.dictionary for t in trees[1:]):
            raise ExecutionError(
                "slots disagree on a column's dictionary: unify them first "
                "(physical/mesh_input.py::_union_dicts)")
        return Column(fn(*[t.values for t in trees]), t0.dtype,
                      tree_map(fn, *[t.validity for t in trees]),
                      t0.dictionary)
    if isinstance(t0, (tuple, list)):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(out) if isinstance(t0, list) else tuple(out)
    return t0


def stack(trees: Sequence):
    """Per-slot trees -> one tree of ``[n_slots, ...]`` tensors."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def slot(tree, q: int):
    """Slot ``q``'s tree out of a stacked one (views)."""
    return tree_map(lambda x: x[q], tree)


def capacity(stacked) -> int:
    """Per-slot capacity of a stacked batch."""
    return int(stacked.selection.shape[1])


class SlotAxis:
    """The collectives of a mesh's data axis, on stacked tensors whose
    first axis is this process's slots."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_local = mesh.n_local
        self.n_dev = mesh.size
        self.offset = mesh.local_slots[0]

    def map(self, fn: Callable, *stacked):
        """``fn`` over each slot's part of the stacked arguments; its
        results stacked."""
        return stack([fn(*[slot(a, q) for a in stacked])
                      for q in range(self.n_local)])

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[local_src, dst, ...]`` send buffers -> ``[local_dst, src,
        ...]``: slot d receives what every slot sent to d."""
        if not self.mesh.distributed:
            return x.transpose(0, 1).contiguous()
        from . import multihost

        return multihost.exchange(x, self.mesh)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """0-d max over every slot's values (bool: any)."""
        m = x.any() if x.dtype == torch.bool else x.amax()
        if not self.mesh.distributed:
            return m
        from . import multihost

        return multihost.all_max(m, self.mesh)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[local, ...]`` -> ``[n_slots, ...]``."""
        if not self.mesh.distributed:
            return x
        from . import multihost

        return multihost.gather(x, self.mesh)

    def axis_index(self) -> torch.Tensor:
        """int32 ``[local]``: each local slot's index in the mesh."""
        return torch.arange(self.offset, self.offset + self.n_local,
                            dtype=torch.int32, device=self.mesh.device)


def _stack_batches(schema: Schema, batches: List[ColumnBatch], mesh: Mesh):
    """[per-slot ColumnBatch] -> (column name -> values ``[n, cap]``,
    selection ``[n, cap]``, column name -> dictionary), on the mesh's
    device."""
    caps = {b.capacity for b in batches}
    if len(caps) != 1:
        raise ExecutionError(f"slot batches must share capacity, got {caps}")
    dev = mesh.device
    batches = [b.wait_upload() for b in batches]
    cols = {f.name: torch.stack([b.columns[i].values.to(dev)
                                 for b in batches])
            for i, f in enumerate(schema.fields)}
    sel = torch.stack([b.selection.to(dev) for b in batches])
    dicts = {f.name: batches[0].columns[i].dictionary
             for i, f in enumerate(schema.fields)}
    return cols, sel, dicts


class MeshQueryRunner:
    """Runs a stacked batch transform with the mesh's collectives."""

    def __init__(self, mesh: Mesh, axis: str = DATA_AXIS):
        self.mesh = mesh
        self.axis = axis
        self.n_dev = mesh.size

    def run_spmd(self, schema: Schema, batches: List[ColumnBatch],
                 device_fn: Callable):
        """Stack one batch per local slot and run ``device_fn(cols,
        live, axis)`` on the stacked columns (name -> ``[n, cap]``), the
        stacked live mask and the mesh's ``SlotAxis``. Returns
        (``device_fn``'s result, dictionaries). Not governed, as in the
        JAX package: ``device_fn`` is the caller's closure, so its
        identity would be the only sound key."""
        cols, sel, dicts = _stack_batches(schema, batches, self.mesh)
        return device_fn(cols, sel, SlotAxis(self.mesh)), dicts

    def shuffle_fn(self, key_col: str, dest_capacity: int):
        """A helper for ``device_fn``: (cols, live, axis) -> (cols',
        live', overflowed). ``overflowed`` is a 0-d bool tensor, True when
        some slot had more than ``dest_capacity`` rows for one
        destination; rows were then DROPPED and the caller re-runs with a
        larger capacity. The host reads it after the program."""
        n_dev = self.n_dev

        def do_shuffle(cols: Dict[str, torch.Tensor], live: torch.Tensor,
                       axis: SlotAxis):
            names = list(cols)
            dest = axis.map(
                lambda k, lv: mesh_shuffle.destination_ids(k, lv, n_dev),
                cols[key_col], live)
            out_cols, out_live, counts = mesh_shuffle.all_to_all_rows(
                [cols[n] for n in names], live, dest, axis, n_dev,
                dest_capacity)
            # any slot overflowing poisons the global result
            overflowed = axis.pmax(counts.amax(dim=1) > dest_capacity)
            return dict(zip(names, out_cols)), out_live, overflowed

        return do_shuffle
