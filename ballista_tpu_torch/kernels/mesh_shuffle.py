"""In-mesh hash shuffle: the on-device replacement for the host shuffle.

The port of the JAX package's ``kernels/mesh_shuffle.py`` (there an ICI
``lax.all_to_all`` inside ``shard_map``). With static shapes:

1. each slot computes a destination slot per live row (the splitmix64
   hash of the key modulo the slot count, the host shuffle's hash);
2. each slot groups its rows by destination with a stable sort and
   writes them into send buffers ``[n_dev, dest_capacity]`` (padded);
3. the stacked send buffers ``[src, dst, cap]`` are exchanged
   (``SlotAxis.all_to_all``: the first two axes swap);
4. per-source row counts travel alongside, so each receiver rebuilds the
   live mask of its ``[n_dev * dest_capacity]`` output rows.

``dest_capacity`` bounds the rows one slot sends to one destination; the
caller picks it and checks the returned per-destination counts for
overflow. No step reads a device value on the host, so the exchange may
sit inside a captured program: the counts are an ``index_add_`` into
``n_dev + 1`` buckets (``torch.bincount`` would read its maximum back),
and rows past a buffer's capacity, which JAX's scatter drops, go to a
trash slot that is sliced off.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .hashing import hash_partition_ids


def destination_ids(keys: torch.Tensor, live: torch.Tensor,
                    n_dev: int) -> torch.Tensor:
    """int32 destination slot per row (dead rows -> 0). Shares the
    partitioning hash with the host shuffle (``hashing.
    hash_partition_ids``), so both planes agree on every row's place."""
    return torch.where(live, hash_partition_ids(keys.to(torch.int64), n_dev),
                       0)


def send_buffers(columns: Sequence[torch.Tensor], live: torch.Tensor,
                 dest: torch.Tensor, n_dev: int, dest_capacity: int
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One slot's half of the exchange: (per column a send buffer
    ``[n_dev, dest_capacity, ...]``, int64 rows per destination
    ``[n_dev]``, before the capacity cut)."""
    n = live.shape[0]
    dev = live.device
    # dead rows go to the trash bucket n_dev
    d = torch.where(live, dest.to(torch.int64).clamp(0, n_dev), n_dev)
    order = torch.argsort(d, stable=True)
    d_sorted = d[order]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    first_of_dest = torch.searchsorted(
        d_sorted, torch.arange(n_dev + 1, dtype=torch.int64, device=dev))
    rank = idx - first_of_dest[d_sorted]
    counts = torch.zeros((n_dev + 1,), dtype=torch.int64, device=dev)
    counts.index_add_(0, d, torch.ones_like(d))
    counts = counts[:n_dev]
    # rows with no place (dead, or past the capacity) land in the trash
    # slot n_dev * dest_capacity, cut off below
    oob = n_dev * dest_capacity
    slot_ok = (d_sorted < n_dev) & (rank < dest_capacity)
    slot = torch.where(slot_ok,
                       d_sorted.clamp(max=n_dev - 1) * dest_capacity + rank,
                       oob)
    bufs = []
    for col in columns:
        buf = torch.zeros((oob + 1,) + tuple(col.shape[1:]), dtype=col.dtype,
                          device=dev)
        buf[slot] = col[order]
        bufs.append(buf[:oob].reshape((n_dev, dest_capacity)
                                      + tuple(col.shape[1:])))
    return bufs, counts


def all_to_all_rows(columns: Sequence[torch.Tensor], live: torch.Tensor,
                    dest: torch.Tensor, axis, n_dev: int, dest_capacity: int
                    ) -> Tuple[List[torch.Tensor], torch.Tensor,
                               torch.Tensor]:
    """Exchange rows so each lands on its destination slot.

    Takes stacked ``[n_local, N]`` columns, live mask and destinations
    and the mesh's ``SlotAxis``. Returns (columns each ``[n_local, n_dev
    * dest_capacity]``, their live mask, per-slot send counts ``[n_local,
    n_dev]``: callers check ``max(counts) <= dest_capacity`` for
    overflow)."""
    per_slot = [send_buffers([c[q] for c in columns], live[q], dest[q],
                             n_dev, dest_capacity)
                for q in range(live.shape[0])]
    counts = torch.stack([c for _, c in per_slot])
    out_cols = []
    for i, col in enumerate(columns):
        buf = torch.stack([bufs[i] for bufs, _ in per_slot])
        got = axis.all_to_all(buf)  # [local dst, src, cap, ...]
        out_cols.append(got.reshape((got.shape[0], n_dev * dest_capacity)
                                    + tuple(col.shape[2:])))
    # counts destined to each local slot, from each source slot
    my_counts = axis.all_to_all(
        counts.clamp(max=dest_capacity)[..., None])[..., 0]
    pos = torch.arange(n_dev * dest_capacity, dtype=torch.int64,
                       device=live.device)
    rank_out = pos % dest_capacity
    src_of = pos // dest_capacity
    out_live = rank_out[None, :] < my_counts[:, src_of]
    return out_cols, out_live, counts
