"""Join kernels.

The port of the JAX package's ``kernels/join.py``. The build side is
*sorted* and the probe side does a vectorized binary search:

- ``build_lookup`` sorts the build keys once;
- ``build_dense`` is a direct-index table for near-dense integer keys, so
  a probe is one gather;
- ``probe_unique`` handles the FK->PK joins that dominate TPC-H (build keys
  unique): one searchsorted + one gather, no row expansion;
- ``probe_expand`` (general many-to-many) computes per-probe match counts
  and materializes matches up to a fixed output capacity.

Keys are single int64 columns (dict codes / ints / dates cast to int64).

JAX clamps out-of-range gathers and drops out-of-range scatters; torch
raises on the CPU and asserts on CUDA. So every gather index here is
clamped into range and every scatter sends the rows JAX would drop to an
explicit trash slot that is sliced off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

INT64_SENTINEL = torch.iinfo(torch.int64).max


@dataclass
class BuildTable:
    """Build side of a join: the sorted representation, or for near-dense
    integer keys a direct-index table (``dense_rows``/``dense_base``)."""

    sorted_keys: Optional[torch.Tensor]  # int64 [Nb] (dead rows = sentinel, at end)
    order: Optional[torch.Tensor]  # int32 [Nb] original row index per sorted slot
    num_live: torch.Tensor  # int64 0-d
    dense_rows: Optional[torch.Tensor] = None  # int32 [R]: key-base -> row | -1
    dense_base: Optional[int] = None


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with the index clamped into range, as JAX gathers."""
    return table[idx.to(torch.int64).clamp(0, table.shape[0] - 1)]


def build_lookup(keys: torch.Tensor, live: torch.Tensor) -> BuildTable:
    keyed = torch.where(live, keys.to(torch.int64), INT64_SENTINEL)
    order = torch.argsort(keyed, stable=True)
    return BuildTable(keyed[order], order.to(torch.int32), live.sum())


def build_dense(keys: torch.Tensor, live: torch.Tensor, base: int,
                size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct-index build: scatter live rows into a [size] table keyed by
    ``key - base``. Returns (dense_rows int32 [size] with -1 = empty,
    has_duplicates bool 0-d). Which of several rows with one key lands in
    the table is unspecified, as in the JAX package; the flag sends such
    builds to the sorted path."""
    n = keys.shape[0]
    idx = keys.to(torch.int64) - base
    in_range = live & (idx >= 0) & (idx < size)
    slot = torch.where(in_range, idx, size)  # slot ``size`` is the trash
    counts = torch.zeros((size + 1,), dtype=torch.int32, device=keys.device)
    counts.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    rows = torch.full((size + 1,), -1, dtype=torch.int32, device=keys.device)
    rows.scatter_(0, slot, torch.arange(n, dtype=torch.int32,
                                        device=keys.device))
    return rows[:size], torch.any(counts[:size] > 1)


def build_sorted_with_unique(
    keys: torch.Tensor, live: torch.Tensor
) -> Tuple[BuildTable, torch.Tensor]:
    """Sorted build table + a uniqueness flag computed on the device, so
    the caller fetches one scalar instead of the sorted key array."""
    table = build_lookup(keys, live)
    sk = table.sorted_keys
    pos = torch.arange(1, sk.shape[0], dtype=torch.int32, device=sk.device)
    dup = torch.any((sk[1:] == sk[:-1]) & (pos < table.num_live))
    return table, torch.logical_not(dup)


def probe_unique(
    table: BuildTable, probe_keys: torch.Tensor, probe_live: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe assuming unique build keys (FK->PK join).

    Returns (build_row_indices int32 [Np], matched bool [Np]). Unmatched
    probes get index 0 with matched=False; the caller masks them out
    (inner join) or null-fills (left join).
    """
    probe_keys = probe_keys.to(torch.int64)
    if table.dense_rows is not None:
        size = table.dense_rows.shape[0]
        idx = probe_keys - table.dense_base
        in_range = (idx >= 0) & (idx < size)
        row = _gather(table.dense_rows, idx)
        matched = in_range & (row >= 0) & probe_live
        return torch.where(matched, row, 0), matched
    sk = table.sorted_keys
    idx = torch.searchsorted(sk, probe_keys, right=False)
    idx = idx.clamp(max=sk.shape[0] - 1)
    hit = (sk[idx] == probe_keys) & (probe_keys != INT64_SENTINEL)
    matched = hit & probe_live
    build_rows = torch.where(matched, table.order[idx], 0)
    return build_rows, matched


def probe_semi(
    table: BuildTable, probe_keys: torch.Tensor, probe_live: torch.Tensor
) -> torch.Tensor:
    """Semi-join mask: probe rows whose key exists in the build side."""
    _, matched = probe_unique(table, probe_keys, probe_live)
    return matched


def probe_counts(table: BuildTable, probe_keys: torch.Tensor) -> torch.Tensor:
    """Number of build matches per probe key (for many-to-many planning)."""
    probe_keys = probe_keys.to(torch.int64)
    lo = torch.searchsorted(table.sorted_keys, probe_keys, right=False)
    hi = torch.searchsorted(table.sorted_keys, probe_keys, right=True)
    return (hi - lo).to(torch.int32)


def probe_expand(
    table: BuildTable,
    probe_keys: torch.Tensor,
    probe_live: torch.Tensor,
    out_capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """General inner join with row expansion to a fixed output capacity.

    Returns (probe_row_idx int32 [C], build_row_idx int32 [C], out_live
    [C], total_matches int64 0-d). If total_matches > out_capacity the
    result is truncated; callers detect it by the returned total and
    re-run with a bigger capacity.
    """
    sk = table.sorted_keys
    dev = sk.device
    keyed = torch.where(probe_live, probe_keys.to(torch.int64),
                        INT64_SENTINEL - 1)
    lo = torch.searchsorted(sk, keyed, right=False)
    hi = torch.searchsorted(sk, keyed, right=True)
    counts = torch.where(probe_live, hi - lo, 0)
    ends = torch.cumsum(counts, 0)
    offsets = ends - counts  # exclusive prefix sum
    total = counts.sum()

    c = out_capacity
    out_slot = torch.arange(c, dtype=torch.int64, device=dev)
    # each output slot's probe row: the row whose [offset, offset+count)
    # window contains the slot
    probe_of_slot = torch.searchsorted(ends, out_slot, right=True)
    probe_of_slot = probe_of_slot.clamp(max=probe_keys.shape[0] - 1)
    within = out_slot - offsets[probe_of_slot]
    build_slot = (lo[probe_of_slot] + within).clamp(0, sk.shape[0] - 1)
    out_live = out_slot < torch.clamp(total, max=c)
    build_rows = torch.where(out_live, table.order[build_slot], 0)
    probe_rows = torch.where(out_live, probe_of_slot, 0).to(torch.int32)
    return probe_rows, build_rows, out_live, total
