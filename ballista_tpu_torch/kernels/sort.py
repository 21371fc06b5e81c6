"""Multi-key sort kernel.

The port of the JAX package's ``kernels/sort.py``. torch has no
multi-operand lexicographic sort like ``lax.sort``, so the permutation is
built from stable argsorts chained from the MINOR key to the MAJOR key
(each pass keeps the order of the previous one among equal keys), with
the dead flag as the most major key so dead rows sink to the end.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def sort_permutation(
    keys: Sequence[Tuple[torch.Tensor, bool]],  # (values, ascending), major key first
    live: torch.Tensor,
) -> torch.Tensor:
    """Return the int32 permutation ordering live rows by keys, dead rows
    last; ties keep their input order (stable)."""
    n = live.shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=live.device)
    ops = [_orderable(torch.broadcast_to(v, (n,)), asc) for v, asc in keys]
    for k in reversed([torch.logical_not(live).to(torch.int32)] + ops):
        order = torch.argsort(k[perm], stable=True)
        perm = perm[order]
    return perm.to(torch.int32)


def _orderable(v: torch.Tensor, ascending: bool) -> torch.Tensor:
    if v.dtype == torch.bool:
        v = v.to(torch.int32)
    if v.dtype.is_floating_point:
        return v if ascending else -v
    if ascending:
        return v
    # descending integers: flip via bitwise-not to avoid negation overflow
    return torch.bitwise_not(v)
