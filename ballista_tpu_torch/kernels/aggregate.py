"""Grouped and ungrouped aggregation.

The port of the JAX package's ``kernels/aggregate.py``: the sort-based
``grouped_aggregate``, the dense paths (``dense_grouped_aggregate`` for
small known cardinalities, ``dense_grouped_scatter`` for ranged integer
keys), ``scalar_aggregate`` and ``avg_fixed``. ``grouped_distinct_count``
is not ported yet (only stage fusion creates its caller). SQL semantics
carried through:

- NULL group keys form their own group (each key column contributes its
  validity as an implicit sort/boundary key);
- NULL inputs are excluded from aggregates, and each aggregate reports a
  per-group validity ("any non-NULL input seen"), so all-NULL groups yield
  NULL rather than the reduction identity;
- sums over decimals stay in int64, so results are exact.

Where JAX drops out-of-range scatter indices, torch raises (on CUDA it
asserts), so every scatter here sends dead rows to an explicit trash slot
``G`` that is sliced off afterwards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..errors import ExecutionError
from .dense_sums import dense_grouped_sums


@dataclass
class AggInput:
    """One aggregate to compute: op in {sum, count, min, max}."""

    op: str
    values: Optional[torch.Tensor]  # None for count(*)
    validity: Optional[torch.Tensor]  # None = all valid


@dataclass
class GroupedResult:
    rep_indices: torch.Tensor  # int32 [G] original row index of each group's first row
    group_valid: torch.Tensor  # bool [G]
    num_groups: torch.Tensor  # int32 0-d (groups present)
    aggregates: List[torch.Tensor]  # each [G]
    agg_valid: List[torch.Tensor]  # bool [G] per aggregate ("any input seen")


def _max_ident(dt: torch.dtype):
    if dt.is_floating_point:
        return float("inf")
    return torch.iinfo(dt).max


def _min_ident(dt: torch.dtype):
    if dt.is_floating_point:
        return float("-inf")
    return torch.iinfo(dt).min


def _is_integer(t: torch.Tensor) -> bool:
    return not t.dtype.is_floating_point and t.dtype != torch.bool


# ---------------------------------------------------------------------------
# Sort-based grouping
# ---------------------------------------------------------------------------


def _run_boundaries(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """bool [N]: row i starts a new run of the (sorted) key columns —
    ANY column differs from its predecessor (row 0 always starts one)."""
    first = None
    for ks in cols:
        diff = torch.cat([torch.ones((1,), dtype=torch.bool,
                                     device=ks.device), ks[1:] != ks[:-1]])
        first = diff if first is None else first | diff
    return first


def _lexsort(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 permutation ordering rows lexicographically by ``cols``
    (major first), ties in row order: torch has no multi-operand
    ``lax.sort``, so stable argsorts chain from the minor column to the
    major one."""
    perm = torch.arange(cols[0].shape[0], dtype=torch.int64,
                        device=cols[0].device)
    for k in reversed(cols):
        if k.dtype == torch.bool:
            k = k.to(torch.int32)
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def _segment(op: str, values: torch.Tensor, seg: torch.Tensor, g: int,
             init) -> torch.Tensor:
    """One reduction of ``values`` into ``g + 1`` segments (the last is
    the trash of dead and overflowing rows), trash sliced off."""
    out = torch.full((g + 1,), init, dtype=values.dtype, device=values.device)
    if op == "sum":
        out.index_add_(0, seg, values)
    else:
        out.scatter_reduce_(0, seg, values, reduce=op)
    return out[:g]


def grouped_aggregate(
    keys: Sequence[torch.Tensor],  # one or more [N] key columns (ints/codes)
    live: torch.Tensor,  # bool [N] live-row mask
    aggs: Sequence[AggInput],
    group_capacity: int,
    key_validities: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> GroupedResult:
    """Sort-based grouping: rows ordered by [dead, keys...] (stable), run
    boundaries give dense group ids, one segment reduction per aggregate.
    Groups come out in key order, as in the JAX package; ``num_groups``
    is the TRUE count (it may exceed ``group_capacity``: the caller
    retries larger)."""
    keys = list(keys)
    if not keys:
        raise ExecutionError("grouped_aggregate requires at least one key")
    if key_validities is None:
        key_validities = [None] * len(keys)
    # NULL keys group together: each nullable key contributes (validity,
    # value-or-0) as the effective sort/boundary pair
    eff_keys: List[torch.Tensor] = []
    for k, kv in zip(keys, key_validities):
        if kv is not None:
            eff_keys.append(kv.to(torch.int32))
            eff_keys.append(torch.where(kv, k, torch.zeros((), dtype=k.dtype,
                                                           device=k.device)))
        else:
            eff_keys.append(k)

    n = live.shape[0]
    dev = live.device
    dead = torch.logical_not(live)
    presorted = False
    if len(eff_keys) == 1:
        # PRESORTED fast path: a group-by over a clustered key (q18's
        # l_orderkey, in file order) skips the sort when the key is
        # non-decreasing over a contiguous live prefix — one scalar read
        k0 = eff_keys[0]
        live_prefix = torch.all(live[1:] <= live[:-1])
        nondecreasing = torch.all((k0[1:] >= k0[:-1]) | ~live[1:])
        presorted = bool(live_prefix & nondecreasing)
    if presorted:
        order = torch.arange(n, dtype=torch.int64, device=dev)
        sorted_keys = [eff_keys[0]]
        live_sorted = live
    else:
        order = _lexsort([dead] + eff_keys)
        sorted_keys = [k[order] for k in eff_keys]
        live_sorted = live[order]

    # a row starts a new group if live and ANY key differs from predecessor
    starts = _run_boundaries(sorted_keys) & live_sorted
    gid = torch.cumsum(starts.to(torch.int64), 0) - 1  # [-1..G-1]
    num_groups = starts.sum(dtype=torch.int32)
    g = group_capacity
    # dead rows / overflow go to the trash segment g
    seg = torch.where(live_sorted, gid.clamp(max=g), g)

    # representative original-row index per group (first member in order)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    first_pos = _segment("amin", torch.where(live_sorted, pos, n), seg, g, n)
    rep_indices = order[first_pos.clamp(max=n - 1)].to(torch.int32)
    group_valid = torch.arange(g, dtype=torch.int32, device=dev) < num_groups

    results: List[torch.Tensor] = []
    valid_results: List[torch.Tensor] = []
    for a in aggs:
        valid = a.validity[order] if a.validity is not None else None
        if a.op == "count":
            v = (torch.ones((n,), dtype=torch.int64, device=dev)
                 if valid is None else valid.to(torch.int64))
            r = _segment("sum", v, seg, g, 0)
            va = group_valid
        else:
            if a.values is None:
                raise ExecutionError(f"{a.op} requires input values")
            v = torch.broadcast_to(a.values, (n,))[order]
            if a.op == "sum":
                if valid is not None:
                    v = torch.where(valid, v, 0)
                r = _segment("sum", v, seg, g, 0)
            elif a.op == "min":
                if valid is not None:
                    v = torch.where(valid, v, _max_ident(v.dtype))
                r = _segment("amin", v, seg, g, _max_ident(v.dtype))
            elif a.op == "max":
                if valid is not None:
                    v = torch.where(valid, v, _min_ident(v.dtype))
                r = _segment("amax", v, seg, g, _min_ident(v.dtype))
            else:
                raise ExecutionError(f"unknown aggregate op {a.op}")
            if valid is not None:
                seen = _segment("amax", valid.to(torch.int32), seg, g, 0)
                va = group_valid & (seen > 0)
            else:
                va = group_valid
        results.append(torch.where(va, r, 0))
        valid_results.append(va)

    return GroupedResult(rep_indices, group_valid, num_groups, results,
                         valid_results)


# ---------------------------------------------------------------------------
# Dense grouping: group ids already small dense ints (dictionary codes /
# booleans with known cardinality). No sort.
# ---------------------------------------------------------------------------


def _additive(a: AggInput) -> bool:
    """True for aggregates the dense-sums kernel computes (integer sums
    and counts, validity-masked or not); min/max and float sums stay on
    the plain torch path (split per aggregate)."""
    if a.op == "count":
        return True
    return a.op == "sum" and a.values is not None and _is_integer(a.values)


def dense_grouped_aggregate(
    gids: torch.Tensor,  # int32 [N] in [0, num_groups)
    live: torch.Tensor,  # bool [N]
    aggs: Sequence[AggInput],
    num_groups: int,
) -> GroupedResult:
    """The additive aggregates go through ``dense_grouped_sums`` whenever
    at least one of them is a sum — the CUDA kernel for tensors on a card,
    its plain version for tensors on the CPU — split from the rest exactly
    as the JAX package splits its Pallas path (there the kernel is opt-in;
    here it is the only path on a card)."""
    additive = [a for a in aggs if _additive(a)]
    rest = [a for a in aggs if not _additive(a)]
    if not any(a.op == "sum" for a in additive):
        return _dense_grouped_torch(gids, live, aggs, num_groups)
    res_k = _dense_grouped_sums(gids, live, additive, num_groups)
    if not rest:
        return res_k
    res_t = _dense_grouped_torch(gids, live, rest, num_groups)
    results, valids = [], []
    ik = it = 0
    for a in aggs:
        if _additive(a):
            results.append(res_k.aggregates[ik])
            valids.append(res_k.agg_valid[ik])
            ik += 1
        else:
            results.append(res_t.aggregates[it])
            valids.append(res_t.agg_valid[it])
            it += 1
    return GroupedResult(res_k.rep_indices, res_k.group_valid,
                         res_k.num_groups, results, valids)


def _dense_grouped_torch(
    gids: torch.Tensor,
    live: torch.Tensor,
    aggs: Sequence[AggInput],
    num_groups: int,
) -> GroupedResult:
    """Counterpart of the JAX ``_dense_grouped_xla``. JAX reduces an
    [N, G] membership mask that XLA never materializes; torch would, so
    this scatters each row into its group slot instead (slot G is the
    trash of dead rows). Same results: ``rep_indices`` is the first live
    row of each group and 0 for an empty group (``argmax`` of an all-False
    column)."""
    n = gids.shape[0]
    g = num_groups
    dev = gids.device
    member = live & (gids >= 0) & (gids < g)
    slot = torch.where(member, gids.to(torch.int64), g)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    first = torch.full((g + 1,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, slot, pos, reduce="amin")
    group_valid = first[:g] < n
    rep_indices = torch.where(group_valid, first[:g], 0).to(torch.int32)
    num_present = group_valid.sum(dtype=torch.int32)

    results: List[torch.Tensor] = []
    valid_results: List[torch.Tensor] = []
    for a in aggs:
        s = slot if a.validity is None else torch.where(a.validity, slot, g)
        seen = torch.zeros((g + 1,), dtype=torch.int64, device=dev)
        seen.index_add_(0, s, torch.ones(n, dtype=torch.int64, device=dev))
        if a.op == "count":
            r = seen[:g]
            va = group_valid
        else:
            if a.values is None:
                raise ExecutionError(f"{a.op} requires input values")
            v = torch.broadcast_to(a.values, (n,))
            if a.op == "sum":
                r = torch.zeros((g + 1,), dtype=v.dtype, device=dev)
                r.index_add_(0, s, v)
            elif a.op == "min":
                r = torch.full((g + 1,), _max_ident(v.dtype), dtype=v.dtype,
                               device=dev)
                r.scatter_reduce_(0, s, v, reduce="amin")
            elif a.op == "max":
                r = torch.full((g + 1,), _min_ident(v.dtype), dtype=v.dtype,
                               device=dev)
                r.scatter_reduce_(0, s, v, reduce="amax")
            else:
                raise ExecutionError(f"unknown aggregate op {a.op}")
            r = r[:g]
            va = seen[:g] > 0
        results.append(torch.where(va, r, torch.zeros((), dtype=r.dtype,
                                                      device=dev)))
        valid_results.append(va)

    return GroupedResult(rep_indices, group_valid, num_present, results,
                         valid_results)


def dense_grouped_scatter(
    gids: torch.Tensor,  # int32 [N] in [0, num_groups)
    live: torch.Tensor,  # bool [N]
    aggs: Sequence[AggInput],
    num_groups: int,
) -> GroupedResult:
    """O(N) scatter-based dense grouping for group counts where the
    membership product is prohibitive (ranged-integer keys: thousands to
    millions of groups). Same semantics: non-compact groups,
    ``group_valid`` marks occupancy, per-aggregate validity is "any
    non-NULL input seen". Rows JAX would drop (dead, or a gid outside
    [0, G)) go to the trash slot G."""
    n = gids.shape[0]
    g = num_groups
    dev = gids.device
    slot = torch.where(live & (gids >= 0) & (gids < g), gids.to(torch.int64),
                       g)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    first = _segment("amin", rows, slot, g, n)
    group_valid = first < n
    rep_indices = first.clamp(max=n - 1).to(torch.int32)
    num_present = group_valid.sum(dtype=torch.int32)

    results: List[torch.Tensor] = []
    valid_results: List[torch.Tensor] = []
    for a in aggs:
        valid = a.validity
        if a.op == "count":
            v = (torch.ones((n,), dtype=torch.int64, device=dev)
                 if valid is None else valid.to(torch.int64))
            r = _segment("sum", v, slot, g, 0)
            va = group_valid
        else:
            if a.values is None:
                raise ExecutionError(f"{a.op} requires input values")
            v = torch.broadcast_to(a.values, (n,))
            if a.op == "sum":
                if valid is not None:
                    v = torch.where(valid, v, 0)
                r = _segment("sum", v, slot, g, 0)
            elif a.op == "min":
                if valid is not None:
                    v = torch.where(valid, v, _max_ident(v.dtype))
                r = _segment("amin", v, slot, g, _max_ident(v.dtype))
            elif a.op == "max":
                if valid is not None:
                    v = torch.where(valid, v, _min_ident(v.dtype))
                r = _segment("amax", v, slot, g, _min_ident(v.dtype))
            else:
                raise ExecutionError(f"unknown aggregate op {a.op}")
            if valid is not None:
                seen = _segment("amax", valid.to(torch.int32), slot, g, 0)
                va = group_valid & (seen > 0)
            else:
                va = group_valid
        results.append(torch.where(va, r, 0))
        valid_results.append(va)

    return GroupedResult(rep_indices, group_valid, num_present, results,
                         valid_results)


def _dense_grouped_sums(gids, live, aggs, num_groups) -> GroupedResult:
    """Integer sums/counts and representatives (each group's first live
    row) through ``dense_grouped_sums``, in one pass. Counterpart of the
    JAX ``_dense_grouped_pallas``.

    Validity handling happens BEFORE the kernel: masked-out sum inputs
    are zeroed (sum semantics), and each validity-masked aggregate gets
    one extra 0/1 value column whose per-group sum is its valid-input
    count — so the kernel only ever sums, and per-aggregate NULL
    semantics (all-NULL group -> NULL) survive exactly."""
    values: List[torch.Tensor] = []
    # per agg: ("count", None) | ("countv", vcol) | ("sum", col, vcol|None)
    plan = []
    vmask_col: dict = {}  # id(validity) -> value-column index of its mask

    def mask_col(validity) -> int:
        key = id(validity)
        if key not in vmask_col:
            vmask_col[key] = len(values)
            values.append(validity.to(torch.int64).contiguous())
        return vmask_col[key]

    n = gids.shape[0]
    for a in aggs:
        if a.op == "count":
            if a.validity is None:
                plan.append(("count", None, None))
            else:
                plan.append(("countv", mask_col(a.validity), None))
        else:  # integer sum
            v = torch.broadcast_to(a.values.to(torch.int64), (n,))
            vcol = None
            if a.validity is not None:
                v = torch.where(a.validity, v, 0)
                vcol = mask_col(a.validity)  # may append; BEFORE len()
            plan.append(("sum", len(values), vcol))
            values.append(v.contiguous())

    sums, counts, first = dense_grouped_sums(
        gids.to(torch.int32).contiguous(), live.contiguous(), values,
        num_groups)
    # first is the JAX package's segment_min with N for a group without a
    # live row; such a group gets n - 1, as in the JAX package
    rep_indices = torch.clamp(first, max=max(n - 1, 0)).to(torch.int32)
    group_valid = counts > 0
    num_present = group_valid.sum(dtype=torch.int32)
    results: List[torch.Tensor] = []
    valid_results: List[torch.Tensor] = []
    for a, (kind, col, vcol) in zip(aggs, plan):
        if kind == "count":
            results.append(counts)
            valid_results.append(group_valid)
        elif kind == "countv":
            results.append(sums[col])
            valid_results.append(group_valid)
        else:
            va = group_valid if vcol is None else (sums[vcol] > 0)
            out = sums[col].to(a.values.dtype)
            results.append(torch.where(va, out, 0))
            valid_results.append(va)
    return GroupedResult(rep_indices, group_valid, num_present, results,
                         valid_results)


# ---------------------------------------------------------------------------
# Ungrouped aggregation (whole-batch reductions)
# ---------------------------------------------------------------------------


def scalar_aggregate(
    live: torch.Tensor, aggs: Sequence[AggInput]
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Returns (values, validities) as 0-d tensors — validity False when
    no valid input."""
    out: List[torch.Tensor] = []
    valid_out: List[torch.Tensor] = []
    dev = live.device
    for a in aggs:
        valid = live
        if a.validity is not None:
            valid = torch.logical_and(valid, a.validity)
        any_valid = torch.any(valid)
        if a.op == "count":
            out.append(valid.sum(dtype=torch.int64))
            valid_out.append(torch.ones((), dtype=torch.bool, device=dev))
            continue
        v = torch.broadcast_to(a.values, live.shape)
        if a.op == "sum":
            r = torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                                  device=dev)).sum(dtype=v.dtype)
        elif a.op == "min":
            r = torch.where(valid, v, _max_ident(v.dtype)).min()
        elif a.op == "max":
            r = torch.where(valid, v, _min_ident(v.dtype)).max()
        else:
            raise ExecutionError(f"unknown aggregate op {a.op}")
        out.append(torch.where(any_valid, r, torch.zeros((), dtype=r.dtype,
                                                         device=dev)))
        valid_out.append(any_valid)
    return out, valid_out


# ---------------------------------------------------------------------------
# Exact fixed-point average: sum/count scaled to 10^6 without overflowing
# ---------------------------------------------------------------------------


def avg_fixed(sum_: torch.Tensor, count: torch.Tensor,
              in_scale: int) -> torch.Tensor:
    """(sum / count) scaled to Decimal(6), overflow-safe.

    Splits the division: A = q*M + (r*M)/count with q=sum/count,
    r=sum%count, M=10^(6-in_scale) — r*M stays < count*M so the only
    overflow left is a logical |avg| >= ~9.2e12, documented out of range.
    Every division TRUNCATES toward zero, like ``lax.div``/``lax.rem`` in
    the JAX package; ``//`` and ``%`` would floor and differ on negative
    sums."""
    s = sum_.to(torch.int64)
    if in_scale > 6:
        s = torch.div(s, 10 ** (in_scale - 6), rounding_mode="trunc")
        in_scale = 6
    m = 10 ** (6 - in_scale)
    c = torch.clamp(count.to(torch.int64), min=1)
    q = torch.div(s, c, rounding_mode="trunc")
    r = torch.fmod(s, c)
    return q * m + torch.div(r * m, c, rounding_mode="trunc")
