"""Dense grouped int64 sums: the hand-written CUDA kernel and its plain
torch version.

Counterpart of the JAX package's ``kernels/pallas_agg.py`` together with
the ``segment_min`` beside it in ``_dense_grouped_pallas``: for dense
group ids in ``[0, G)`` it returns the exact, wrapping int64 per-group
sums of K value columns over live rows, the per-group count of live rows,
and each group's first live row (``n`` for a group with none). A row
counts only when it is live and ``0 <= gid < G``.

``dense_grouped_sums`` dispatches on the device of its inputs: tensors on
the CPU go to ``dense_grouped_sums_reference``; tensors on a CUDA device
launch the kernel in ``csrc/dense_grouped_sums.cu`` (built with ``nvcc``
for ``sm_90a`` at first use, see ``native_build.py``) or raise — there is
no fallback. ``launch_count`` counts kernel launches, and only those:
inside a governed program captured as a CUDA graph, the capture itself
launches nothing, and every replay of the graph adds the launches it
holds (``compile.governor.on_replay``). ``observe`` lets a caller see
the inputs and outputs of every executed call, replayed ones included.

The kernel reads each row once and is bound by those bytes. Its launch
plan (``plan_launches``) sets what keeps it there: R lane replicas of the
shared-memory accumulators, so that the lanes of a warp do not contend on
the few words of a small G; 16-byte loads of four rows a thread (VEC = 4)
when every pointer allows them, else the VEC = 1 instantiation of the same
kernel; a persistent grid of as many blocks as fit on the card at once;
and column chunks when the accumulators would not fit one block. The first
rows come from the same pass because it already reads ``gids`` and
``live``: a separate scatter-min read them again and contended on G words.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import torch

from ..compile.governor import capturing, on_replay
from ..errors import ExecutionError

THREADS = 256
VEC = 4  # rows a thread loads per step when the pointers are aligned
MAX_REPLICAS = 32
BLOCKS_PER_SM_WANTED = 2  # replicas shrink until this many blocks fit an SM

# Kernel launches since the count was last reset (chip_smoke.py resets it
# before driving a query and reads it after), replays of captured
# launches included.
launch_count = 0

# Callables that see every executed call of the kernel, eager or replayed:
# fn(gids, live, values, num_groups, sums, counts, first). After a replay
# the tensors are the graph's static buffers, which the next replay
# overwrites: an observer copies what it keeps.
_observers: List[Callable] = []


@contextlib.contextmanager
def observe(fn: Callable):
    """Register ``fn`` as an observer of kernel calls for the ``with``.
    Graphs captured while an observer is registered keep their kernel
    calls' static tensors so that their replays can be observed."""
    _observers.append(fn)
    try:
        yield fn
    finally:
        _observers.remove(fn)

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..native_build import build_dense_grouped_sums

            lib = ctypes.CDLL(build_dense_grouped_sums())
            lib.dense_grouped_sums_launch.restype = ctypes.c_int
            lib.dense_grouped_sums_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p,
            ]
            lib.dense_grouped_sums_blocks_per_sm.restype = ctypes.c_int
            lib.dense_grouped_sums_blocks_per_sm.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
            lib.dense_grouped_sums_max_cols.restype = ctypes.c_int
            lib.dense_grouped_sums_max_cols.argtypes = []
            lib.dense_grouped_sums_max_shared_bytes.restype = ctypes.c_int
            lib.dense_grouped_sums_max_shared_bytes.argtypes = [ctypes.c_int]
            lib.dense_grouped_sums_error_string.restype = ctypes.c_char_p
            lib.dense_grouped_sums_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def build() -> None:
    """Build (if needed) and load the kernel's library."""
    _load()


def dense_grouped_sums(
    gids: torch.Tensor,  # int32 [N]
    live: torch.Tensor,  # bool [N]
    values: Sequence[torch.Tensor],  # K x int64 [N]
    num_groups: int,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Returns (sums: K x int64 [G], counts: int64 [G], first: int64 [G]),
    where ``first`` is each group's least live row index, or N when it has
    none. Callers wanting validity-masked counts pass the mask as a 0/1
    value column."""
    if gids.device.type == "cpu":
        return dense_grouped_sums_reference(gids, live, values, num_groups)
    if gids.device.type != "cuda":
        raise ExecutionError(
            f"dense_grouped_sums: no kernel for device {gids.device}")
    return _launch(gids, live, list(values), num_groups)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, n: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ExecutionError(f"{name} is on {t.device}, gids on {device}")
    if t.dtype != dtype:
        raise ExecutionError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ExecutionError(f"{name} has shape {tuple(t.shape)}, expected ({n},)")
    if not t.is_contiguous():
        raise ExecutionError(f"{name} is not contiguous")


@dataclass(frozen=True)
class Launch:
    """One kernel launch: value columns ``[lo, hi)``, whether it finds the
    first rows, its lane replicas and its grid."""

    lo: int
    hi: int
    first: bool
    replicas: int
    blocks: int


@dataclass(frozen=True)
class LaunchPlan:
    vec: int  # 4: int4/longlong2 loads of four rows; 1: one row a step
    launches: Tuple[Launch, ...]


def _columns_per_launch(lib, device: int, k: int, num_groups: int) -> int:
    """Value columns one launch takes: at most the kernel's limit, and few
    enough that one replica of the [G, cols+2] int64 accumulators (sums,
    count and first row) fits the shared memory a block may opt into."""
    shared = lib.dense_grouped_sums_max_shared_bytes(device)
    fit = shared // (8 * num_groups) - 2
    if fit < 1 and (k > 0 or fit < 0):
        raise ExecutionError(
            f"dense_grouped_sums: the accumulators of {num_groups} groups do "
            f"not fit one block's {shared} B of shared memory")
    return max(1, min(lib.dense_grouped_sums_max_cols(), fit))


def _blocks_per_sm(lib, vec: int, nbytes: int) -> int:
    """Blocks of the ``vec`` instantiation with ``nbytes`` of shared memory
    that fit one SM of the current device at once."""
    occ = lib.dense_grouped_sums_blocks_per_sm(vec, THREADS, nbytes)
    if occ < 0:
        raise ExecutionError(
            f"dense_grouped_sums: occupancy query failed: CUDA error {-occ}")
    return occ


@functools.lru_cache(maxsize=256)
def _replicas(lib, device: int, vec: int, words: int,
              limit: int) -> Tuple[int, int]:
    """(replicas, blocks per SM): the most replicas of ``words`` int64
    accumulators that still let ``BLOCKS_PER_SM_WANTED`` blocks share an
    SM, else the most that fit at all. Cached: the occupancy queries cost
    more host time than a small launch."""
    best = None
    r = MAX_REPLICAS
    while r >= 1:
        nbytes = words * r * 8
        if nbytes <= limit:
            occ = _blocks_per_sm(lib, vec, nbytes)
            if occ >= BLOCKS_PER_SM_WANTED:
                return r, occ
            if occ >= 1 and best is None:
                best = (r, occ)
        r //= 2
    if best is None:
        raise ExecutionError(
            f"dense_grouped_sums: {words} accumulator words fit no block")
    return best


def plan_launches(lib, device: int, sms: int, n: int, num_groups: int,
                  gids_ptr: int, live_ptr: int,
                  value_ptrs: Sequence[int]) -> LaunchPlan:
    """The launches that compute ``dense_grouped_sums`` for N rows of the
    given device addresses on a card with ``sms`` SMs: VEC = 4 when gids
    and every value column are 16-byte aligned and live 4-byte aligned,
    else 1; the columns in chunks whose accumulators fit a block; for each
    chunk the replicas and a persistent grid sized by occupancy. Only the
    first launch finds the first rows."""
    aligned = (gids_ptr % 16 == 0 and live_ptr % 4 == 0
               and all(p % 16 == 0 for p in value_ptrs))
    return _plan(lib, device, sms, n, num_groups, len(value_ptrs),
                 VEC if aligned else 1)


@functools.lru_cache(maxsize=1024)
def _plan(lib, device: int, sms: int, n: int, num_groups: int, k: int,
          vec: int) -> LaunchPlan:
    if num_groups <= 0:
        raise ExecutionError(f"num_groups must be positive, got {num_groups}")
    per = _columns_per_launch(lib, device, k, num_groups)
    limit = lib.dense_grouped_sums_max_shared_bytes(device)
    rows_per_block = THREADS * vec
    launches = []
    for lo in range(0, max(k, 1), per):
        hi = min(lo + per, k)
        first = lo == 0
        words = num_groups * (hi - lo + 1 + int(first))
        r, occ = _replicas(lib, device, vec, words, limit)
        blocks = max(1, min(sms * occ, -(-n // rows_per_block)))
        launches.append(Launch(lo, hi, first, r, blocks))
    return LaunchPlan(vec, tuple(launches))


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_on_current_device(gids, live, values, num_groups) -> LaunchPlan:
    index = gids.device.index
    return plan_launches(_load(), index, _sm_count(index),
                         int(gids.shape[0]), num_groups, gids.data_ptr(),
                         live.data_ptr(), [v.data_ptr() for v in values])


def launch_plan(gids: torch.Tensor, live: torch.Tensor,
                values: Sequence[torch.Tensor],
                num_groups: int) -> LaunchPlan:
    """``plan_launches`` for these CUDA tensors on their card."""
    with torch.cuda.device(gids.device):
        return _plan_on_current_device(gids, live, values, num_groups)


def _launch(gids: torch.Tensor, live: torch.Tensor,
            values: List[torch.Tensor], num_groups: int):
    """The plan's launches (one for every input of the main path); the
    counts and first rows come from the first launch."""
    global launch_count
    dev = gids.device
    n = int(gids.shape[0])
    _check("gids", gids, torch.int32, n, dev)
    _check("live", live, torch.bool, n, dev)
    for j, v in enumerate(values):
        _check(f"values[{j}]", v, torch.int64, n, dev)
    with torch.cuda.device(dev):
        plan = _plan_on_current_device(gids, live, values, num_groups)
        outs = [torch.zeros((num_groups, spec.hi - spec.lo + 1),
                            dtype=torch.int64, device=dev)
                for spec in plan.launches]
        first = torch.full((num_groups,), n, dtype=torch.int64, device=dev)
        if n > 0:
            lib = _load()
            stream = torch.cuda.current_stream(dev).cuda_stream
            for spec, out in zip(plan.launches, outs):
                cols = values[spec.lo:spec.hi]
                ptrs = (ctypes.c_void_p * max(len(cols), 1))(
                    *[v.data_ptr() for v in cols])
                err = lib.dense_grouped_sums_launch(
                    gids.data_ptr(), live.data_ptr(), ptrs, n, len(cols),
                    num_groups, spec.replicas, plan.vec, out.data_ptr(),
                    first.data_ptr() if spec.first else None, spec.blocks,
                    THREADS, stream)
                if err != 0:
                    what = lib.dense_grouped_sums_error_string(err).decode()
                    raise ExecutionError(
                        f"dense_grouped_sums kernel launch failed: "
                        f"CUDA error {err} ({what})")
    sums = [out[:, j] for spec, out in zip(plan.launches, outs)
            for j in range(spec.hi - spec.lo)]
    counts = outs[0][:, -1]
    n_launches = len(plan.launches) if n > 0 else 0
    if capturing():
        # recorded into a graph, not launched: count (and show) each replay
        held = ((gids, live, values, num_groups, sums, counts, first)
                if _observers else None)

        def replayed():
            global launch_count
            launch_count += n_launches
            if held is not None:
                for fn in list(_observers):
                    fn(*held)

        on_replay(replayed)
    else:
        launch_count += n_launches
        for fn in list(_observers):
            fn(gids, live, values, num_groups, sums, counts, first)
    return sums, counts, first


def dense_grouped_sums_reference(
    gids: torch.Tensor,
    live: torch.Tensor,
    values: Sequence[torch.Tensor],
    num_groups: int,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Plain torch version of the same function: one ``index_add_`` of the
    [N, K+1] value matrix (K values and a ones column) into G+1 rows, and
    one ``scatter_reduce_`` of the live row indices (N for dead rows) into
    G+1 slots, where slot G is the trash slot of dead and out-of-range
    rows, sliced off afterwards. Integer addition wraps mod 2^64 on every
    device."""
    g = int(num_groups)
    k = len(values)
    n = int(gids.shape[0])
    dev = gids.device
    ok = live & (gids >= 0) & (gids < g)
    slot = torch.where(ok, gids.to(torch.int64), g)
    ones = torch.ones(n, dtype=torch.int64, device=dev)
    cols = torch.stack([v.to(torch.int64) for v in values] + [ones], dim=1)
    acc = torch.zeros((g + 1, k + 1), dtype=torch.int64, device=dev)
    acc.index_add_(0, slot, cols)
    pos = torch.where(ok, torch.arange(n, dtype=torch.int64, device=dev), n)
    first = torch.full((g + 1,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, slot, pos, reduce="amin")
    return [acc[:g, j] for j in range(k)], acc[:g, k], first[:g]
