"""Dense grouped int64 sums: the hand-written CUDA kernel and its plain
torch version.

Counterpart of the JAX package's ``kernels/pallas_agg.py``: for dense
group ids in ``[0, G)`` it returns the exact, wrapping int64 per-group sums
of K value columns over live rows, plus the per-group count of live rows.
A row counts only when it is live and ``0 <= gid < G``.

``dense_grouped_sums`` dispatches on the device of its inputs: tensors on
the CPU go to ``dense_grouped_sums_reference``; tensors on a CUDA device
launch the kernel in ``csrc/dense_grouped_sums.cu`` (built with ``nvcc``
for ``sm_90a`` at first use, see ``native_build.py``) or raise — there is
no fallback. ``launch_count`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

import torch

from ..errors import ExecutionError

THREADS = 256
BLOCKS_PER_SM = 8

# Kernel launches since the count was last reset (chip_smoke.py resets it
# before driving a query and reads it after).
launch_count = 0

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
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.dense_grouped_sums_max_cols.restype = ctypes.c_int
            lib.dense_grouped_sums_max_cols.argtypes = []
            lib.dense_grouped_sums_max_shared_bytes.restype = ctypes.c_int
            lib.dense_grouped_sums_max_shared_bytes.argtypes = [ctypes.c_int]
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
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Returns (sums: K x int64 [G], counts: int64 [G]). Callers wanting
    validity-masked counts pass the mask as a 0/1 value column."""
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


def _columns_per_launch(lib, dev: torch.device, k: int,
                        num_groups: int) -> int:
    """Value columns one launch takes: at most the kernel's limit, and few
    enough that the [G, cols+1] int64 accumulators fit the shared memory a
    block may opt into."""
    shared = lib.dense_grouped_sums_max_shared_bytes(dev.index)
    fit = shared // (8 * num_groups) - 1
    if k > 0 and fit < 1:
        raise ExecutionError(
            f"dense_grouped_sums: the accumulators of {num_groups} groups do "
            f"not fit one block's {shared} B of shared memory")
    return max(1, min(lib.dense_grouped_sums_max_cols(), fit))


def _launch(gids: torch.Tensor, live: torch.Tensor,
            values: List[torch.Tensor], num_groups: int):
    """One kernel launch per chunk of value columns (one for every input
    of the main path); the counts come from the first launch."""
    global launch_count
    lib = _load()
    dev = gids.device
    n = int(gids.shape[0])
    k = len(values)
    _check("gids", gids, torch.int32, n, dev)
    _check("live", live, torch.bool, n, dev)
    for j, v in enumerate(values):
        _check(f"values[{j}]", v, torch.int64, n, dev)
    if num_groups <= 0:
        raise ExecutionError(f"num_groups must be positive, got {num_groups}")
    per = _columns_per_launch(lib, dev, k, num_groups)
    chunks = [values[i:i + per] for i in range(0, k, per)] or [[]]
    outs = [torch.zeros((num_groups, len(c) + 1), dtype=torch.int64,
                        device=dev) for c in chunks]
    if n > 0:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = max(1, min(-(-n // THREADS), sms * BLOCKS_PER_SM))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for cols, out in zip(chunks, outs):
                ptrs = (ctypes.c_void_p * max(len(cols), 1))(
                    *[v.data_ptr() for v in cols])
                err = lib.dense_grouped_sums_launch(
                    gids.data_ptr(), live.data_ptr(), ptrs, n, len(cols),
                    num_groups, out.data_ptr(), blocks, THREADS, stream)
                if err != 0:
                    raise ExecutionError(
                        f"dense_grouped_sums kernel launch failed: "
                        f"CUDA error {err}")
                launch_count += 1
    sums = [out[:, j] for cols, out in zip(chunks, outs)
            for j in range(len(cols))]
    return sums, outs[0][:, -1]


def dense_grouped_sums_reference(
    gids: torch.Tensor,
    live: torch.Tensor,
    values: Sequence[torch.Tensor],
    num_groups: int,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain torch version of the same function: one ``index_add_`` of the
    [N, K+1] value matrix (K values and a ones column) into G+1 rows,
    where row G is the trash slot of dead and out-of-range rows, sliced
    off afterwards. Integer addition wraps mod 2^64 on every device."""
    g = int(num_groups)
    k = len(values)
    ok = live & (gids >= 0) & (gids < g)
    slot = torch.where(ok, gids.to(torch.int64), g)
    ones = torch.ones(gids.shape[0], dtype=torch.int64, device=gids.device)
    cols = torch.stack([v.to(torch.int64) for v in values] + [ones], dim=1)
    acc = torch.zeros((g + 1, k + 1), dtype=torch.int64, device=gids.device)
    acc.index_add_(0, slot, cols)
    return [acc[:g, j] for j in range(k)], acc[:g, k]
