"""Hash kernels for repartitioning.

The port of the JAX package's ``kernels/hashing.py``: a splitmix64
finalizer over int64 keys, and partition ids as the hash modulo P.

The JAX package computes in uint64. torch has no uint64 ``+``, ``>>`` or
``%`` on the CPU, and its CUDA support for them is partial, so the hash is
written once in int64 ops that give the same bits on every device:

- add and multiply wrap modulo 2^64 in two's complement, exactly as the
  unsigned ops do;
- a logical right shift is the arithmetic shift with the sign-extended
  bits masked off: ``(x >> k) & (2^(64-k) - 1)``;
- the unsigned modulo by P splits the hash into its 32-bit halves:
  ``(hi mod P) * (2^32 mod P) + lo mod P``, every term below 2^62 for
  P < 2^31.

The partition ids equal the JAX package's bit for bit: they decide where
a row lands.
"""

from __future__ import annotations

import torch

_MASK32 = (1 << 32) - 1


def _signed(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer; int64 in, the uint64 hash's bits as int64 out."""
    z = x.to(torch.int64) + _GOLDEN
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def unsigned_mod(h: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """``h`` read as uint64, modulo ``num_partitions`` (< 2^31); int32."""
    p = int(num_partitions)
    if not 0 < p < 1 << 31:
        raise ValueError(f"num_partitions {p} outside [1, 2^31)")
    hi = _shr(h, 32)
    lo = h & _MASK32
    r = (hi % p) * ((1 << 32) % p) + lo % p
    return (r % p).to(torch.int32)


def hash_partition_ids(keys: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """int64 keys -> int32 partition ids in [0, num_partitions)."""
    return unsigned_mod(splitmix64(keys), num_partitions)
