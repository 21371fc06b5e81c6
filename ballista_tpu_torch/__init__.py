"""ballista-tpu's PyTorch/CUDA port: the same SQL/DataFrame surface, plans
and results as the JAX package ``ballista_tpu``, on torch tensors on one
explicit device (an NVIDIA H100 by default, or the CPU when asked).

The JAX package is the reference: every module here keeps the name and
place of its counterpart there, and the tests hold each against it. This
package imports torch and never jax, and nothing of ``ballista_tpu``.
"""

import os as _os
import sys as _sys

# pyarrow >= 25 defaults its memory pool to mimalloc, which intermittently
# corrupts under this engine's thread mix (executor thread pools + grpc +
# GIL-released ctypes scans): observed as flaky SIGSEGV inside pa.array
# during shuffle writes, reproducibly gone under jemalloc or the system
# allocator. Pin jemalloc BEFORE pyarrow's first import (the env var is
# only read then); if the application imported pyarrow already, flip the
# default pool at runtime instead. An explicit ARROW_DEFAULT_MEMORY_POOL
# from the user always wins. (Copied from the JAX package's __init__;
# io/ipc.py's ``_arrow`` checks the pool at first use.)
if "ARROW_DEFAULT_MEMORY_POOL" not in _os.environ:
    if "pyarrow" in _sys.modules:
        try:
            import pyarrow as _pa

            _pa.set_memory_pool(_pa.jemalloc_memory_pool())
        except Exception:  # noqa: BLE001 - jemalloc absent in this build
            pass
    else:
        _os.environ["ARROW_DEFAULT_MEMORY_POOL"] = "jemalloc"
        # mark the choice as OURS by recording the VALUE we set:
        # io/ipc.py's runtime fallback must not override a pool the USER
        # explicitly selected, and child processes inherit this marker —
        # so it only counts as ours while ARROW_DEFAULT_MEMORY_POOL still
        # equals what we wrote (a user override in the child wins)
        _os.environ["_BALLISTA_SET_ARROW_POOL"] = "jemalloc"

BALLISTA_TPU_VERSION = "0.2.0"

from .datatypes import (  # noqa: E402
    Boolean,
    DataType,
    Date32,
    Decimal,
    Field,
    Float32,
    Float64,
    Int32,
    Int64,
    Schema,
    Utf8,
    schema,
)
from .columnar import Column, ColumnBatch, Dictionary  # noqa: E402
from .expr import (  # noqa: E402
    avg,
    case,
    col,
    count,
    count_distinct,
    date_lit,
    lit,
    max_,
    min_,
    sum_,
)
from .errors import BallistaError  # noqa: E402


def print_version() -> None:
    print(f"ballista-tpu (PyTorch/CUDA port) version: {BALLISTA_TPU_VERSION}")
