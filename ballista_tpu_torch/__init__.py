"""ballista-tpu's PyTorch/CUDA port: the same SQL/DataFrame surface, plans
and results as the JAX package ``ballista_tpu``, on torch tensors on one
explicit device (an NVIDIA H100 by default, or the CPU when asked).

The JAX package is the reference: every module here keeps the name and
place of its counterpart there, and the tests hold each against it. This
package imports torch and never jax, and nothing of ``ballista_tpu``.
"""

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
