"""Build the port's batches from another engine's batch leaves.

The tests hand the SAME batch to the JAX package and to the port: they
take a JAX ``ColumnBatch`` apart into numpy arrays (on their side — this
module imports nothing of the JAX package) and rebuild it here, leaf for
leaf, so operators and kernels of both packages see identical inputs,
padding and dead rows included.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .columnar import Column, ColumnBatch, DeviceLike, Dictionary
from .datatypes import Schema
from .errors import SchemaError


def _tensor(arr, dtype, device: torch.device) -> torch.Tensor:
    # a private, writable, C-contiguous copy: the arrays a JAX batch hands
    # out are read-only views of its buffers
    return torch.from_numpy(np.array(arr, dtype=dtype, order="C")).to(device)


def batch_from_numpy(
    schema: Schema,
    columns: Sequence[np.ndarray],
    validities: Sequence[Optional[np.ndarray]],
    selection: np.ndarray,
    dictionaries: Dict[str, Sequence[str]],
    device: DeviceLike,
) -> ColumnBatch:
    """``columns[i]``/``validities[i]`` are the physical values and the
    validity (None = all valid) of ``schema.fields[i]`` at full capacity;
    ``selection`` is the live-row mask; ``dictionaries`` maps each utf8
    column's name to its dictionary values. ``num_rows`` is recomputed
    from ``selection``."""
    device = torch.device(device)
    if len(columns) != len(schema) or len(validities) != len(schema):
        raise SchemaError(
            f"schema has {len(schema)} fields, got {len(columns)} columns "
            f"and {len(validities)} validities")
    cols = []
    for f, vals, valid in zip(schema.fields, columns, validities):
        t = _tensor(vals, f.dtype.device_dtype(), device)
        v = None if valid is None else _tensor(valid, np.bool_, device)
        d = (Dictionary(dictionaries[f.name])
             if f.dtype.kind == "utf8" else None)
        cols.append(Column(t, f.dtype, v, d))
    sel = _tensor(selection, np.bool_, device)
    return ColumnBatch(schema, cols, sel, sel.sum(dtype=torch.int32))
