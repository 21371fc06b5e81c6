"""In-memory table source (testing + intermediate results)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..columnar import (ColumnBatch, DeviceLike, Dictionary,
                        decimal_to_scaled)
from ..datatypes import Schema
from ..logical import TableSource


class MemTableSource(TableSource):
    def __init__(self, schema: Schema, partitions: List[List[ColumnBatch]]):
        self._schema = schema
        self._partitions = partitions

    def estimated_rows(self) -> Optional[int]:
        return sum(int(b.num_rows) for part in self._partitions for b in part)

    @staticmethod
    def from_pydict(schema: Schema, data: Dict, num_partitions: int = 1,
                    capacity: Optional[int] = None, *,
                    device: DeviceLike) -> "MemTableSource":
        n = len(next(iter(data.values()))) if data else 0
        # encode once, table-wide, so all partitions share interned
        # dictionaries (required for cross-batch concat/compare)
        arrays: Dict[str, np.ndarray] = {}
        dicts: Dict[str, Dictionary] = {}
        for f in schema.fields:
            vals = data[f.name]
            if f.dtype.kind == "utf8":
                d, codes = Dictionary.encode([str(v) for v in vals])
                dicts[f.name] = d
                arrays[f.name] = codes
            elif f.dtype.kind == "decimal":
                arrays[f.name] = decimal_to_scaled(
                    [float(v) for v in vals], f.dtype.scale
                )
            else:
                arrays[f.name] = np.asarray(vals, dtype=f.dtype.device_dtype())
        per = max(1, -(-n // num_partitions))
        parts = []
        for p in range(num_partitions):
            lo, hi = p * per, min((p + 1) * per, n)
            if hi <= lo:
                parts.append([])
                continue
            sliced = {k: v[lo:hi] for k, v in arrays.items()}
            parts.append([ColumnBatch.from_numpy(schema, sliced, dicts,
                                                 capacity, device=device)])
        return MemTableSource(schema, parts)

    def table_schema(self) -> Schema:
        return self._schema

    def num_partitions(self) -> int:
        return len(self._partitions)

    def is_resident(self, partition: int, projection=None) -> bool:
        """A memory table's batches live on their device already: a scan
        has no parse or upload to overlap (``ScanExec._prefetchable``)."""
        return True

    def scan_cache_outcome(self, partition: int) -> Optional[str]:
        """Memory tables do not route through the table cache."""
        return None

    def scan(self, partition: int, projection: Optional[Sequence[str]] = None):
        for batch in self._partitions[partition]:
            if projection is None:
                yield batch
            else:
                sub = self._schema.project(projection)
                cols = [batch.column(n) for n in projection]
                yield batch.with_columns(sub, cols)
