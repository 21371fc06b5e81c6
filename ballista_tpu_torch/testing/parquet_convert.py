"""``.tbl`` -> Parquet for the TPC-H tables, through the port's own scan
on the CPU and pyarrow (no JAX package, no pandas).

The layout and the column types are those of the JAX package's converter
(``benchmarks/tpch/main.py convert --format parquet``, which goes through
pandas): ``<out>/<table>/part-<i>.parquet``; integers as int64/int32,
decimals as float64, dates as ``timestamp[ms]``, strings as
``large_string``. The Parquet source reads them back as the JAX package's
does (decimals through float64, dates through date32).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .tpch_schema import TPCH_SCHEMAS


def _arrow_type(dtype):
    import pyarrow as pa

    if dtype.kind == "utf8":
        return pa.large_string()
    if dtype.kind == "date32":
        return pa.timestamp("ms")
    if dtype.kind in ("decimal", "float64", "float32"):
        return pa.float64()
    if dtype.kind == "int32":
        return pa.int32()
    return pa.int64()


def _arrow_column(values: np.ndarray, dtype):
    import pyarrow as pa

    if dtype.kind == "date32":
        return pa.array(values.astype("datetime64[ms]"),
                        type=pa.timestamp("ms"))
    if dtype.kind == "utf8":
        return pa.array(list(values), type=pa.large_string())
    return pa.array(values, type=_arrow_type(dtype))


def convert_table(tbl_path: str, schema, out_dir: str,
                  partitions: int = 1) -> int:
    """One table: every partition of the ``.tbl`` scan on the CPU,
    decoded to logical values and split into ``partitions`` row ranges,
    one Parquet file each. Returns the row count."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ..io import TblSource

    src = TblSource(tbl_path, schema, device="cpu")
    parts = [b.to_pydict() for p in range(src.num_partitions())
             for b in src.scan(p)]
    cols: Dict[str, np.ndarray] = {
        f.name: np.concatenate([d[f.name] for d in parts])
        for f in schema.fields}
    n = len(cols[schema.fields[0].name])
    per = -(-n // max(partitions, 1))
    os.makedirs(out_dir, exist_ok=True)
    fields = [pa.field(f.name, _arrow_type(f.dtype)) for f in schema.fields]
    for i in range(max(partitions, 1)):
        lo, hi = i * per, min((i + 1) * per, n)
        if lo >= hi and i > 0:
            continue
        table = pa.table([_arrow_column(cols[f.name][lo:hi], f.dtype)
                          for f in schema.fields], schema=pa.schema(fields))
        path = os.path.join(out_dir, f"part-{i}.parquet")
        pq.write_table(table, path + ".tmp")
        os.replace(path + ".tmp", path)
    return n


def convert_tpch(tbl_dir: str, out_dir: str, partitions: int = 1) -> dict:
    """Every TPC-H table of a ``datagen.py`` directory; table -> rows."""
    out = {}
    for name, sch in TPCH_SCHEMAS.items():
        path = os.path.join(tbl_dir, name)
        if not os.path.exists(path):
            path = os.path.join(tbl_dir, f"{name}.tbl")
        out[name] = convert_table(path, sch, os.path.join(out_dir, name),
                                  partitions)
    return out


def register_tpch_parquet(ctx, pq_dir: str, tables=None, **kw) -> None:
    """Register the converted tables on a context of the port."""
    from .tpch_schema import TPCH_PKS

    for name, sch in TPCH_SCHEMAS.items():
        if tables is not None and name not in tables:
            continue
        ctx.register_parquet(name, os.path.join(pq_dir, name), sch,
                             primary_key=TPCH_PKS[name], **kw)

