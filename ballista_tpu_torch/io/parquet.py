"""Parquet table source (via pyarrow).

The port of the JAX package's ``io/parquet.py``: the same reads (decimals
through float64, dates from date32 or timestamps, utf8 through
``to_pylist``), the same dictionaries (interned in the dictionary
registry per table files and column, so every source instance over the
same files shares one ``Dictionary`` per column), batches uploaded to the
source's explicit ``device`` through ``ColumnBatch.from_numpy`` (pinned,
asynchronous), and a table-cache key that holds the device.

Equivalent of the reference's ParquetScan + GetFileMetadata surface
(reference: rust/core/proto/ballista.proto:348-354, rust/scheduler/src/
lib.rs:184-222). One partition per file (directory datasets) or per
row-group chunk of a single file.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ingest.phases import phase

import torch

from ..columnar import (ColumnBatch, DEFAULT_BATCH_CAPACITY, DeviceLike,
                        Dictionary)
from ..compile import bucket_capacity
from ..datatypes import (
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
)
from ..errors import IoError
from ..logical import TableSource


def _arrow_to_dtype(t) -> DataType:
    import pyarrow as pa

    if pa.types.is_int64(t) or pa.types.is_uint32(t):
        return Int64
    if pa.types.is_integer(t):
        return Int32
    if pa.types.is_float64(t):
        return Float64
    if pa.types.is_floating(t):
        return Float32
    if pa.types.is_boolean(t):
        return Boolean
    if pa.types.is_decimal(t):
        return Decimal(t.scale)
    if pa.types.is_date(t):
        return Date32
    if pa.types.is_timestamp(t):
        from ..datatypes import TimestampNs

        return TimestampNs
    if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_dictionary(t):
        return Utf8
    raise IoError(f"unsupported parquet type {t}")


class ParquetSource(TableSource):
    def __init__(self, path: str, schema: Optional[Schema] = None,
                 batch_capacity: int = DEFAULT_BATCH_CAPACITY, *,
                 device: DeviceLike):
        import pyarrow.parquet as pq

        self.device = torch.device(device)
        self._path = path
        if os.path.isdir(path):
            self._files = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.endswith(".parquet")
            )
            if not self._files:
                raise IoError(f"no parquet files under {path}")
        else:
            self._files = [path]
        self._capacity = batch_capacity
        pf = pq.ParquetFile(self._files[0])
        arrow_schema = pf.schema_arrow
        if schema is None:
            fields = [
                Field(n, _arrow_to_dtype(arrow_schema.field(n).type), True)
                for n in arrow_schema.names
            ]
            schema = Schema(fields)
        self._schema = schema
        self._dicts: Dict[str, Dictionary] = {}
        # dictionary-registry entry identity: same
        # parquet files -> shared interned dictionaries per column
        from .. import columnar_registry

        self._dict_key_base = columnar_registry.file_entry_key(
            "parquet", path, self._files)
        # concurrent partition scans (parallel ingest) share one
        # dictionary instance per column; per-COLUMN locks so builds of
        # distinct columns overlap on the ingest pool (each build reads
        # every file — serializing them would re-serialize the cold
        # path this subsystem pipelines)
        from ..ingest import KeyedLocks

        self._dict_locks = KeyedLocks()

    def table_schema(self) -> Schema:
        return self._schema

    def num_partitions(self) -> int:
        return len(self._files)

    def source_descriptor(self) -> dict:
        return {"kind": "parquet", "path": self._path}

    def estimated_rows(self) -> Optional[int]:
        est = getattr(self, "_est_rows", None)
        if est is None:  # footer reads are real IO — compute once
            import pyarrow.parquet as pq

            est = sum(pq.ParquetFile(f).metadata.num_rows
                      for f in self._files)
            self._est_rows = est
        return est

    def _dictionary_for(self, colname: str) -> Dictionary:
        import pyarrow.parquet as pq

        from .. import columnar_registry

        if colname in self._dicts:  # fast path once built
            return self._dicts[colname]
        with self._dict_locks.get(colname):
            if colname in self._dicts:
                return self._dicts[colname]
            key = self._dict_key_base + (colname,)
            d = columnar_registry.REGISTRY.lookup(key)
            if d is not None:
                self._dicts[colname] = d
                return d
            with phase("parse"):
                uniq: Optional[np.ndarray] = None
                for f in self._files:
                    t = pq.read_table(f, columns=[colname])
                    # NULL strings follow the text-path convention: ""
                    # is the stored value, validity rides separately
                    # (and None would break object-array sorting)
                    vals = np.asarray(
                        ["" if v is None else v
                         for v in t.column(0).to_pylist()], dtype=object)
                    u = np.unique(vals)  # dict-ok: raw-value dict build
                    uniq = (u if uniq is None
                            else np.unique(  # dict-ok: raw-value build
                                np.concatenate([uniq, u])))
                d = columnar_registry.intern(
                    key, uniq if uniq is not None else [])
                self._dicts[colname] = d
                return d

    def content_signature(self) -> Optional[tuple]:
        """Re-stat'd file identity — the result-cache invalidation
        signal for parquet tables."""
        from .. import columnar_registry

        return columnar_registry.file_entry_key(
            "parquet", self._path, self._files)

    def residency_key(self, partition: int,
                      projection=None) -> Optional[tuple]:
        from ..cache import residency

        return residency.scan_key(
            "parquet", self._files[partition], partition, projection,
            extra=(self._capacity, str(self.device)))

    def scan(self, partition: int, projection: Optional[Sequence[str]] = None):
        from ..cache import residency

        yield from residency.serve_or_fill(
            self.residency_key(partition, projection),
            lambda: self._scan_direct(partition, projection),
            outcome_sink=self._note_scan_outcome(partition))

    def _scan_direct(self, partition: int,
                     projection: Optional[Sequence[str]] = None):
        """The uncached parse + H2D path (residency misses land here)."""
        import pyarrow.parquet as pq

        names = list(projection) if projection is not None else list(self._schema.names())
        sub_schema = self._schema.project(names)
        with phase("parse", path=self._files[partition]):
            table = pq.read_table(self._files[partition], columns=names)
            n = table.num_rows
            arrays: Dict[str, np.ndarray] = {}
            dicts: Dict[str, Dictionary] = {}
            valids: Dict[str, np.ndarray] = {}
            for name in names:
                field = self._schema.field(name)
                colarr = table.column(name).combine_chunks()
                # NULLs: non-string columns surface validity=False (same
                # convention as the text scanners — the physical value is
                # a harmless fill, the mask is the truth); utf8 NULLs
                # store "" (a value), matching io/text.py's fillna("")
                null_mask = None
                if colarr.null_count:
                    null_mask = np.asarray(colarr.is_null())
                    if field.dtype.kind != "utf8":
                        valids[name] = ~null_mask
                if field.dtype.kind == "utf8":
                    d = self._dictionary_for(name)
                    vals = np.asarray(
                        ["" if v is None else v for v in colarr.to_pylist()],
                        dtype=object)
                    arrays[name] = d.positions_of(vals)
                    dicts[name] = d
                elif field.dtype.kind == "decimal":
                    from ..columnar import decimal_to_scaled

                    vals = colarr.cast("float64").to_numpy(
                        zero_copy_only=False)
                    if null_mask is not None:  # NaN would scale to garbage
                        vals = np.where(null_mask, 0.0, vals)
                    arrays[name] = decimal_to_scaled(vals, field.dtype.scale)
                elif field.dtype.kind == "date32":
                    import pyarrow as pa

                    # files may store dates as date32 OR timestamps
                    # (pandas writers); normalize through date32 ->
                    # days-since-epoch. NULLs fill at the ARROW level:
                    # to_numpy on a nullable array detours through
                    # float64, which the integer paths must never do
                    arr = colarr
                    if not pa.types.is_date32(arr.type):
                        arr = arr.cast(pa.date32())
                    arr = arr.cast(pa.int32())
                    if null_mask is not None:
                        arr = arr.fill_null(0)
                    arrays[name] = arr.to_numpy(
                        zero_copy_only=False).astype(np.int32)
                elif field.dtype.kind == "timestamp_ns":
                    import pyarrow as pa

                    arr = colarr.cast(pa.timestamp("ns")).cast(pa.int64())
                    if null_mask is not None:  # arrow-level fill: exact
                        arr = arr.fill_null(0)
                    arrays[name] = arr.to_numpy(
                        zero_copy_only=False).astype(np.int64)
                else:
                    # integers with NULLs: fill on the arrow array so the
                    # conversion stays integral end-to-end (a float64
                    # detour would silently round int64 above 2^53 —
                    # same invariant the text path pins with
                    # test_big_int64_survives_null_column)
                    arr = colarr
                    if null_mask is not None:
                        import pyarrow as pa

                        fill = (False if pa.types.is_boolean(arr.type)
                                else 0)
                        arr = arr.fill_null(fill)
                    arrays[name] = arr.to_numpy(
                        zero_copy_only=False).astype(
                            field.dtype.device_dtype())
        from ..lifecycle import check_cancel

        cap = min(self._capacity, bucket_capacity(max(n, 1)))
        start = 0
        emitted = False
        while start < n or not emitted:
            # chunk-level cancellation: each iteration slices + uploads
            # one batch, the boundary a fired token stops at
            check_cancel()
            end = min(start + cap, n)
            chunk = {k: v[start:end] for k, v in arrays.items()}
            vchunk = (
                {k: v[start:end] for k, v in valids.items()}
                if valids else None
            )
            with phase("h2d", rows=end - start):
                batch = ColumnBatch.from_numpy(sub_schema, chunk, dicts,
                                               capacity=cap, validity=vchunk,
                                               device=self.device)
            yield batch
            emitted = True
            start = end
            if start >= n:
                break
