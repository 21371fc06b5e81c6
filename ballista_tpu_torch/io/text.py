"""Delimited text sources: TPC-H ``.tbl`` ('|'-separated) and CSV.

The port of the JAX package's ``io/text.py``. Parsing goes through the
native C++ scanner only (the machines the port targets have no pandas), so
quoted CSV, and types the scanner has no code for, raise.

Partitioning: a directory scans one file per partition; a single file is
one partition, chunked into batches of ``batch_capacity`` rows.

Dictionaries: a single-file table adopts the file's sorted dictionary; a
multi-file table builds one sorted dictionary per string column over ALL
files at first use (one native pre-pass), so codes are ordinal and
comparable across every batch of the table.

Not ported yet: the byte-range streaming of files above 1 GB (each file is
parsed whole here), the dictionary registry shared between sources, and
the device-residency cache.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..columnar import ColumnBatch, DEFAULT_BATCH_CAPACITY, DeviceLike, Dictionary
from ..compile import bucket_capacity
from ..datatypes import Schema
from ..errors import IoError
from ..logical import TableSource


def _list_files(path: str, suffixes=(".tbl", ".csv", ".txt", ".dat")) -> List[str]:
    if os.path.isdir(path):
        out = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith(suffixes) or "." not in f
        )
        if not out:
            raise IoError(f"no data files under {path}")
        return out
    if not os.path.exists(path):
        raise IoError(f"no such path: {path}")
    return [path]


class DelimitedSource(TableSource):
    def __init__(
        self,
        path: str,
        schema: Schema,
        delimiter: str,
        has_header: bool = False,
        batch_capacity: int = DEFAULT_BATCH_CAPACITY,
        *,
        device: DeviceLike,
    ):
        from . import native

        self._schema = schema
        self._delim = delimiter
        self._header = has_header
        self._capacity = batch_capacity
        self.device = torch.device(device)
        self._files = _list_files(path)
        self._dicts: Dict[str, Dictionary] = {}
        # one dictionary instance per column even when partitions scan
        # concurrently
        self._dict_lock = threading.Lock()
        if len(delimiter) != 1 or any(
                f.dtype.kind not in native._KIND_CODES for f in schema.fields):
            raise IoError(
                "the native scanner reads single-character delimiters and "
                "int/decimal/date/utf8/float/boolean columns only")

    # -- TableSource --------------------------------------------------------

    def table_schema(self) -> Schema:
        return self._schema

    def num_partitions(self) -> int:
        return len(self._files)

    def estimated_rows(self) -> Optional[int]:
        """file sizes / sampled average line length (no full read)."""
        if not self._files:
            return 0
        try:
            with open(self._files[0], "rb") as fh:
                sample = fh.read(1 << 16)
        except OSError:
            return None
        lines = sample.count(b"\n")
        if lines == 0:
            return None
        avg = len(sample) / lines
        total = sum(os.path.getsize(f) for f in self._files)
        return int(total / avg)

    # -- scanning -----------------------------------------------------------

    def _table_dictionaries(self, colnames: List[str]) -> Dict[str, Dictionary]:
        """Table-wide sorted dictionaries for several utf8 columns, built
        by ONE native pre-pass over every file (only the values are
        kept)."""
        from . import native

        with self._dict_lock:
            need = [n for n in colnames if n not in self._dicts]
            if need:
                uniq: Dict[str, List[np.ndarray]] = {n: [] for n in need}
                for f in self._files:
                    _, _, fd, _ = native.scan_file(
                        f, self._schema, need, self._delim, self._header)
                    for n in need:
                        uniq[n].append(np.asarray(fd[n]).astype(str))
                for n in need:
                    vals = (np.unique(np.concatenate(uniq[n]))
                            if uniq[n] else np.zeros(0, dtype=str))
                    self._dicts[n] = Dictionary(vals.astype(object))
            return {n: self._dicts[n] for n in colnames}

    def scan(self, partition: int, projection: Optional[Sequence[str]] = None):
        from . import native

        names = list(projection if projection is not None
                     else self._schema.names())
        sub_schema = self._schema.project(names)
        n, arrays, fdicts, valids = native.scan_file(
            self._files[partition], self._schema, names, self._delim,
            self._header,
        )
        utf8 = [m for m in names if self._schema.field(m).dtype.kind == "utf8"]
        dicts: Dict[str, Dictionary] = {}
        if len(self._files) == 1:
            with self._dict_lock:  # adopt the file's sorted dictionary
                for m in utf8:
                    if m not in self._dicts:
                        self._dicts[m] = Dictionary(fdicts[m])
                    dicts[m] = self._dicts[m]
        else:
            dicts = self._table_dictionaries(utf8)
        for m in utf8:
            d = dicts[m]
            fvals = np.asarray(fdicts[m]).astype(str)
            # remap unless the file's values are the dictionary verbatim
            if len(d) != len(fvals) or not np.array_equal(d.values_str(),
                                                          fvals):
                arrays[m] = d.positions_of(fvals)[arrays[m]].astype(np.int32)
        yield from self._emit_batches(sub_schema, n, arrays, dicts, valids)

    def _emit_batches(self, sub_schema, n, arrays, dicts, valids=None):
        """Fixed-capacity batches on the source's device; at least one
        (possibly empty) batch. Scan batches enter at ladder capacities."""
        cap = min(self._capacity, bucket_capacity(max(n, 1)))
        start = 0
        while True:
            end = min(start + cap, n)
            chunk = {k: v[start:end] for k, v in arrays.items()}
            vchunk = (
                {k: v[start:end] for k, v in valids.items()}
                if valids else None
            )
            yield ColumnBatch.from_numpy(sub_schema, chunk, dicts,
                                         capacity=cap, validity=vchunk,
                                         device=self.device)
            start = end
            if start >= n:
                break


class TblSource(DelimitedSource):
    """TPC-H dbgen output: '|' separated, trailing '|', no header."""

    def __init__(self, path: str, schema: Schema,
                 batch_capacity: int = DEFAULT_BATCH_CAPACITY, *,
                 device: DeviceLike):
        # the scanner reads the schema's fields and ignores the trailing '|'
        super().__init__(path, schema, "|", has_header=False,
                         batch_capacity=batch_capacity, device=device)


class CsvSource(DelimitedSource):
    """Unquoted delimited text with an optional header line."""

    def __init__(self, path: str, schema: Schema, has_header: bool = True,
                 delimiter: str = ",",
                 batch_capacity: int = DEFAULT_BATCH_CAPACITY, *,
                 device: DeviceLike):
        super().__init__(path, schema, delimiter, has_header=has_header,
                         batch_capacity=batch_capacity, device=device)
