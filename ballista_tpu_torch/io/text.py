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

Warm path: ``scan`` goes through the device table cache
(``cache/residency.py``), keyed by the partition file, the projection,
the format, the device and the signature of EVERY file of the table —
a table's dictionaries come from all its files, so a file added to the
directory must change every partition's key. A hit is handed this
source's own dictionary objects where it has equal ones (graphs and
dictionary remaps key on dictionary identity), and adopted as this
source's dictionaries where it has none yet; the codes are the same,
since equal file sets give equal dictionaries.

Timing: the parse and the upload of each batch are ``ingest.phase``
blocks (``elapsed_parse``/``elapsed_h2d`` on the scan's metrics).

Not ported yet: the byte-range streaming of files above 1 GB (each file is
parsed whole here, so no file bypasses the cache as the JAX package's
streamed files do) and the dictionary registry shared between sources.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..cache import residency
from ..columnar import (Column, ColumnBatch, DEFAULT_BATCH_CAPACITY,
                        DeviceLike, Dictionary)
from ..compile import bucket_capacity
from ..datatypes import Schema
from ..errors import ExecutionError, IoError
from ..ingest.phases import phase
from ..lifecycle import check_cancel
from ..logical import TableSource
from ..observability.memory import track_host_bytes


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
        self._path = path
        self._files = _list_files(path)
        self._dicts: Dict[str, Dictionary] = {}
        # cached batches' dictionaries known equal in value to this
        # source's: id -> (theirs, ours), holding both alive
        self._equal_dicts: Dict[int, tuple] = {}
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

    def _table_signature(self) -> tuple:
        """(basename, size, mtime_ns) of every file of the table, taken
        now."""
        return tuple(residency.file_signature(f) for f in self._files)

    def content_signature(self) -> Optional[tuple]:
        """Re-stat'd file identity + the format knobs that change parsed
        rows — the result-cache invalidation signal."""
        return ("text", os.path.abspath(self._path),
                self._table_signature(), self._delim, self._header)

    def residency_key(self, partition: int,
                      projection=None) -> Optional[tuple]:
        """The table cache's key for one partition scan: the partition
        file, the projection, the format, the batch capacity, the device
        and every file of the table (the dictionaries' inputs)."""
        return residency.scan_key(
            "tbl" if self._delim == "|" else "csv",
            self._files[partition], partition, projection,
            extra=(self._delim, self._header, self._capacity,
                   str(self.device), self._table_signature()))

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
        for batch in residency.serve_or_fill(
                self.residency_key(partition, projection),
                lambda: self._scan_direct(partition, projection),
                outcome_sink=self._note_scan_outcome(partition)):
            yield self._own_dictionaries(batch)

    def _own_dictionaries(self, batch: ColumnBatch) -> ColumnBatch:
        """``batch`` with this source's dictionary objects (see the
        module doc): a no-op for batches this source parsed."""
        swap = {}
        with self._dict_lock:
            for i, (f, c) in enumerate(zip(batch.schema.fields,
                                           batch.columns)):
                d = c.dictionary
                mine = self._dicts.get(f.name)
                if d is None or d is mine:
                    continue
                if mine is None:
                    self._dicts[f.name] = d
                    continue
                known = self._equal_dicts.get(id(d))
                if known is None or known[1] is not mine:
                    if len(d) != len(mine) or not np.array_equal(
                            d.values_str(), mine.values_str()):
                        raise ExecutionError(
                            f"table cache served {f.name} with a "
                            f"dictionary that differs from the source's")
                    self._equal_dicts[id(d)] = (d, mine)
                swap[i] = mine
        if not swap:
            return batch
        return batch.with_columns(batch.schema, [
            Column(c.values, c.dtype, c.validity, swap[i]) if i in swap
            else c for i, c in enumerate(batch.columns)])

    def _scan_direct(self, partition: int,
                     projection: Optional[Sequence[str]] = None):
        """The uncached parse + H2D path (table cache misses land here)."""
        from . import native

        names = list(projection if projection is not None
                     else self._schema.names())
        sub_schema = self._schema.project(names)
        with phase("parse", path=self._files[partition]):
            n, arrays, fdicts, valids = native.scan_file(
                self._files[partition], self._schema, names, self._delim,
                self._header,
            )
            utf8 = [m for m in names
                    if self._schema.field(m).dtype.kind == "utf8"]
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
                    arrays[m] = d.positions_of(fvals)[arrays[m]].astype(
                        np.int32)
        yield from self._emit_batches(sub_schema, n, arrays, dicts, valids)

    def _emit_batches(self, sub_schema, n, arrays, dicts, valids=None):
        """Fixed-capacity batches on the source's device; at least one
        (possibly empty) batch. Scan batches enter at ladder capacities.
        The parse buffers are accounted as host ``batches`` memory until
        every chunk is uploaded (released on an abandoned scan too)."""
        parse_bytes = sum(int(a.nbytes) for a in arrays.values())
        with track_host_bytes("batches", parse_bytes):
            cap = min(self._capacity, bucket_capacity(max(n, 1)))
            start = 0
            while True:
                # chunk-level cancellation: each iteration slices and
                # uploads one batch, the boundary a fired token stops at
                check_cancel()
                end = min(start + cap, n)
                chunk = {k: v[start:end] for k, v in arrays.items()}
                vchunk = (
                    {k: v[start:end] for k, v in valids.items()}
                    if valids else None
                )
                with phase("h2d", rows=end - start):
                    batch = ColumnBatch.from_numpy(
                        sub_schema, chunk, dicts, capacity=cap,
                        validity=vchunk, device=self.device)
                yield batch
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
