"""Delimited text sources: TPC-H ``.tbl`` ('|'-separated) and CSV.

The port of the JAX package's ``io/text.py``. Parsing goes through the
native C++ scanner only (the machines the port targets have no pandas), so
quoted CSV, and types the scanner has no code for, raise.

Partitioning: a directory scans one file per partition; a single file is
one partition, chunked into batches of ``batch_capacity`` rows. A file
larger than ``STREAM_CHUNK_BYTES`` (``BALLISTA_SCAN_CHUNK_BYTES``, 1 GiB,
read at import as in the JAX package) is parsed in byte-range chunks,
each emitting its batches as soon as it is parsed, so RAM stays bounded
(a projection with string columns first reads them from the whole file
for the table-wide dictionaries); such a file bypasses the table cache
(``residency_key`` is None), since its output would evict the whole
cache for one table.

Dictionaries: a single-file table adopts the file's sorted dictionary; a
multi-file table, and any streamed file, builds one sorted dictionary per
string column over ALL files at first use (one native pre-pass, range by
range over a streamed file), so codes are ordinal and comparable across
every batch of the table, and every chunk's batches carry the same
``Dictionary`` object (graph signatures key on dictionary identity).

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

Not ported yet: the dictionary registry shared between sources.
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

# Files larger than this stream through the native scanner in byte-range
# chunks (bounded RAM at any scale factor) instead of one whole-file
# parse. Streaming pays one extra pre-pass over the file to build
# table-wide utf8 dictionaries, so the threshold sits where whole-file
# RAM hurts (~1GB of text -> a few GB resident). Read at import, as the
# JAX package reads it; set the module attribute to change it later.
STREAM_CHUNK_BYTES = int(
    os.environ.get("BALLISTA_SCAN_CHUNK_BYTES", str(1 << 30))
)


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
        and every file of the table (the dictionaries' inputs). None for
        a streamed file: it bypasses the cache."""
        if self._streams(partition):
            return None
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

    def _streams(self, partition: int) -> bool:
        """True when the partition's file is parsed in byte ranges."""
        try:
            size = os.path.getsize(self._files[partition])
        except OSError:
            return False
        return size > STREAM_CHUNK_BYTES

    def _table_dictionaries(self, colnames: List[str]) -> Dict[str, Dictionary]:
        """Table-wide sorted dictionaries for several utf8 columns, built
        by ONE native pre-pass over every file, range by range over a
        file larger than ``STREAM_CHUNK_BYTES`` (only the values are
        kept)."""
        from . import native

        with self._dict_lock:
            need = [n for n in colnames if n not in self._dicts]
            if need:
                uniq: Dict[str, List[np.ndarray]] = {n: [] for n in need}
                for f in self._files:
                    size = os.path.getsize(f)
                    streamed = size > STREAM_CHUNK_BYTES
                    for off in (range(0, size, STREAM_CHUNK_BYTES)
                                if streamed else [0]):
                        _, _, fd, _ = native.scan_file(
                            f, self._schema, need, self._delim,
                            self._header, offset=off,
                            max_bytes=STREAM_CHUNK_BYTES if streamed
                            else -1)
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
        if self._streams(partition):
            yield from self._scan_native_streaming(partition, names,
                                                   sub_schema)
            return
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

    def _scan_native_streaming(self, partition: int, names, sub_schema):
        """Parse one partition file in byte-range chunks (adjacent ranges
        partition the rows exactly), remap each range's utf8 codes onto
        the table-wide dictionaries (one shared pre-pass) and emit each
        range's batches as soon as it is parsed. Peak RAM is
        O(STREAM_CHUNK_BYTES)."""
        from . import native

        path = self._files[partition]
        size = os.path.getsize(path)
        chunk = STREAM_CHUNK_BYTES
        utf8 = [m for m in names
                if self._schema.field(m).dtype.kind == "utf8"]
        with phase("parse", path=path, prepass="dicts"):
            dicts = self._table_dictionaries(utf8)
        off = 0
        emitted = False
        while off < size:
            with phase("parse", path=path, offset=off):
                n, arrays, fdicts, valids = native.scan_file(
                    path, self._schema, names, self._delim, self._header,
                    offset=off, max_bytes=chunk)
                off += chunk
                if n == 0:
                    continue
                for m in utf8:
                    arrays[m] = dicts[m].positions_of(
                        fdicts[m])[arrays[m]].astype(np.int32)
            # a range's tail batch is emitted partial, on the ladder
            yield from self._emit_batches(sub_schema, n, arrays, dicts,
                                          valids, force_emit=False)
            emitted = True
        if not emitted:  # empty file: one empty batch keeps contracts
            yield from self._emit_batches(sub_schema, 0, {
                m: np.zeros(0, self._schema.field(m).dtype.device_dtype())
                for m in names}, dicts, None)

    def _emit_batches(self, sub_schema, n, arrays, dicts, valids=None,
                      force_emit=True):
        """Fixed-capacity batches on the source's device; at least one
        (possibly empty) batch unless ``force_emit`` is False (a streamed
        range with no rows emits none). Scan batches enter at ladder
        capacities. The parse buffers are accounted as host ``batches``
        memory until every chunk is uploaded (released on an abandoned
        scan too)."""
        if n == 0 and not force_emit:
            return
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
