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

Where the parse runs (``scan_path``): on a CUDA device a partition file
no larger than ``STREAM_CHUNK_BYTES`` whose wanted columns are all int,
decimal, date, utf8 or boolean parses on the card (``_scan_on_card``):
the host reads the file's bytes in chunks of ``READ_CHUNK_BYTES`` into
pinned staging buffers from torch's caching host allocator (reused, a
few reader threads), each chunk copied asynchronously to its place in
one device buffer while the next is read; the kernels of
``kernels/tbl_parse.py`` split, type and dictionary-encode the rows, and
the batches are slices of the parsed device columns. Every other scan
(the CPU device, a streamed file, a float column) parses on the host
through the native scanner, as before. ``ingest.scan_counters()`` counts
each path, the host path by its reason.

Timing: the parse and the upload are ``ingest.phase`` blocks
(``elapsed_parse``/``elapsed_h2d`` on the scan's metrics). On the host
path ``parse`` is the scanner and ``h2d`` each batch's upload; on the
card's, ``h2d`` is the read into pinned memory and the queued copies,
``parse`` the kernels, the dictionaries and the waits until the columns
stand on the card.

As in the JAX package, the dictionaries are interned in
``columnar_registry`` under the table's files (``file_entry_key``): every
source over the same files shares one instance per column, and shuffle
files written from a scan's columns carry the registry's stamp, as the
JAX package's do (byte-identical files).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cache import residency
from ..columnar import (Column, ColumnBatch, DEFAULT_BATCH_CAPACITY,
                        DeviceLike, Dictionary, upload_stream)
from ..compile import bucket_capacity
from ..datatypes import Schema
from ..errors import ExecutionError, IoError
from ..ingest.phases import count, phase
from ..kernels import tbl_parse
from ..lifecycle import check_cancel
from ..logical import TableSource
from ..observability import hostclock
from ..observability.memory import track_host_bytes
from ..observability.tracing import trace_span

# Files larger than this stream through the native scanner in byte-range
# chunks (bounded RAM at any scale factor) instead of one whole-file
# parse. Streaming pays one extra pre-pass over the file to build
# table-wide utf8 dictionaries, so the threshold sits where whole-file
# RAM hurts (~1GB of text -> a few GB resident). Read at import, as the
# JAX package reads it; set the module attribute to change it later.
STREAM_CHUNK_BYTES = int(
    os.environ.get("BALLISTA_SCAN_CHUNK_BYTES", str(1 << 30))
)


# The card's path reads a file in chunks of this many bytes, each into a
# pinned staging buffer, with a reader thread a core up to eight (SF1
# lineitem staged at 10.9 GB/s with 4 threads, 18.6 GB/s with 8, on the
# 8-core host of an H100).
READ_CHUNK_BYTES = 16 << 20
READ_THREADS = min(8, os.cpu_count() or 1)

_read_pool: Optional[ThreadPoolExecutor] = None
_read_pool_lock = threading.Lock()


def _reader() -> ThreadPoolExecutor:
    global _read_pool
    with _read_pool_lock:
        if _read_pool is None:
            _read_pool = ThreadPoolExecutor(
                READ_THREADS, thread_name_prefix="ballista-tblread")
        return _read_pool


def _read_into(fd: int, buf: np.ndarray, offset: int) -> None:
    """Fill ``buf`` with the file's bytes from ``offset`` (the interpreter
    lock is released while the kernel copies)."""
    view = memoryview(buf)
    got = 0
    while got < len(view):
        n = os.preadv(fd, [view[got:]], offset + got)
        if n == 0:
            raise IoError(f"file shrank while it was read (at byte "
                          f"{offset + got})")
        got += n


def stage_text(path: str, device: torch.device,
               has_header: bool) -> Tuple[torch.Tensor, int, int]:
    """(bytes, size, first row's offset): the file's bytes in a buffer of
    ``tbl_parse.padded_bytes(size)`` on ``device``, and where its rows
    begin (past the header line when ``has_header``). On a card the
    bytes go through pinned chunks of ``READ_CHUNK_BYTES``, read ahead by
    the reader threads, each copied asynchronously on the current stream
    as soon as it is read; the caching host allocator keeps a chunk's
    block until its copy has run, and hands it out again after."""
    size = os.path.getsize(path)
    padded = tbl_parse.padded_bytes(size)
    begin = 0
    if device.type != "cuda":
        buf = torch.zeros(padded, dtype=torch.uint8)
        # a CPU tensor's memory, no device value
        # ballista: ignore[sync-span]
        host = buf.numpy()
        with open(path, "rb") as fh:
            _read_into(fh.fileno(), host[:size], 0)
        if has_header:
            nl = np.flatnonzero(host[:size] == tbl_parse.NEWLINE)
            begin = int(nl[0]) + 1 if nl.size else size
        return buf, size, begin
    buf = torch.empty(padded, dtype=torch.uint8, device=device)
    fd = os.open(path, os.O_RDONLY)
    pending: deque = deque()
    try:
        offsets = iter(range(0, size, READ_CHUNK_BYTES))

        def submit() -> None:
            off = next(offsets, None)
            if off is None:
                return
            host = torch.empty(min(READ_CHUNK_BYTES, size - off),
                               dtype=torch.uint8, pin_memory=True)
            pending.append((off, host, _reader().submit(
                _read_into, fd, host.numpy(), off)))

        for _ in range(READ_THREADS + 2):
            submit()
        header_open = has_header
        while pending:
            check_cancel()  # a cancelled collect stops between chunks
            off, host, fut = pending.popleft()
            with hostclock.charged(hostclock.POOL_WAIT):
                fut.result()
            if header_open:
                # a pinned host buffer, no device value
                # ballista: ignore[sync-span]
                nl = np.flatnonzero(host.numpy() == tbl_parse.NEWLINE)
                if nl.size:
                    begin, header_open = off + int(nl[0]) + 1, False
            buf[off:off + host.numel()].copy_(host, non_blocking=True)
            del host
            submit()
        if header_open:
            begin = size
    finally:
        for _, _, fut in pending:
            fut.cancel()
        for _, _, fut in pending:
            if not fut.cancelled():
                fut.exception()  # wait: the read writes into its buffer
        os.close(fd)
    return buf, size, begin


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
        # dictionary-registry entry of this table's files (the JAX
        # package's key, so the stamps its shuffle files carry agree)
        from .. import columnar_registry

        self._dict_key_base = columnar_registry.file_entry_key(
            "text", path, self._files)
        # cached batches' dictionaries known equal in value to this
        # source's: id -> (theirs, ours), holding both alive
        self._equal_dicts: Dict[int, tuple] = {}
        # column -> (dictionary, its values' bytes), for the card's path
        self._dict_bytes: Dict[str, tuple] = {}
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

    def source_descriptor(self) -> dict:
        return {
            "kind": "tbl" if self._delim == "|" else "csv",
            "path": self._path,
            "delimiter": self._delim,
            "has_header": self._header,
        }

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

    def scan_path(self, partition: int,
                  names: Sequence[str]) -> Optional[str]:
        """None when the scan of ``names`` in ``partition`` parses on the
        card, else why it parses on the host: ``cpu_device``,
        ``streamed_file`` or ``float_column``."""
        from .native import _KIND_CODES

        if self.device.type != "cuda":
            return "cpu_device"
        if self._streams(partition):
            return "streamed_file"
        if any(_KIND_CODES[self._schema.field(m).dtype.kind]
               not in tbl_parse.KINDS_ON_CARD for m in names):
            return "float_column"
        return None

    def _interned(self, colname: str, values) -> Dictionary:
        """The registry's dictionary of this table's ``colname`` (a
        sibling source over the same files may have interned it)."""
        from .. import columnar_registry

        key = self._dict_key_base + (colname,)
        d = columnar_registry.REGISTRY.lookup(key)
        return d if d is not None else columnar_registry.intern(key, values)

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
                        # a cancelled collect stops the pre-pass at a
                        # range boundary (nothing is kept half-built)
                        check_cancel()
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
                    self._dicts[n] = self._interned(n, vals.astype(object))
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
        names = list(projection if projection is not None
                     else self._schema.names())
        sub_schema = self._schema.project(names)
        reason = self.scan_path(partition, names)
        if reason is None:
            count("scans_on_card")
            yield from self._scan_on_card(partition, names, sub_schema)
            return
        count("scans_on_host")
        count("scans_on_host." + reason)
        streamed = self._streams(partition)
        emitted = False
        for n, arrays, dicts, valids in self.parsed(partition, names):
            # a streamed range's tail batch is emitted partial, on the
            # ladder
            yield from self._emit_batches(sub_schema, n, arrays, dicts,
                                          valids, force_emit=not streamed)
            emitted = True
        if not emitted:  # empty file: one empty batch keeps contracts
            utf8 = [m for m in names
                    if self._schema.field(m).dtype.kind == "utf8"]
            yield from self._emit_batches(sub_schema, 0, {
                m: np.zeros(0, self._schema.field(m).dtype.device_dtype())
                for m in names}, self._table_dictionaries(utf8), None)

    def _scan_on_card(self, partition: int, names: List[str], sub_schema):
        """Parse one partition file on the card (see the module doc) and
        yield its batches: the same ladder capacities, columns, validity
        and dictionary objects as the host path's, as slices of the
        parsed device columns."""
        from .native import _KIND_CODES

        path = self._files[partition]
        dev = self.device
        stream = upload_stream(dev)
        fields = self._schema.fields
        cap = self._capacity

        def rows_allocated(n: int) -> int:  # whole batches on the ladder
            nonlocal cap
            cap = min(self._capacity, bucket_capacity(max(n, 1)))
            return -(-max(n, 1) // cap) * cap

        check_cancel()
        with torch.cuda.stream(stream) if stream is not None \
                else nullcontext():
            with phase("h2d", path=path):
                data, size, begin = stage_text(path, dev, self._header)
            with phase("parse", path=path):
                parsed = tbl_parse.parse(
                    data, size, begin, ord(self._delim),
                    [_KIND_CODES[f.dtype.kind] for f in fields],
                    [f.dtype.scale for f in fields],
                    [self._schema.index_of(m) for m in names],
                    rows_allocated, label=path)
                del data
                dicts = self._card_dictionaries(names, parsed)
                n = parsed.rows
                batches = []
                for lo in range(0, max(n, 1), cap):
                    check_cancel()
                    rows = min(cap, n - lo)
                    cols = [Column(v[lo:lo + cap], f.dtype,
                                   None if va is None else va[lo:lo + cap],
                                   dicts.get(f.name))
                            for f, v, va in zip(sub_schema.fields,
                                                parsed.values,
                                                parsed.validity)]
                    batches.append(ColumnBatch(
                        sub_schema, cols,
                        torch.arange(cap, device=dev) < rows,
                        torch.full((), rows, dtype=torch.int32, device=dev)))
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
                    # one attribute a batch; the loop that yields them
                    # carries the cancel check
                    # ballista: ignore[cancel-coverage]
                    for b in batches:
                        b._upload_event = (event, set())
                if dev.type == "cuda":
                    with trace_span("device.block", site="scan.parse_on_card"):
                        torch.cuda.current_stream(dev).synchronize()
        count("device_parsed_bytes", size)
        count("hash_collisions", parsed.hash_collisions)
        for batch in batches:
            check_cancel()
            yield batch

    def _card_dictionaries(self, names: List[str],
                           parsed) -> Dict[str, Dictionary]:
        """The dictionaries of the card's parse of one file, as
        ``parsed`` gives them: adopted as the table's for a single-file
        table, else the table-wide ones of ``_table_dictionaries``; codes
        are remapped on the card unless this file's sorted values are
        the dictionary's, byte for byte."""
        utf8 = [(j, m) for j, m in enumerate(names)
                if self._schema.field(m).dtype.kind == "utf8"]
        if not utf8:
            return {}
        if len(self._files) > 1:
            dicts = self._table_dictionaries([m for _, m in utf8])
        else:
            with self._dict_lock:
                for j, m in utf8:
                    if m not in self._dicts:
                        self._dicts[m] = self._interned(
                            m, parsed.dictionaries[j].strings())
                dicts = {m: self._dicts[m] for _, m in utf8}
        for j, m in utf8:
            sv = parsed.dictionaries[j]
            if not sv.same_as(self._dictionary_bytes(m, dicts[m])):
                remap = torch.from_numpy(dicts[m].positions_of(
                    sv.strings())).to(self.device)
                codes = parsed.values[j]
                codes[:parsed.rows] = remap[codes[:parsed.rows].long()]
        return dicts

    def _dictionary_bytes(self, name: str,
                          d: Dictionary) -> "tbl_parse.SortedValues":
        """``d``'s values as UTF-8 bytes and offsets, kept per column
        while ``d`` is the dictionary in use."""
        with self._dict_lock:
            known = self._dict_bytes.get(name)
            if known is None or known[0] is not d:
                known = self._dict_bytes[name] = (
                    d, tbl_parse.SortedValues.of(d.values))
            return known[1]

    def parsed(self, partition: int, names: Sequence[str]):
        """The host side of one partition's scan: ``(rows, physical
        arrays, dictionaries, validity masks)`` of ``names``, with utf8
        codes on the table's dictionaries. One tuple for the whole file,
        or, for a file over ``STREAM_CHUNK_BYTES``, one for each byte
        range that holds rows (``_parsed_ranges``)."""
        from . import native

        names = list(names)
        if self._streams(partition):
            yield from self._parsed_ranges(partition, names)
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
                            self._dicts[m] = self._interned(m, fdicts[m])
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
        yield n, arrays, dicts, valids

    def _parsed_ranges(self, partition: int, names):
        """Parse one partition file in byte-range chunks (adjacent ranges
        partition the rows exactly) and remap each range's utf8 codes onto
        the table-wide dictionaries (one shared pre-pass), yielding each
        range as soon as it is parsed. Peak RAM is
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
        while off < size:
            check_cancel()  # a cancelled collect stops at a range boundary
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
            yield n, arrays, dicts, valids

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
