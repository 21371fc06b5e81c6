"""Columnar IPC persistence for shuffle partitions and result fetch.

The port of the JAX package's ``io/ipc.py``: the files are the same bytes
(tests read the port's files with the JAX package and the reverse).
Writes compact a batch on the card to host rows (one device-to-host copy
of the selection and of each column, per call); reads build batches on
the reader's device through ``ColumnBatch.from_numpy`` (pinned
asynchronous uploads; on a card under ``side_stream_uploads`` when the
caller binds it).

Equivalent of the reference's Arrow-IPC shuffle materialization
(reference: rust/core/src/utils.rs:49-84 ``write_stream_to_disk`` +
executor FetchPartition serving at rust/executor/src/flight_service.rs:
193-228). Files are Arrow IPC (pyarrow); the engine's physical column
representations map to Arrow as:

- decimal(s)  -> int64 + field metadata ballista.kind=decimal/scale
- date32      -> int32 + metadata
- utf8        -> Arrow dictionary<int32, utf8> (codes survive verbatim)

Rows are COMPACTED to the live selection before writing, so shuffle files
carry no padding. Readers get physical arrays back plus per-file
dictionaries; ``unify_dictionaries`` merges multiple producers' codes into
one table-wide dictionary via searchsorted remapping (no per-row decode).

Streaming layout: writers emit Arrow IPC **stream**
format with record batches bounded to ``BALLISTA_SHUFFLE_CHUNK_BYTES``
(:class:`PartitionWriter`), so the data plane can serve and readers can
decode partitions chunk-by-chunk without whole-partition buffering.
Readers sniff the format (``ARROW1`` magic = legacy file format) so
both layouts stay readable.
"""

from __future__ import annotations

import io as _io
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..columnar import ColumnBatch, DeviceLike, Dictionary
from ..compile import bucket_capacity
from ..datatypes import Schema
from ..errors import IoError

ARROW_FILE_MAGIC = b"ARROW1"


_POOL_CHECKED = False


def _arrow():
    import pyarrow as pa

    global _POOL_CHECKED
    if not _POOL_CHECKED:
        _POOL_CHECKED = True
        # mimalloc (pyarrow's default pool) intermittently corrupts under
        # this engine's thread mix (see the package's __init__.py). The env
        # selector set there is inert on builds without jemalloc, so
        # verify at first use and degrade to the system allocator — but
        # only when the pool choice was OURS: a user's explicit
        # ARROW_DEFAULT_MEMORY_POOL always wins.
        # ours only when the env still holds the exact value we recorded
        # at set time: the marker is inherited by child processes, where
        # a user's explicit ARROW_DEFAULT_MEMORY_POOL must win even
        # though the marker is present
        user_chose = (
            "ARROW_DEFAULT_MEMORY_POOL" in os.environ
            and os.environ["ARROW_DEFAULT_MEMORY_POOL"]
            != os.environ.get("_BALLISTA_SET_ARROW_POOL")
        )
        try:
            if (not user_chose
                    and pa.default_memory_pool().backend_name == "mimalloc"
                    and not os.environ.get("BALLISTA_ALLOW_MIMALLOC")):
                pa.set_memory_pool(pa.system_memory_pool())
        except Exception:  # noqa: BLE001 - keep whatever pool exists
            pass
    return pa


def batch_to_arrow(batch: ColumnBatch):
    """Compact a ColumnBatch to a pyarrow RecordBatch (live rows only).

    On a card each fetch is one device-to-host copy of a whole column
    (its full capacity); rows are compacted on the host. Every D2H fetch (selection, then each column's buffers) runs under
    a ``device.block`` span, so shuffle-write sync time lands in the
    profiler's ``device_blocked`` lane instead of hiding inside the
    write lane. Fetches stay per-column (not one batched hoist): at
    most ONE full-capacity host copy is live beside the masked
    outputs, the pre-span memory shape."""
    pa = _arrow()
    from ..observability.tracing import trace_span

    with trace_span("device.block", site="ipc.batch_to_arrow"):
        mask = batch.selection.cpu().numpy()
    arrays = []
    fields = []
    # bounded per-batch column conversion; the chunk loop in
    # write_arrow carries the cancel check
    # ballista: ignore[cancel-coverage]
    for f, col in zip(batch.schema.fields, batch.columns):
        with trace_span("device.block", site="ipc.batch_to_arrow",
                        col=f.name):
            hv = col.values.cpu().numpy()
            hval = (None if col.validity is None
                    else col.validity.cpu().numpy())
        vals = hv[mask]
        del hv
        nulls = None
        if hval is not None:
            nulls = ~hval[mask]
        del hval
        meta = {b"ballista.kind": f.dtype.kind.encode(),
                b"ballista.scale": str(f.dtype.scale).encode()}
        if f.dtype.kind == "utf8":
            if col.dictionary is None:
                raise IoError(f"utf8 column {f.name} without dictionary")
            # registry stamp (entry:version:epoch): a reader in this or
            # any sibling process resolves the SAME interned instance
            # instead of re-hydrating values from the wire
            from .. import columnar_registry

            stamp = columnar_registry.REGISTRY.stamp_of(col.dictionary)
            if stamp is not None:
                meta[b"ballista.dict"] = stamp.encode()
            codes = pa.array(vals.astype(np.int32), mask=nulls)
            dict_vals = pa.array(
                [str(v) for v in col.dictionary.values], type=pa.string()
            )
            arr = pa.DictionaryArray.from_arrays(codes, dict_vals)
            fields.append(pa.field(f.name, arr.type, True, meta))
        elif f.dtype.kind == "list":
            # fixed-size list: (rows, length) physical array -> real Arrow
            # FixedSizeListArray (element kind/scale ride in metadata so
            # decimal elements decode without Arrow decimal types)
            meta[b"ballista.element_kind"] = f.dtype.element.kind.encode()
            meta[b"ballista.element_scale"] = str(
                f.dtype.element.scale).encode()
            flat = pa.array(vals.reshape(-1))
            # the mask as an Arrow array: pyarrow refuses a numpy mask
            # here (the JAX package passes numpy and cannot write a
            # fixed-size list with NULLs)
            arr = pa.FixedSizeListArray.from_arrays(
                flat, f.dtype.length,
                mask=None if nulls is None else pa.array(nulls, pa.bool_()))
            fields.append(pa.field(f.name, arr.type, True, meta))
        else:
            arr = pa.array(vals, mask=nulls)
            fields.append(pa.field(f.name, arr.type, True, meta))
        arrays.append(arr)
    return pa.record_batch(arrays, schema=pa.schema(fields))


def _iter_chunked(rb, chunk_bytes: int):
    """Split one Arrow record batch into row slices of at most
    ``chunk_bytes`` (estimated from the batch's mean bytes/row). Slices
    share the parent's buffers; the IPC writer truncates them to the
    slice window on write, so the file carries bounded record batches."""
    n = rb.num_rows
    if n == 0 or rb.nbytes <= chunk_bytes:
        yield rb
        return
    rows = max(int(chunk_bytes / max(rb.nbytes / n, 1e-9)), 1)
    for lo in range(0, n, rows):
        yield rb.slice(lo, min(rows, n - lo))


class _ColumnStatsAcc:
    """Incremental per-column {null_count, distinct_count, min, max}
    accumulator — the streaming replacement for the old whole-table
    stats pass (reference declares ColumnStats but never fills it,
    ballista.proto:478-485). min/max merge per record batch via
    pyarrow's vectorized kernels; distinct_count stays exact for
    dictionary columns by unioning the OBSERVED code sets (codes map
    1:1 to values within one dictionary), and degrades to -1 when a
    stream carries replacement dictionaries."""

    def __init__(self):
        self._cols: Optional[Dict[str, dict]] = None

    def update(self, rb) -> None:
        pa = _arrow()
        import pyarrow.compute as pc

        if self._cols is None:
            self._cols = {
                name: {"null": 0, "min": None, "max": None,
                       "codes": set(), "first_dict": None, "multi": False}
                for name in rb.schema.names
            }
        # bounded per-record-batch stats merge; callers' chunk loops
        # carry the cancel check
        # ballista: ignore[cancel-coverage]
        for i, name in enumerate(rb.schema.names):
            st = self._cols[name]
            col = rb.column(i)
            st["null"] += int(col.null_count)
            try:
                typ = col.type
                if pa.types.is_dictionary(typ):
                    if st["first_dict"] is None:
                        st["first_dict"] = col.dictionary
                    elif not st["multi"] and not (
                            col.dictionary is st["first_dict"]
                            or col.dictionary.equals(st["first_dict"])):
                        st["multi"] = True
                    if not st["multi"]:
                        st["codes"].update(
                            pc.unique(col.indices.drop_null()).to_pylist())
                    mm = pc.min_max(col.cast(typ.value_type))
                else:
                    st["codes"] = None
                    mm = pc.min_max(col)
                mn, mx = mm["min"].as_py(), mm["max"].as_py()
                if mn is not None:
                    mn, mx = _norm_stat(mn), _norm_stat(mx)
                    st["min"] = mn if st["min"] is None else min(st["min"], mn)
                    st["max"] = mx if st["max"] is None else max(st["max"], mx)
            except Exception:  # noqa: BLE001 - stats stay partial
                pass

    def rows(self) -> List[Dict]:
        out: List[Dict] = []
        for name, st in (self._cols or {}).items():
            entry: Dict = {"name": name, "null_count": st["null"],
                           "distinct_count": -1}
            if st["codes"] is not None and not st["multi"]:
                entry["distinct_count"] = len(st["codes"])
            if st["min"] is not None:
                entry["min"] = st["min"]
                entry["max"] = st["max"]
            out.append(entry)
        return out


class PartitionWriter:
    """Incremental Arrow-IPC STREAM writer for partition/shuffle files.

    The streaming replacement for materialize-then-write: callers push
    ColumnBatches as the plan produces them and each is converted,
    sliced to at most ``BALLISTA_SHUFFLE_CHUNK_BYTES`` record batches
    and written immediately — peak host memory is one chunk, not one
    partition. Every chunk write checks the thread's cancel token (a
    fired ``ctx.cancel()``/deadline aborts a multi-GB write mid-file)
    and charges the shuffle memory governor transiently so the
    in-flight gauge covers the write side too.

    tmp+rename semantics are preserved: concurrent writers of the same
    deterministic path (e.g. a speculative duplicate task) can never
    leave a half-written file visible to a fetching consumer. ``close``
    on a writer that saw no batches synthesizes one empty record batch
    from ``schema`` (or raises when none was given), matching the old
    empty-partition file shape."""

    def __init__(self, path: str, schema: Optional[Schema] = None,
                 chunk_bytes: Optional[int] = None,
                 compute_column_stats: bool = False):
        from ..distributed import spill as _spill

        self._pa = _arrow()
        self.path = path
        self._schema = schema
        self._chunk_bytes = chunk_bytes or _spill.shuffle_chunk_bytes()
        self._stats = _ColumnStatsAcc() if compute_column_stats else None
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        self._sink = None
        self._writer = None
        self.num_rows = 0
        self.num_batches = 0
        self.write_seconds = 0.0
        self._done = False

    def write_batch(self, batch: ColumnBatch) -> None:
        self.write_arrow(batch_to_arrow(batch))

    def write_arrow(self, rb) -> None:
        from ..distributed import spill as _spill
        from ..lifecycle import check_cancel

        gov = _spill.governor()
        for piece in _iter_chunked(rb, self._chunk_bytes):
            # chunk-level cancellation: deadlines/ctx.cancel() abort
            # inside a large partition write, not after it
            check_cancel()
            nbytes = int(piece.nbytes)
            gov.charge(nbytes)
            try:
                t0 = time.perf_counter()
                if self._writer is None:
                    self._sink = self._pa.OSFile(self._tmp, "wb")
                    self._writer = self._pa.ipc.new_stream(
                        self._sink, piece.schema)
                self._writer.write_batch(piece)
                self.write_seconds += time.perf_counter() - t0
            finally:
                gov.release(nbytes)
            self.num_batches += 1
            self.num_rows += piece.num_rows
            if self._stats is not None:
                self._stats.update(piece)

    def close(self) -> Dict[str, int]:
        if self._done:
            raise IoError(f"partition writer already closed: {self.path}")
        if self._writer is None:
            if self._schema is None:
                raise IoError("no batches to write")
            from ..columnar import empty_batch

            self.write_batch(empty_batch(self._schema, "cpu"))
        try:
            self._writer.close()
            self._sink.close()
            os.replace(self._tmp, self.path)
        except BaseException:
            self.abort()
            raise
        self._done = True
        out = {
            "num_rows": self.num_rows,
            "num_batches": self.num_batches,
            "num_bytes": os.path.getsize(self.path),
        }
        if self._stats is not None:
            out["columns"] = self._stats.rows()
        return out

    def abort(self) -> None:
        """Best-effort cleanup for failed writes: close handles, drop
        the tmp file (idempotent)."""
        self._done = True
        for h in (self._writer, self._sink):
            try:
                if h is not None:
                    h.close()
            except Exception:  # noqa: BLE001 - already broken
                pass
        try:
            os.unlink(self._tmp)
        except OSError:
            pass


def write_partition(path: str, batches: List[ColumnBatch],
                    compute_column_stats: bool = True) -> Dict[str, int]:
    """Write batches to an Arrow IPC stream file; returns PartitionStats
    dict (reference: PartitionStats {num_rows, num_batches, num_bytes},
    ballista.proto:478-485) plus per-column selectivity stats unless
    ``compute_column_stats`` is off (the n_out-way shuffle write path
    turns it off: per-file column stats there have no consumer and a
    64-way shuffle would pay 64 stat passes per task). Thin list-based
    wrapper over :class:`PartitionWriter`."""
    from ..lifecycle import check_cancel

    w = PartitionWriter(path, compute_column_stats=compute_column_stats)
    try:
        for b in batches:
            # batch-level cancellation on top of write_arrow's
            # chunk-level checks (w is dynamic, so the analyzer cannot
            # follow the call)
            check_cancel()
            w.write_batch(b)
        return w.close()
    except BaseException:
        w.abort()
        raise


def _norm_stat(v):
    """Normalize a pyarrow .as_py() scalar to the physical repr the
    proto carries (dates -> epoch days)."""
    import datetime as _dt

    if isinstance(v, _dt.datetime):
        v = v.date()
    if isinstance(v, _dt.date):
        return (v - _dt.date(1970, 1, 1)).days
    return v


def decode_fixed_size_list(chunk) -> np.ndarray:
    """FixedSizeListArray chunk -> (rows, width) ndarray of flat values.

    ``.values`` spans all slots (incl. null rows), so the reshape stays
    aligned with the row axis — but it ignores a slice offset on the
    chunk (an Arrow slice adjusts offset/length only, the child stays
    whole), so slice the flat child to this chunk's window first.
    In-repo IPC files always arrive unsliced (serialization materializes
    slices); the offset handling protects direct/zero-copy producers.
    """
    width = chunk.type.list_size
    flat = chunk.values.to_numpy(zero_copy_only=False)
    off = chunk.offset
    flat = flat[off * width:(off + len(chunk)) * width]
    return flat.reshape(len(chunk), width)


class _ChunkStream(_io.RawIOBase):
    """File-like adapter over an iterator of byte chunks — lets
    pyarrow's stream reader pull wire/spill chunks on demand, so decode
    consumes the transfer incrementally instead of requiring one
    contiguous whole-partition buffer."""

    def __init__(self, chunks: Iterable[bytes]):
        self._it = iter(chunks)
        self._buf = b""
        self._eof = False

    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            parts = [self._buf] + list(self._it)
            self._buf = b""
            self._eof = True
            return b"".join(parts)
        while len(self._buf) < n and not self._eof:
            try:
                self._buf += next(self._it)
            except StopIteration:
                self._eof = True
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


def open_arrow_reader(source):
    """Open an Arrow IPC source (path, bytes, or file-like) in either
    layout: legacy random-access FILE format (``ARROW1`` magic) or the
    streaming STREAM format the chunked shuffle writers emit. Returns a
    pyarrow reader exposing ``schema`` / ``read_all()`` /
    ``read_next_batch()``."""
    pa = _arrow()
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as fh:
            head = fh.read(len(ARROW_FILE_MAGIC))
        src = pa.memory_map(str(source), "r")
    elif isinstance(source, (bytes, bytearray, memoryview)):
        head = bytes(source[:len(ARROW_FILE_MAGIC)])
        src = pa.BufferReader(source)
    else:  # file-like: stream format only (no seekable magic check)
        return pa.ipc.open_stream(source)
    if head == ARROW_FILE_MAGIC:
        return pa.ipc.open_file(src)
    return pa.ipc.open_stream(src)


def read_partition_arrays(
    path_or_buf,
) -> Tuple[List[str], Dict[str, np.ndarray], Dict[str, np.ndarray],
           Dict[str, np.ndarray], Dict[str, Tuple[str, int]]]:
    """Read an IPC partition -> (names, arrays, null_masks, dictionaries,
    kinds).

    arrays hold PHYSICAL values (codes for utf8); dictionaries map colname ->
    np object array for utf8 columns; kinds map colname -> (kind, scale).
    Accepts both IPC layouts (see :func:`open_arrow_reader`); decode is
    incremental per record batch, so a memory-mapped stream file never
    materializes its wire bytes as one blob.
    """
    return _decode_reader(open_arrow_reader(path_or_buf))


def read_partition_arrays_from_chunks(chunks: Iterable[bytes]):
    """Incremental variant of :func:`read_partition_arrays` fed by an
    iterator of stream-format byte chunks (the flow-controlled data
    plane fetch, or a ChunkBuffer replay spanning RAM + spill files).
    Chunks are pulled — and can be released by the producer — as the
    decoder advances; a truncated stream raises pyarrow's invalid-IPC
    error, which shuffle readers tag into ShuffleFetchError."""
    pa = _arrow()
    return _decode_reader(pa.ipc.open_stream(_ChunkStream(chunks)))


def _batch_iter(reader):
    from ..lifecycle import check_cancel

    if hasattr(reader, "num_record_batches"):  # legacy FILE format
        for i in range(reader.num_record_batches):
            # per-record-batch cancellation at the producer, so every
            # consumer of this iterator inherits it
            check_cancel()
            yield reader.get_batch(i)
        return
    while True:
        check_cancel()
        try:
            rb = reader.read_next_batch()
        except StopIteration:
            return
        yield rb


def _decode_reader(reader):
    """Shared incremental decode core: accumulate per-record-batch
    numpy pieces (checking the thread's cancel token at every batch
    boundary) and concatenate once — peak host memory is the decoded
    arrays plus ONE batch's wire window, never decoded + whole blob."""
    pa = _arrow()
    from ..lifecycle import check_cancel

    schema = reader.schema
    names = list(schema.names)
    metas = [schema.field(i).metadata or {} for i in range(len(names))]
    pieces: Dict[str, List[np.ndarray]] = {n: [] for n in names}
    null_pieces: Dict[str, List[np.ndarray]] = {n: [] for n in names}
    # utf8 columns: per-batch (codes, dictionary) with replacement
    # detection — a stream is allowed to swap dictionaries mid-flight
    dict_state: Dict[str, dict] = {}
    n_batches = 0
    for rb in _batch_iter(reader):
        # chunk-level cancellation: ctx.cancel()/deadlines abort
        # mid-partition decodes (local mmap reads included)
        check_cancel()
        n_batches += 1
        for i, name in enumerate(names):
            col = rb.column(i)
            if pa.types.is_dictionary(col.type):
                codes = col.indices.to_numpy(
                    zero_copy_only=False).astype(np.int32)
                nm = np.asarray(col.indices.is_null())
                st = dict_state.setdefault(
                    name, {"first": col.dictionary, "multi": False,
                           "parts": []})
                if not st["multi"] and not (
                        col.dictionary is st["first"]
                        or col.dictionary.equals(st["first"])):
                    st["multi"] = True
                zeroed = np.where(nm, 0, codes).astype(np.int32)
                # dict columns assemble from st["parts"] alone (see
                # _finish_dict_column); pieces[name] stays unused
                st["parts"].append((zeroed, col.dictionary))
            elif pa.types.is_fixed_size_list(col.type):
                nm = np.asarray(col.is_null())
                pieces[name].append(decode_fixed_size_list(col))
            else:
                nm = np.asarray(col.is_null())
                if pa.types.is_integer(col.type):
                    # stay in integer domain: to_numpy on a nullable int
                    # array converts to float64, corrupting scaled-
                    # decimal/int64 values above 2^53; fill_null copies,
                    # so only when needed
                    src = col.fill_null(0) if nm.any() else col
                    pieces[name].append(src.to_numpy(zero_copy_only=False))
                else:
                    vals = col.to_numpy(zero_copy_only=False)
                    if nm.any():
                        vals = np.where(nm, 0, np.nan_to_num(vals))
                    pieces[name].append(vals)
            null_pieces[name].append(nm)

    arrays: Dict[str, np.ndarray] = {}
    nulls: Dict[str, np.ndarray] = {}
    dicts: Dict[str, np.ndarray] = {}
    kinds: Dict[str, Tuple[str, int]] = {}
    for i, name in enumerate(names):
        meta = metas[i]
        kind = meta.get(b"ballista.kind", b"").decode() or None
        scale = int(meta.get(b"ballista.scale", b"0") or 0)
        ftype = schema.field(i).type
        if pa.types.is_dictionary(ftype):
            arrays[name], dicts[name] = _finish_dict_column(
                name, dict_state.get(name), meta)
            kinds[name] = ("utf8", 0)
        elif pa.types.is_fixed_size_list(ftype):
            width = ftype.list_size
            edtype = np.dtype(ftype.value_type.to_pandas_dtype())
            arrays[name] = (
                np.concatenate(pieces[name])
                if pieces[name] else np.zeros((0, width), dtype=edtype))
            ekind = (meta.get(b"ballista.element_kind", b"").decode()
                     or str(ftype.value_type))
            escale = int(meta.get(b"ballista.element_scale", b"0") or 0)
            kinds[name] = (f"list:{ekind}", escale)
        else:
            arrays[name] = _concat_pieces(pieces[name], ftype)
            kinds[name] = (kind or str(ftype), scale)
        nps = null_pieces[name]
        nulls[name] = (nps[0] if len(nps) == 1
                       else np.concatenate(nps) if nps
                       else np.zeros(0, dtype=bool))
    return names, arrays, nulls, dicts, kinds


def _concat_pieces(ps: List[np.ndarray], ftype) -> np.ndarray:
    if len(ps) == 1:
        return ps[0]
    if not ps:
        return np.zeros(0, dtype=np.dtype(ftype.to_pandas_dtype()))
    return np.concatenate(ps)


def _finish_dict_column(name: str, st: Optional[dict], meta: dict):
    """Assemble one utf8 column from its per-batch (codes, dictionary)
    pieces. Single-dictionary streams (the writers' contract) resolve
    the registry stamp or adopt the values once, exactly like the old
    whole-table path; replacement dictionaries remap every batch onto
    the registry's sorted union before concatenating."""
    from .. import columnar_registry as _reg

    if st is None or not st["parts"]:
        return np.zeros(0, dtype=np.int32), np.asarray([], dtype=object)
    if st["multi"]:
        parts = [
            (codes, np.asarray(d.to_pylist(), dtype=object))
            for codes, d in st["parts"]
        ]
        unified, remapped = _reg.unify_parts(parts)
        codes = (remapped[0] if len(remapped) == 1
                 else np.concatenate(remapped)).astype(np.int32)
        return codes, unified
    codes_list = [codes for codes, _ in st["parts"]]
    codes = (codes_list[0] if len(codes_list) == 1
             else np.concatenate(codes_list))
    # a registry stamp resolves to the live interned Dictionary
    # (content-verified by epoch) without touching the shipped values;
    # otherwise adopt them once per content epoch so every part/read of
    # equal content shares ONE instance
    stamp = meta.get(b"ballista.dict", b"").decode() or None
    resolved = _reg.REGISTRY.resolve(stamp)
    if resolved is None:
        resolved = _reg.REGISTRY.adopt(
            stamp,
            np.asarray(st["first"].to_pylist(), dtype=object))
    return codes, resolved


def unify_dictionaries(
    parts: List[Tuple[np.ndarray, "Dictionary | np.ndarray"]]
) -> Tuple[Dictionary, List[np.ndarray]]:
    """[(codes, Dictionary-or-raw-values)] from several producers ->
    (shared Dictionary, remapped codes per part). Sorted union keeps
    codes ordinal. Routed through the dictionary registry: producers
    of one table resolve to ONE interned instance (no remap at all),
    version chains remap through cached integer tables, and only
    unregistered content pays a (cached) sorted union."""
    from ..observability.tracing import trace_span
    from .. import columnar_registry

    if not parts:
        return Dictionary([]), []
    with trace_span("host.dictionary", site="ipc.unify", n_parts=len(parts)):
        return columnar_registry.unify_parts(parts)


def batches_from_parts(
    schema: Schema,
    parts: List[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                      Dict[str, np.ndarray]]],
    capacity: Optional[int] = None,
    *,
    device: DeviceLike,
) -> List[ColumnBatch]:
    """Assemble ColumnBatches on ``device`` from several
    read_partition_arrays results (arrays, nulls, dicts per part),
    unioning utf8 dictionaries."""
    from ..observability.memory import track_host_bytes

    if not parts:
        return []
    # shuffle-read host buffers: transient, but the peak matters — the
    # memory plane attributes them separately from scan parse buffers
    shuffle_bytes = sum(
        int(getattr(a, "nbytes", 0))
        for arrays, _nulls, _dicts in parts for a in arrays.values()
    )
    with track_host_bytes("shuffle", shuffle_bytes):
        return _batches_from_parts_inner(schema, parts, capacity, device)


def _batches_from_parts_inner(schema, parts, capacity, device):
    """Each part padded to its bucket capacity and uploaded: live rows
    first, selection and validity masks built from the row count and the
    null masks (``ColumnBatch.from_numpy``)."""
    # union dictionaries per utf8 column — split from batches_from_parts
    # only so the shuffle-byte accounting brackets the whole assembly
    from ..lifecycle import check_cancel

    union_dicts: Dict[str, Dictionary] = {}
    remaps: Dict[str, List[np.ndarray]] = {}
    for f in schema.fields:
        if f.dtype.kind == "utf8":
            pieces = [(p[0][f.name], p[2][f.name]) for p in parts]
            d, remapped = unify_dictionaries(pieces)
            union_dicts[f.name] = d
            remaps[f.name] = remapped
    out = []
    for pi, (arrays, nulls, dicts) in enumerate(parts):
        # per-part cancellation: assembly pads + uploads every part
        # (H2D), real work a fired token must be able to stop
        check_cancel()
        n = len(next(iter(arrays.values()))) if arrays else 0
        # shuffle-read batches enter at canonical ladder capacities:
        # unevenly-sized shuffle partitions share compiled signatures
        cap = capacity or bucket_capacity(max(n, 1))
        host = {}
        validity = {}
        for f in schema.fields:
            host[f.name] = (remaps[f.name][pi] if f.dtype.kind == "utf8"
                            else arrays[f.name])
            nm = nulls.get(f.name)
            if nm is not None and nm.any():
                validity[f.name] = ~nm
        out.append(ColumnBatch.from_numpy(
            schema, host, union_dicts, capacity=cap,
            validity=validity or None, device=device))
    return out
