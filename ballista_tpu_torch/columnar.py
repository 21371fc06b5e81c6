"""Columnar batch substrate: the unit of data flow between operators.

The port of the JAX package's ``columnar.py`` to torch tensors. A batch is
a struct of arrays of *fixed capacity* tensors on one explicit device:

- each column is a dense tensor of length ``capacity`` (padded);
- a boolean ``selection`` mask says which physical rows are live — filters
  only AND into this mask, never compact on device;
- string columns are dictionary codes (int32) + a host-side interned
  ``Dictionary``;
- every tensor of a batch lies on ``batch.device``; nothing moves a batch
  to another device implicitly.

Compaction (dropping dead rows) happens only at host boundaries (collect),
where numpy boolean indexing is cheap.

Uploads (``ColumnBatch.from_numpy`` on a card) stage each column in
pinned host memory, from torch's caching host allocator, and copy it
asynchronously: on the calling thread's current stream, or, inside
``side_stream_uploads()`` (a scan's prefetch producer), on the thread's
own upload stream, with an event the consumer's stream waits on before
the batch's first use (``ColumnBatch.wait_upload``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .compile import bucket_capacity
from .datatypes import DataType, Schema
from .errors import ExecutionError, SchemaError

# Default physical batch capacity (rows), as in the JAX package.
DEFAULT_BATCH_CAPACITY = 1 << 20

# FNV-1a constants (stable_hashes)
_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)

DeviceLike = Union[str, torch.device]


def round_capacity(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= n (>= minimum)."""
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap


_tls = threading.local()


@contextmanager
def side_stream_uploads():
    """Within the block, ``ColumnBatch.from_numpy`` on a card uploads on
    this thread's own upload stream and records an event on it, which
    the batch carries until a consumer waits on it (``wait_upload``).
    Outside it, an upload runs on the thread's current stream, the
    consumer's own, and needs no event."""
    prev = getattr(_tls, "side", False)
    _tls.side = True
    try:
        yield
    finally:
        _tls.side = prev


def _upload_stream(device: torch.device) -> torch.cuda.Stream:
    """This thread's upload stream on ``device`` (one per thread and
    card, made at first use). Torch hands streams out round-robin from a
    small pool per priority; upload streams take the high-priority pool,
    so that no upload stream is ever the governor's side stream (default
    priority), on which a concurrent capture would record the upload
    into its graph instead of running it."""
    streams = getattr(_tls, "streams", None)
    if streams is None:
        streams = _tls.streams = {}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    st = streams.get(index)
    if st is None:
        st = streams[index] = torch.cuda.Stream(device=index, priority=-1)
    return st


_TORCH_DTYPES = {np.dtype(k): v for k, v in (
    (np.bool_, torch.bool), (np.int8, torch.int8), (np.uint8, torch.uint8),
    (np.int16, torch.int16), (np.int32, torch.int32),
    (np.int64, torch.int64), (np.float32, torch.float32),
    (np.float64, torch.float64))}


def _upload(arr: np.ndarray, cap: int, device: torch.device) -> torch.Tensor:
    """Host array -> tensor of ``cap`` rows on ``device`` (zero padding).

    On the CPU the tensor shares the padded array's memory (``arr``'s own
    when it is full, contiguous and writable). On a card the rows are
    written once into a pinned staging buffer of ``cap`` rows from
    torch's caching host allocator, which also pads, and copied with
    ``non_blocking`` on the current stream; the allocator keeps the
    staging block until that copy has run. A failed copy raises, as any
    CUDA call does."""
    n = arr.shape[0]
    if device.type != "cuda":
        if n < cap:
            pad = np.zeros((cap - n,) + arr.shape[1:], dtype=arr.dtype)
            arr = np.concatenate([arr, pad])
        return torch.from_numpy(np.require(arr, requirements=("C", "W")))
    host = torch.empty((cap,) + arr.shape[1:], dtype=_TORCH_DTYPES[arr.dtype],
                       pin_memory=True)
    view = host.numpy()
    view[:n] = arr
    view[n:] = 0
    return host.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# Dictionary (host-side string table)
# ---------------------------------------------------------------------------


class Dictionary:
    """Interned host-side string table for a dictionary-encoded column.

    Identity-hashed: two scans of the same file share one instance.
    Comparison kernels assume the values are sorted and duplicate-free.
    """

    __slots__ = ("values", "_index", "_str_cache", "_hash_cache")

    def __init__(self, values: Sequence[str]):
        self.values: np.ndarray = np.asarray(list(values), dtype=object)
        self._index: Dict[str, int] = {v: i for i, v in enumerate(self.values)}
        self._str_cache: Optional[np.ndarray] = None
        self._hash_cache: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, s: str) -> int:
        """Code for string s, or -1 if absent (comparison can short-circuit)."""
        return self._index.get(s, -1)

    @staticmethod
    def encode(strings: Sequence[str]) -> Tuple["Dictionary", np.ndarray]:
        uniq, codes = np.unique(np.asarray(strings, dtype=object),
                                return_inverse=True)
        return Dictionary(uniq), codes.astype(np.int32)

    def values_str(self) -> np.ndarray:
        """Fixed-width ``np.str_`` view of the (sorted) values, cached."""
        if self._str_cache is None:
            self._str_cache = self.values.astype(str)
        return self._str_cache

    def positions_of(self, values) -> np.ndarray:
        """int32 code per value via one sorted search over the str view
        (absent values get their insertion position)."""
        vals = np.asarray(values)
        if vals.dtype.kind != "U":
            vals = vals.astype(str)
        return np.searchsorted(self.values_str(), vals).astype(np.int32)

    def code_range(self, s: str) -> Tuple[int, int]:
        """(left, right) insertion bounds of ``s`` in code space — string
        ordering predicates compile to code comparisons against these."""
        sv = self.values_str()
        return (int(np.searchsorted(sv, s, side="left")),
                int(np.searchsorted(sv, s, side="right")))

    def stable_hashes(self) -> np.ndarray:
        """int64 FNV-1a hash of each value's UTF-8 bytes, cached. Stable
        across processes and dictionary encodings, so hash partitioning of
        a utf8 column places a string where the JAX package places it,
        whatever its code. Values are hashed byte position by byte
        position over all values at once; values whose trailing NULs the
        fixed-width str view drops hash through the scalar loop."""
        if self._hash_cache is not None:
            return self._hash_cache
        n = len(self.values)
        h = np.full(n, _FNV_OFFSET, dtype=np.uint64)
        sv = self.values_str()
        if n:
            enc = np.char.encode(sv, "utf-8")
            width = enc.dtype.itemsize
            if width:
                mat = enc.view(np.uint8).reshape(n, width)
                nz = mat != 0
                lengths = np.where(nz.any(axis=1),
                                   width - np.argmax(nz[:, ::-1], axis=1), 0)
                for j in range(width):
                    h = np.where(j < lengths, (h ^ mat[:, j]) * _FNV_PRIME, h)
        out = h.astype(np.int64)
        lens = np.fromiter((len(str(v)) for v in self.values),
                           dtype=np.int64, count=n)
        for i in np.nonzero(lens != np.char.str_len(sv))[0]:
            hh = 0xCBF29CE484222325
            for b in str(self.values[i]).encode("utf-8"):
                hh = ((hh ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
            out[i] = np.int64(np.uint64(hh))
        self._hash_cache = out
        return out

    @staticmethod
    def canonicalize(values: Sequence[str]) -> Tuple["Dictionary", np.ndarray]:
        """Sorted-unique dictionary + old-code -> new-code remap table."""
        uniq, remap = np.unique(np.asarray(values, dtype=object),
                                return_inverse=True)
        return Dictionary(uniq), remap.astype(np.int32)

    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other) -> bool:
        return self is other

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Dictionary({len(self)} values)"


def remap_between(src: Dictionary, dst: Dictionary) -> Optional[np.ndarray]:
    """int32 table: ``src`` codes -> ``dst`` codes, -1 where a value is
    absent from ``dst``; None when the two are one dictionary. Exact: one
    sorted search of ``src``'s values in ``dst``'s (both sorted). The
    port's own stand-in for the JAX package's dictionary registry remap,
    computed on the host once per pair by its caller."""
    if src is dst:
        return None
    sv, dv = src.values_str(), dst.values_str()
    if len(dv) == 0:
        return np.full(max(len(sv), 1), -1, np.int32)
    idx = np.minimum(np.searchsorted(dv, sv), len(dv) - 1)
    return np.where(dv[idx] == sv, idx, -1).astype(np.int32)


# ---------------------------------------------------------------------------
# Column
# ---------------------------------------------------------------------------


@dataclass
class Column:
    """One physical column: device values + optional validity + dtype."""

    values: torch.Tensor  # [capacity] (or [capacity, length] for lists)
    dtype: DataType
    validity: Optional[torch.Tensor] = None  # bool [capacity]; None = all valid
    dictionary: Optional[Dictionary] = None  # only for Utf8

    @property
    def capacity(self) -> int:
        return int(self.values.shape[0])


# ---------------------------------------------------------------------------
# ColumnBatch
# ---------------------------------------------------------------------------


class ColumnBatch:
    """Fixed-capacity columnar batch on one device.

    ``selection`` is the live-row mask (False for filtered-out rows AND for
    padding beyond the logical row count). ``num_rows`` is an int32 0-d
    tensor on the batch's device with the count of live rows (kept
    consistent with ``selection`` by constructors; operators that filter
    must update both), so reading it never forces a device sync.
    """

    __slots__ = ("schema", "_columns", "_selection", "num_rows",
                 "_transient", "_upload_event")

    def __init__(
        self,
        schema: Schema,
        columns: Sequence[Column],
        selection: torch.Tensor,
        num_rows: torch.Tensor,
    ):
        self.schema = schema
        self._columns: Optional[Tuple[Column, ...]] = tuple(columns)
        self._selection: Optional[torch.Tensor] = selection
        self.num_rows = num_rows
        # single-owner mark (cache/donation.py)
        self._transient = False
        # (event, streams that waited on it) of an upload on a side stream
        self._upload_event = None
        if len(self._columns) != len(schema):
            raise SchemaError(
                f"schema has {len(schema)} fields but "
                f"{len(self._columns)} columns given"
            )

    @property
    def columns(self) -> Tuple[Column, ...]:
        cols = self._columns
        if cols is None:
            raise ExecutionError(
                "read of a donated batch: its tensors went to the one "
                "program that consumed it (cache/donation.py)")
        return cols

    @property
    def selection(self) -> torch.Tensor:
        sel = self._selection
        if sel is None:
            raise ExecutionError(
                "read of a donated batch: its tensors went to the one "
                "program that consumed it (cache/donation.py)")
        return sel

    # -- donation and uploads ----------------------------------------------

    def payload_nbytes(self) -> int:
        """Bytes of the columns and the selection: what a donation gives
        up (``num_rows`` is never donated)."""
        n = self.selection.numel() * self.selection.element_size()
        for c in self.columns:
            n += c.values.numel() * c.values.element_size()
            if c.validity is not None:
                n += c.validity.numel() * c.validity.element_size()
        return n

    def donate(self) -> None:
        """Give up the columns and the selection: a later read raises.
        The caller has claimed the batch with
        ``cache.donation.consume_transient``."""
        self._columns = None
        self._selection = None

    @property
    def donated(self) -> bool:
        return self._columns is None

    def wait_upload(self) -> "ColumnBatch":
        """Make the current stream wait for this batch's upload when it
        ran on a producer's upload stream, and mark its tensors as used
        on the current stream (``record_stream``), so the allocator does
        not hand their blocks out again while this stream may still read
        them. A no-op for batches uploaded on the consumer's own stream,
        and on the CPU. Returns the batch."""
        up = self._upload_event
        if up is None:
            return self
        event, streams = up
        cur = torch.cuda.current_stream(self.device)
        if cur.cuda_stream in streams:
            return self
        cur.wait_event(event)
        for c in self.columns:
            c.values.record_stream(cur)
            if c.validity is not None:
                c.validity.record_stream(cur)
        self.selection.record_stream(cur)
        self.num_rows.record_stream(cur)
        streams.add(cur.cuda_stream)
        return self

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_numpy(
        schema: Schema,
        arrays: Dict[str, np.ndarray],
        dictionaries: Optional[Dict[str, Dictionary]] = None,
        capacity: Optional[int] = None,
        validity: Optional[Dict[str, np.ndarray]] = None,
        *,
        device: DeviceLike,
    ) -> "ColumnBatch":
        """Build a batch on ``device`` from host arrays of physical values,
        padding to capacity. ``validity`` maps column name -> bool array of
        length n (True = valid); columns absent from it are all-valid.
        On a card the upload is asynchronous (see the module doc)."""
        device = torch.device(device)
        dictionaries = dictionaries or {}
        validity = validity or {}
        n = None
        for name, arr in arrays.items():
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise SchemaError(f"column {name} length {len(arr)} != {n}")
        n = n or 0
        # default capacities land on the canonical bucket ladder
        cap = capacity or bucket_capacity(n)
        if cap < n:
            raise ExecutionError(f"capacity {cap} < rows {n}")
        side = device.type == "cuda" and getattr(_tls, "side", False)
        stream = _upload_stream(device) if side else None
        with torch.cuda.stream(stream) if side else nullcontext():
            cols: List[Column] = []
            for f in schema.fields:
                if f.name not in arrays:
                    raise SchemaError(f"missing column {f.name}")
                arr = np.asarray(arrays[f.name])
                want = f.dtype.device_dtype()
                if arr.dtype != want:
                    arr = arr.astype(want)
                va = validity.get(f.name)
                if va is not None:  # padding rows are not valid
                    va = _upload(np.asarray(va, dtype=np.bool_), cap, device)
                cols.append(Column(_upload(arr, cap, device), f.dtype, va,
                                   dictionaries.get(f.name)))
            batch = ColumnBatch(
                schema, cols,
                torch.arange(cap, device=device) < n,
                torch.full((), n, dtype=torch.int32, device=device),
            )
            if side:
                event = torch.cuda.Event()
                event.record(stream)
                batch._upload_event = (event, set())
        return batch

    @staticmethod
    def from_pydict(
        schema: Schema, data: Dict[str, Sequence],
        capacity: Optional[int] = None, *, device: DeviceLike,
    ) -> "ColumnBatch":
        """Build from logical Python values (strings, floats for decimals...)."""
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
        return ColumnBatch.from_numpy(schema, arrays, dicts, capacity,
                                      device=device)

    # -- info ---------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return int(self.selection.shape[0])

    @property
    def device(self) -> torch.device:
        return self.selection.device

    def column(self, name: str) -> Column:
        return self.columns[self.schema.index_of(name)]

    def with_columns(self, schema: Schema, columns: Sequence[Column]) -> "ColumnBatch":
        out = ColumnBatch(schema, columns, self.selection, self.num_rows)
        # the same tensors, with the same pending upload
        out._upload_event = self._upload_event
        return out

    def with_selection(
        self, selection: torch.Tensor, num_rows: Optional[torch.Tensor] = None
    ) -> "ColumnBatch":
        if num_rows is None:
            num_rows = selection.sum(dtype=torch.int32)
        out = ColumnBatch(self.schema, self.columns, selection, num_rows)
        out._upload_event = self._upload_event
        return out

    # -- host materialization ----------------------------------------------

    def to_pydict(self) -> Dict[str, np.ndarray]:
        """Compact to host: logical values of live rows only."""
        mask = self.selection.cpu().numpy()
        out: Dict[str, np.ndarray] = {}
        for f, col in zip(self.schema.fields, self.columns):
            if f.dtype.kind == "utf8" and col.dictionary is None:
                raise ExecutionError("utf8 column without dictionary")
            v = col.values.cpu().numpy()
            invalid = None
            if col.validity is not None:
                invalid = ~col.validity.cpu().numpy()[mask]
            if f.dtype.kind == "list":
                out[f.name] = decode_list_rows(
                    v[mask], f.dtype.element.kind, f.dtype.element.scale,
                    invalid,
                )
                continue
            out[f.name] = decode_physical_array(
                v[mask], f.dtype.kind, f.dtype.scale,
                col.dictionary.values if col.dictionary is not None else None,
                invalid,
            )
        return out

    def num_rows_host(self) -> int:
        return int(self.num_rows)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"ColumnBatch(cap={self.capacity}, device={self.device}, "
            f"fields={self.schema.names()})"
        )


# ---------------------------------------------------------------------------
# Host-side helpers (identical to the JAX package's)
# ---------------------------------------------------------------------------


def decimal_to_scaled(values, scale: int) -> np.ndarray:
    """float/str decimal values -> scaled int64 using HALF-UP (away from
    zero) rounding — the same rule as the native C++ parser."""
    v = np.asarray(values, dtype=np.float64) * (10 ** scale)
    return (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(np.int64)


def decode_physical_array(
    vals: np.ndarray,
    kind: str,
    scale: int = 0,
    dictionary_values: Optional[np.ndarray] = None,
    null_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Physical array -> logical host values, applying SQL NULL conventions
    (None for strings, NaT for dates, NaN for numerics — integers with
    NULLs widen to float64)."""
    has_nulls = null_mask is not None and bool(np.asarray(null_mask).any())
    if kind == "utf8":
        if dictionary_values is None:
            raise ExecutionError("utf8 decode requires a dictionary")
        if isinstance(dictionary_values, Dictionary):
            dictionary_values = dictionary_values.values
        dv = np.asarray(dictionary_values, dtype=object)
        codes = np.asarray(vals).astype(np.int64)
        ok = (codes >= 0) & (codes < len(dv))
        out = np.empty(len(codes), dtype=object)
        out[ok] = dv[codes[ok]]
        out[~ok] = None
        if has_nulls:
            out[null_mask] = None
        return out
    if kind == "date32":
        out = np.asarray(vals).astype("datetime64[D]")
        if has_nulls:
            out[null_mask] = np.datetime64("NaT")
        return out
    if kind == "timestamp_ns":
        out = np.asarray(vals).astype(np.int64).astype("datetime64[ns]")
        if has_nulls:
            out[null_mask] = np.datetime64("NaT")
        return out
    if kind == "decimal":
        out = np.asarray(vals).astype(np.float64) / (10.0 ** scale)
    elif kind in ("float32", "float64"):
        out = np.asarray(vals).astype(np.float64)
    elif has_nulls:
        out = np.asarray(vals).astype(np.float64)
    else:
        return np.asarray(vals)
    if has_nulls:
        out[null_mask] = np.nan
    return out


def decode_list_rows(
    vals2d: np.ndarray,
    element_kind: str,
    element_scale: int,
    null_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(rows, length) physical list values -> object array of per-row 1-D
    logical vectors (None for NULL rows)."""
    arr = np.asarray(vals2d)
    flat = decode_physical_array(arr.reshape(-1), element_kind,
                                 element_scale, None, None)
    rows = np.asarray(flat).reshape(arr.shape)
    cell = np.empty(arr.shape[0], dtype=object)
    for i in range(arr.shape[0]):
        cell[i] = (None if null_mask is not None and null_mask[i]
                   else rows[i])
    return cell


def empty_batch(schema: Schema, device: DeviceLike) -> ColumnBatch:
    """Zero-row batch with the given schema (utf8 columns get empty
    dictionaries)."""
    return ColumnBatch.from_numpy(
        schema,
        {f.name: np.zeros(0, f.dtype.device_dtype()) for f in schema.fields},
        {f.name: Dictionary([]) for f in schema.fields
         if f.dtype.kind == "utf8"},
        capacity=8,
        device=device,
    )


def concat_pydicts(parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    if not parts:
        return {}
    keys = parts[0].keys()
    return {k: np.concatenate([p[k] for p in parts]) for k in keys}
