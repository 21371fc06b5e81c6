"""Delimited text parsed where its bytes lie: the hand-written CUDA
kernels of ``csrc/tbl_parse.cu`` and their plain torch twin.

Replaces no TPU kernel: the JAX package parses ``.tbl`` and CSV text on
the host (``ballista_tpu/native/tblscan.cpp``). On a CUDA device a
``DelimitedSource`` scan stages a file's bytes on the card
(``io/text.py``) and calls :func:`parse`, which gives each wanted column
in the port's physical types, bit for bit as ``native/tblscan.cpp``'s
``parse_field`` does, and each utf8 column's sorted dictionary with
ordinal codes, value for value as the host scanner's.

What bounds it: the file's bytes, read a few times (the row split, the
field walk, the utf8 comparison); lineitem at SF1 is 744 MB, 0.22 ms a
read at 3.35 TB/s. What the design does about it is in the CUDA source's
note: every kernel is one thread per 64-byte segment, row or value, with
no cooperation inside a block.

``parse`` dispatches on the device of its bytes: a CPU tensor takes the
plain twin (vectorised torch over a uint8 tensor, which the tests hold
to the host scanner), a CUDA tensor the kernels, built with ``nvcc`` for
``sm_90a`` at first use (``native_build.py``); there is no fallback. The
utf8 steps between the kernels (a sort of the rows' 64-bit hashes, the
bytewise sort of the distinct values in ``byte_order``, prefix sums) are
torch calls on either device; only the sorted distinct values go to the
host, as one blob. Rows whose bytes differ from their hash group's
representative are resolved exactly, on the host, row by row for those
rows alone, and counted (``hash_collisions``).

``launch_count`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import ExecutionError, IoError
from ..observability.tracing import trace_span

THREADS = 256
SEGMENT_BYTES = 64  # bytes one split thread owns (csrc: kSegmentBytes)
NEWLINE = 10

# io/native.py's kind codes; float (5) stays on the host: strtof's exact
# result is not the card's business
INT64, INT32, DECIMAL, DATE32, UTF8, BOOLEAN = 0, 1, 2, 3, 4, 6
KINDS_ON_CARD = frozenset({INT64, INT32, DECIMAL, DATE32, UTF8, BOOLEAN})
_WIDE = frozenset({INT64, DECIMAL})  # int64 values; boolean bool; else int32

_FNV_OFFSET = 0xCBF29CE484222325 - (1 << 64)  # as a signed int64
_FNV_PRIME = 0x100000001B3

# Kernel launches since the count was last reset.
launch_count = 0

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..native_build import build_tbl_parse

            lib = ctypes.CDLL(build_tbl_parse())
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            for name, args in (
                ("tbl_count_row_starts", [p, ll, ll, ll, p, i, p]),
                ("tbl_write_row_starts", [p, ll, ll, ll, p, p, i, p]),
                ("tbl_parse_rows", [p, ll, p, ll, i, i, p, p, p, p, p, p,
                                    p, p, i, p]),
                ("tbl_verify_groups", [p, p, p, p, p, ll, p, p, i, p]),
                ("tbl_gather_values", [p, p, p, p, p, ll, p, i, p]),
            ):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = args
            lib.tbl_parse_error_string.restype = ctypes.c_char_p
            lib.tbl_parse_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def build() -> None:
    """Build (if needed) and load the kernels' library."""
    _load()


def padded_bytes(size: int) -> int:
    """Length of the buffer a file of ``size`` bytes is staged in: whole
    64-byte segments, at least one (the split's vector loads)."""
    return max(1, -(-int(size) // SEGMENT_BYTES)) * SEGMENT_BYTES


@dataclass
class SortedValues:
    """A utf8 column's distinct values in byte order: their bytes back to
    back (``blob``) and ``offsets`` (int64, one more than the values)."""

    blob: bytes
    offsets: np.ndarray

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def same_as(self, other: "SortedValues") -> bool:
        return (len(self) == len(other) and self.blob == other.blob
                and np.array_equal(self.offsets, other.offsets))

    def strings(self) -> np.ndarray:
        """The values as an object array of ``str`` in one vectorised step
        (Arrow's string array); bytes that are not UTF-8 decode with
        replacement characters, value by value, as the host scanner's
        wrapper decodes them."""
        import pyarrow as pa

        arr = _binary_array(self.blob, self.offsets)
        try:
            return arr.cast(pa.large_string()).to_numpy(zero_copy_only=False)
        except (pa.ArrowInvalid, UnicodeDecodeError):
            out = np.empty(len(self), dtype=object)
            for j in range(len(self)):
                out[j] = self.blob[self.offsets[j]:self.offsets[j + 1]] \
                    .decode("utf-8", errors="replace")
            return out

    @staticmethod
    def of(values) -> "SortedValues":
        """The UTF-8 bytes of ``values`` (sorted ``str``), through Arrow."""
        import pyarrow as pa

        arr = pa.array(np.asarray(values, dtype=object),
                       type=pa.large_string())
        return _from_arrow(arr)


def _binary_array(blob: bytes, offsets: np.ndarray):
    import pyarrow as pa

    return pa.Array.from_buffers(
        pa.large_binary(), len(offsets) - 1,
        [None, pa.py_buffer(np.ascontiguousarray(offsets, dtype=np.int64)),
         pa.py_buffer(blob)])


def _from_arrow(arr) -> SortedValues:
    """``SortedValues`` of an Arrow (large) binary or string array."""
    k = len(arr)
    if k == 0:
        return SortedValues(b"", np.zeros(1, dtype=np.int64))
    bufs = arr.buffers()
    offs = np.frombuffer(bufs[1], dtype=np.int64, count=arr.offset + k + 1)
    offs = offs[arr.offset:] - offs[arr.offset]
    lo = int(np.frombuffer(bufs[1], dtype=np.int64, count=arr.offset + 1)
             [arr.offset])
    data = bufs[2].to_pybytes()[lo:lo + int(offs[-1])] if bufs[2] else b""
    return SortedValues(data, offs.astype(np.int64, copy=True))


@dataclass
class Parsed:
    """What :func:`parse` gives, by position in its ``wanted`` list:
    each column's physical values (``rows_allocated(rows)`` rows, zero
    past ``rows``; utf8 codes ordinal in ``dictionaries``), its validity
    (bool, False past ``rows``) where the column saw a NULL, and each
    utf8 column's sorted values."""

    rows: int
    values: List[torch.Tensor]
    validity: List[Optional[torch.Tensor]]
    dictionaries: List[Optional[SortedValues]]
    hash_collisions: int


def parse(data: torch.Tensor, size: int, begin: int, delimiter: int,
          kinds: Sequence[int], scales: Sequence[int], wanted: Sequence[int],
          rows_allocated: Callable[[int], int] = lambda n: n,
          label: str = "") -> Parsed:
    """Parse the rows of ``data[begin:size]`` (a file's bytes from the
    first row, past any header; ``padded_bytes(size)`` long) into the
    columns ``wanted`` of a schema of ``kinds`` and ``scales`` (one each a
    column). Raises ``IoError`` naming the byte offset of the first row
    that does not parse (and ``label``), ``ExecutionError`` on inputs the
    kernels do not take."""
    _check(data, size, begin, delimiter, kinds, scales, wanted)
    dev = data.device
    cuda = _on_card(data)
    kinds = [int(k) for k in kinds]
    starts = (_split_rows_cuda if cuda else _split_rows_plain)(
        data, size, begin)
    n = int(starts.numel())
    alloc = int(rows_allocated(n))
    if alloc < n:
        raise ExecutionError(f"rows_allocated({n}) = {alloc} < {n}")
    ncols = len(kinds)
    cols: Dict[int, dict] = {}
    for ci in wanted:
        k = kinds[ci]
        if k == UTF8:
            cols[ci] = {"start": torch.empty(n, dtype=torch.int64, device=dev),
                        "len": torch.empty(n, dtype=torch.int32, device=dev),
                        "hash": torch.empty(n, dtype=torch.int64, device=dev)}
        else:
            dt = (torch.int64 if k in _WIDE else
                  torch.bool if k == BOOLEAN else torch.int32)
            cols[ci] = {"values": torch.empty(alloc, dtype=dt, device=dev),
                        "valid": torch.empty(alloc, dtype=torch.bool,
                                             device=dev)}
    run_kinds = [kinds[ci] if ci in cols else -1 for ci in range(ncols)]
    nulls = [False] * ncols
    if n:
        err, nulls = (_parse_rows_cuda if cuda else _parse_rows_plain)(
            data, size, starts, delimiter, run_kinds, list(scales), cols)
        if err is not None:
            offset, ci = err
            raise IoError(
                f"device scan of {label}: parse error (row byte offset "
                f"{offset}) col {ci} (kind {kinds[ci]})")
    values: List[torch.Tensor] = []
    validity: List[Optional[torch.Tensor]] = []
    dictionaries: List[Optional[SortedValues]] = []
    collisions = 0
    for ci in wanted:
        c = cols[ci]
        if kinds[ci] == UTF8:
            sv, codes, hit = dictionary_encode(data, c["start"], c["len"],
                                               c["hash"])
            out = torch.zeros(alloc, dtype=torch.int32, device=dev)
            out[:n] = codes
            values.append(out)
            validity.append(None)
            dictionaries.append(sv)
            collisions += hit
            continue
        c["values"][n:] = 0
        values.append(c["values"])
        if nulls[ci]:
            c["valid"][n:] = False
            validity.append(c["valid"])
        else:
            validity.append(None)
        dictionaries.append(None)
    return Parsed(n, values, validity, dictionaries, collisions)


def _check(data, size, begin, delimiter, kinds, scales, wanted) -> None:
    if data.device.type not in ("cpu", "cuda"):
        raise ExecutionError(f"tbl_parse: no kernel for device {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 1 or \
            not data.is_contiguous():
        raise ExecutionError("tbl_parse: data must be a contiguous 1-D "
                             "uint8 tensor")
    if size < 0 or not 0 <= begin <= max(size, 0):
        raise ExecutionError(f"tbl_parse: bad size {size} or begin {begin}")
    if data.numel() < padded_bytes(size):
        raise ExecutionError(
            f"tbl_parse: {data.numel()} bytes given, "
            f"{padded_bytes(size)} needed for a file of {size}")
    if data.device.type == "cuda" and data.data_ptr() % 16:
        raise ExecutionError("tbl_parse: data is not 16-byte aligned")
    if not 0 <= int(delimiter) <= 255 or int(delimiter) == NEWLINE:
        raise ExecutionError(f"tbl_parse: bad delimiter {delimiter!r}")
    if not kinds or len(kinds) != len(scales):
        raise ExecutionError("tbl_parse: one kind and one scale a column")
    if len(set(wanted)) != len(wanted) or any(
            not 0 <= ci < len(kinds) for ci in wanted):
        raise ExecutionError(f"tbl_parse: bad wanted columns {wanted}")
    for ci in wanted:
        if kinds[ci] not in KINDS_ON_CARD:
            raise ExecutionError(
                f"tbl_parse: column {ci} has kind {kinds[ci]}, which the "
                f"kernels do not parse")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise ExecutionError(
            f"tbl_parse: {what} launch failed: CUDA error {err} "
            f"({lib.tbl_parse_error_string(err).decode()})")


def _on_card(t: torch.Tensor) -> bool:
    """True when ``t``'s device runs the kernels, False for the twin."""
    return t.device.type == "cuda"


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _addresses(ptrs: Sequence[int], dev) -> torch.Tensor:
    # a copy from pageable host memory: the host waits for the stream
    with trace_span("device.block", site="tbl_parse.args"):
        return torch.tensor(list(ptrs), dtype=torch.int64).to(dev)


# -- the row split ----------------------------------------------------------


def _split_rows_cuda(data, size, begin) -> torch.Tensor:
    global launch_count
    dev = data.device
    if size == 0 or begin >= size:
        return torch.empty(0, dtype=torch.int64, device=dev)
    lib = _load()
    segments = padded_bytes(size) // SEGMENT_BYTES
    counts = torch.empty(segments, dtype=torch.int32, device=dev)
    _raise_on(lib, lib.tbl_count_row_starts(
        data.data_ptr(), begin, size, segments, counts.data_ptr(), THREADS,
        _stream(dev)), "count_row_starts")
    launch_count += 1
    inclusive = torch.cumsum(counts, 0, dtype=torch.int64)
    with trace_span("device.block", site="tbl_parse.row_count"):
        n = int(inclusive[-1])
    starts = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        _raise_on(lib, lib.tbl_write_row_starts(
            data.data_ptr(), begin, size, segments, inclusive.data_ptr(),
            starts.data_ptr(), THREADS, _stream(dev)), "write_row_starts")
        launch_count += 1
    return starts


def _split_rows_plain(data, size, begin) -> torch.Tensor:
    """Row starts: bytes that are not a newline and follow one (or begin
    the body)."""
    if size == 0 or begin >= size:
        return torch.empty(0, dtype=torch.int64, device=data.device)
    d = data[:size]
    prev = torch.empty_like(d)
    prev[0] = NEWLINE
    prev[1:] = d[:-1]
    start = (d != NEWLINE) & (prev == NEWLINE)
    start[:begin] = False
    return torch.nonzero(start).flatten()


# -- the field walk ---------------------------------------------------------


def _parse_rows_cuda(data, size, starts, delimiter, kinds, scales, cols):
    """Launch the field walk; returns (None or (row offset, column), the
    columns that saw a NULL)."""
    global launch_count
    dev = data.device
    lib = _load()
    ncols = len(kinds)
    zero = [0] * ncols
    values, lens, hashes, valid = list(zero), list(zero), list(zero), \
        list(zero)
    for ci, c in cols.items():
        if "hash" in c:
            values[ci] = c["start"].data_ptr()
            lens[ci] = c["len"].data_ptr()
            hashes[ci] = c["hash"].data_ptr()
        else:
            values[ci] = c["values"].data_ptr()
            valid[ci] = c["valid"].data_ptr()
    args = [_addresses(a, dev) for a in (values, lens, hashes, valid)]
    with trace_span("device.block", site="tbl_parse.args"):
        kinds_t = torch.tensor(kinds, dtype=torch.int32).to(dev)
        scales_t = torch.tensor(scales, dtype=torch.int32).to(dev)
    nulls = torch.zeros(ncols, dtype=torch.int32, device=dev)
    err = torch.full((1,), -1, dtype=torch.int64, device=dev)  # all bits set
    _raise_on(lib, lib.tbl_parse_rows(
        data.data_ptr(), size, starts.data_ptr(), starts.numel(), ncols,
        int(delimiter), kinds_t.data_ptr(), scales_t.data_ptr(),
        *[a.data_ptr() for a in args], nulls.data_ptr(), err.data_ptr(),
        THREADS, _stream(dev)), "parse_rows")
    launch_count += 1
    with trace_span("device.block", site="tbl_parse.rows"):
        host = torch.cat([err, nulls.to(torch.int64)]).cpu().tolist()
    code = host[0] & 0xFFFFFFFFFFFFFFFF
    failed = None if code == 0xFFFFFFFFFFFFFFFF else (code >> 16,
                                                      code & 0xFFFF)
    return failed, [bool(x) for x in host[1:]]


def _field_bounds(data, size, starts, delimiter, ncols):
    """(field starts, field ends) per column, each an int64 [n] tensor:
    the fields of every row as ``tblscan.cpp``'s ``parse_span`` cuts
    them (the plain twin's walk)."""
    d = data[:size]
    end_of_file = torch.tensor([size], dtype=torch.int64, device=d.device)
    nl = torch.cat([torch.nonzero(d == NEWLINE).flatten(), end_of_file])
    ends = nl[torch.searchsorted(nl, starts)]
    dl = torch.cat([torch.nonzero(d == delimiter).flatten(), end_of_file])
    last = dl.numel() - 1
    lo = torch.searchsorted(dl, starts)
    hi = torch.searchsorted(dl, ends)
    out = []
    for ci in range(ncols):
        j1 = lo + ci
        fe = torch.where(j1 < hi, dl[j1.clamp(max=last)], ends)
        if ci == 0:
            fs = starts
        else:
            j0 = j1 - 1
            fs = torch.where(j0 < hi, dl[j0.clamp(max=last)] + 1, ends)
        out.append((fs, fe))
    return out


def _chars(d, fs, length):
    """[n, W] int64 bytes of each field (0 past its length) and the
    positions 0..W-1."""
    width = int(length.max()) if length.numel() else 0
    pos = torch.arange(max(width, 1), dtype=torch.int64, device=d.device)
    idx = (fs[:, None] + pos[None, :]).clamp(max=max(d.numel() - 1, 0))
    inside = pos[None, :] < length[:, None]
    c = torch.where(inside, d[idx].to(torch.int64), 0)
    return c, pos, inside


def _horner(c, region):
    """Wrapping int64 value of the digits of ``c`` in ``region``."""
    v = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    for j in range(c.shape[1]):
        v = torch.where(region[:, j], v * 10 + (c[:, j] - 48), v)
    return v


def _wrap32(x):
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def _days_from_civil(y, m, d):
    """``days_from_civil`` with C's int and unsigned arithmetic."""
    y = y - (m <= 2).to(torch.int64)
    era = torch.div(torch.where(y >= 0, y, y - 399), 400,
                    rounding_mode="trunc")
    yoe = y - era * 400
    t = torch.div(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5,
                  rounding_mode="trunc") + d - 1
    doy = t % (1 << 32)
    doe = (yoe * 365 + yoe // 4 - yoe // 100 + doy) % (1 << 32)
    return _wrap32(era * 146097 + _wrap32(doe) - 719468)


def _parse_column(kind, scale, c, pos, inside, length):
    """(physical values, rows that do not parse) of one non-utf8 column;
    NULL rows (empty fields) give 0 and are never bad."""
    n = c.shape[0]
    isdig = (c >= 48) & (c <= 57)
    first = c[:, 0]
    if kind in (INT64, INT32, DECIMAL):
        signed = (length > 0) & ((first == 45) | (first == 43))
        neg = (length > 0) & (first == 45)
        body = (pos[None, :] >= signed.to(torch.int64)[:, None]) & inside
        if kind == DECIMAL:
            isdot = (c == 46) & body
            has_dot = isdot.any(1)
            dot = torch.where(has_dot, torch.argmax(isdot.to(torch.int8), 1),
                              length)
            ipart = body & (pos[None, :] < dot[:, None])
            frac_hi = torch.minimum(length, dot + 1 + scale)
            fpart = has_dot[:, None] & (pos[None, :] > dot[:, None]) & \
                (pos[None, :] < frac_hi[:, None])
            bad = ((ipart | fpart) & ~isdig).any(1)
            ip = _horner(c, ipart)
            fp = _horner(c, fpart)
            fdigits = fpart.sum(1)
            rpos = dot + 1 + scale
            rc = c.gather(1, rpos.clamp(max=c.shape[1] - 1)[:, None])[:, 0]
            fp = fp + (has_dot & (rpos < length) & (rc >= 53) &
                       (rc <= 57)).to(torch.int64)
            pow10 = torch.tensor([10 ** k for k in range(scale + 1)],
                                 dtype=torch.int64, device=c.device)
            fp = fp * pow10[(scale - fdigits).clamp(min=0)]
            v = ip * (10 ** scale) + fp
        else:
            bad = (body & ~isdig).any(1)
            v = _horner(c, body)
        v = torch.where(neg, -v, v)
        if kind == INT32:
            v = _wrap32(v)
    elif kind == DATE32:
        bad = length < 10
        sc = torch.where(c >= 128, c - 256, c)[:, :10] if c.shape[1] >= 10 \
            else torch.zeros((n, 10), dtype=torch.int64, device=c.device)
        num = lambda a, b: _horner(sc[:, a:b] + 0, torch.ones(
            (n, b - a), dtype=torch.bool, device=c.device))
        v = _days_from_civil(num(0, 4), num(5, 7), num(8, 10))
    elif kind == BOOLEAN:
        c0 = torch.where((first >= 65) & (first <= 90), first + 32, first)
        one = (c0 == 116) | (c0 == 49)
        zero = (c0 == 102) | (c0 == 48)
        bad = ~(one | zero)
        v = one.to(torch.int64)
    else:
        raise ExecutionError(f"tbl_parse: kind {kind} has no parse")
    null = length == 0
    return torch.where(null, 0, v), bad & ~null


def _parse_rows_plain(data, size, starts, delimiter, kinds, scales, cols):
    d = data[:size]
    bounds = _field_bounds(data, size, starts, delimiter, len(kinds))
    nulls = [False] * len(kinds)
    err = None
    for ci, c in cols.items():
        fs, fe = bounds[ci]
        length = fe - fs
        ch, pos, inside = _chars(d, fs, length)
        if kinds[ci] == UTF8:
            h = torch.full((fs.numel(),), _FNV_OFFSET, dtype=torch.int64,
                           device=d.device)
            for j in range(ch.shape[1]):
                h = torch.where(inside[:, j], (h ^ ch[:, j]) * _FNV_PRIME, h)
            c["start"].copy_(fs)
            c["len"].copy_(length.to(torch.int32))
            c["hash"].copy_(h)
            continue
        v, bad = _parse_column(kinds[ci], int(scales[ci]), ch, pos, inside,
                               length)
        n = fs.numel()
        c["values"][:n] = v.to(c["values"].dtype)
        c["valid"][:n] = length > 0
        nulls[ci] = bool((length == 0).any())
        if bool(bad.any()):
            code = int(((starts[bad] << 16) | ci).min())
            err = code if err is None else min(err, code)
    return (None if err is None else (err >> 16, err & 0xFFFF)), nulls


# -- dictionary encoding ----------------------------------------------------


def dictionary_encode(data: torch.Tensor, fstart: torch.Tensor,
                      flen: torch.Tensor, hashes: torch.Tensor
                      ) -> Tuple[SortedValues, torch.Tensor, int]:
    """(sorted distinct values, int32 code of each row, extra values that
    shared a hash with another) of the fields ``data[fstart:fstart +
    flen]``. Rows sort by ``hashes``; one representative is kept per
    distinct hash; every row is compared with its representative, and
    rows that differ get values of their own (exactly, on the host, for
    those rows alone). The distinct values sort bytewise where the bytes
    lie (``byte_order``), and only they go to the host."""
    dev = data.device
    n = int(hashes.numel())
    if n == 0:
        return (SortedValues(b"", np.zeros(1, dtype=np.int64)),
                torch.empty(0, dtype=torch.int32, device=dev), 0)
    sorted_h, perm = torch.sort(hashes, stable=True)
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    boundary[1:] = sorted_h[1:] != sorted_h[:-1]
    gid = torch.empty(n, dtype=torch.int64, device=dev)
    gid[perm] = torch.cumsum(boundary, 0) - 1
    with trace_span("device.block", site="tbl_parse.groups"):
        rep = perm[boundary]  # the mask's count comes to the host
    flags, mismatches = _verify(data, fstart, flen, gid, rep)
    extra = 0
    with trace_span("device.block", site="tbl_parse.mismatches"):
        mismatches = int(mismatches)
    if mismatches:
        rows = torch.nonzero(flags).flatten()
        mblob, moffs = _values_of(data, fstart, flen, rows)
        k = int(rep.numel())
        # value -> (its new group, the first of rows that holds it)
        first: Dict[bytes, Tuple[int, int]] = {}
        ids = [k + first.setdefault(mblob[moffs[j]:moffs[j + 1]],
                                    (len(first), j))[0]
               for j in range(len(moffs) - 1)]
        gid[rows] = torch.tensor(ids, dtype=torch.int64).to(dev)
        extra = len(first)
        held = torch.tensor([j for _, j in first.values()],
                            dtype=torch.int64).to(dev)
        rep = torch.cat([rep, rows[held]])
    order = byte_order(data, fstart[rep], flen[rep])
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), dtype=torch.int64, device=dev)
    blob, offsets = _values_of(data, fstart, flen, rep[order])
    return SortedValues(blob, offsets), rank[gid].to(torch.int32), extra


def byte_order(data: torch.Tensor, starts: torch.Tensor,
               lens: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts the values ``data[starts:starts + lens]``
    bytewise (unsigned, a prefix first): stable sorts from the least
    significant key up, the length first, then each 8-byte chunk from
    the last to the first, read big-endian with its sign bit flipped so
    that int64 order is unsigned byte order."""
    dev = data.device
    lens = lens.to(torch.int64)
    order = torch.sort(lens, stable=True)[1]
    with trace_span("device.block", site="tbl_parse.width"):
        width = int(lens.max()) if lens.numel() else 0
    shifts = torch.arange(56, -8, -8, dtype=torch.int64, device=dev)
    top = max(data.numel() - 1, 0)
    for j in reversed(range(0, width, 8)):
        s, ln = starts[order], lens[order]
        pos = j + torch.arange(8, dtype=torch.int64, device=dev)
        b = data[(s[:, None] + pos).clamp(max=top)].to(torch.int64)
        b = torch.where(pos < ln[:, None], b, 0)
        key = (b << shifts).sum(1) ^ (-(1 << 63))
        order = order[torch.sort(key, stable=True)[1]]
    return order


def _values_of(data, fstart, flen, rows) -> Tuple[bytes, np.ndarray]:
    """The bytes of the fields of ``rows``, back to back, and offsets."""
    lens = flen[rows].to(torch.int64)
    offs = torch.zeros(rows.numel() + 1, dtype=torch.int64,
                       device=data.device)
    torch.cumsum(lens, 0, out=offs[1:])
    out = _gather(data, fstart, flen, rows, offs)
    with trace_span("device.block", site="tbl_parse.values"):
        return out.cpu().numpy().tobytes(), offs.cpu().numpy()


def _verify(data, fstart, flen, gid, rep):
    global launch_count
    if not _on_card(data):
        q = rep[gid]
        ql = flen[q].to(torch.int64)
        rl = flen.to(torch.int64)
        same = rl == ql
        width = int(rl.max()) if rl.numel() else 0
        if width:
            pos = torch.arange(width, dtype=torch.int64, device=data.device)
            inside = pos[None, :] < rl[:, None]
            top = max(data.numel() - 1, 0)
            a = data[(fstart[:, None] + pos).clamp(max=top)]
            b = data[(fstart[q][:, None] + pos).clamp(max=top)]
            same &= ~((a != b) & inside).any(1)
        flags = (~same).to(torch.uint8)
        return flags, int((~same).sum())
    lib = _load()
    n = int(gid.numel())
    flags = torch.empty(n, dtype=torch.uint8, device=data.device)
    count = torch.zeros(1, dtype=torch.int64, device=data.device)
    _raise_on(lib, lib.tbl_verify_groups(
        data.data_ptr(), fstart.data_ptr(), flen.data_ptr(), gid.data_ptr(),
        rep.data_ptr(), n, flags.data_ptr(), count.data_ptr(), THREADS,
        _stream(data.device)), "verify_groups")
    launch_count += 1
    return flags, count


def _gather(data, fstart, flen, rows, offs):
    global launch_count
    with trace_span("device.block", site="tbl_parse.gather_bytes"):
        total = int(offs[-1])
    out = torch.empty(total, dtype=torch.uint8, device=data.device)
    k = int(rows.numel())
    if total == 0:
        return out
    if not _on_card(data):
        p = torch.arange(total, dtype=torch.int64, device=data.device)
        i = torch.searchsorted(offs[1:], p, right=True)
        return data[fstart[rows][i] + (p - offs[i])]
    lib = _load()
    _raise_on(lib, lib.tbl_gather_values(
        data.data_ptr(), fstart.data_ptr(), flen.data_ptr(), rows.data_ptr(),
        offs.data_ptr(), k, out.data_ptr(), THREADS, _stream(data.device)),
        "gather_values")
    launch_count += 1
    return out
