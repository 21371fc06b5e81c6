"""Shuffle memory governor + disk spill for the streaming data plane.

The port's copy of the JAX package's ``distributed/spill.py``.
The shuffle data plane moves partition bytes as bounded Arrow-IPC
chunks (``BALLISTA_SHUFFLE_CHUNK_BYTES``) instead of whole-partition
blobs. This module makes the memory those chunks occupy a *governed*
resource, the way ``compile/governor.py`` made compilation one:

- :class:`ShuffleMemoryGovernor` — one per-process accountant. Every
  in-flight shuffle buffer byte (fetched-but-not-yet-decoded wire
  chunks, writer-side Arrow conversion buffers) is charged against
  ``BALLISTA_SHUFFLE_MEM_BUDGET``; ``try_charge`` refuses past the
  ``BALLISTA_SHUFFLE_SPILL_WATERMARK`` fraction of the budget.
- :class:`SpillPool` — size-rotated append-only spill files
  (``BALLISTA_SHUFFLE_SPILL_FILE_MB`` per segment) under
  ``BALLISTA_SHUFFLE_SPILL_DIR``. Segments are reference-counted and
  unlinked once rotated out and fully released.
- :class:`ChunkBuffer` — one in-flight shuffle part's chunk queue.
  ``put`` keeps chunks in RAM while the governor grants budget and
  diverts to the spill pool past the watermark (the ingest pool's
  cancel-or-inline philosophy: a saturated budget degrades to
  streaming-from-disk, it never blocks); ``chunks`` replays them in
  arrival order with transparent re-read, releasing as it goes.

Failure semantics: a truncated or short spill segment read raises an
IoError-shaped :class:`SpillCorrupt`; shuffle readers tag it into the
existing ``ShuffleFetchError`` so ``recover_fetch_failure`` re-queues
the producer exactly like a dead peer. Fault point
``shuffle.spill.write`` covers the spill write (``drop`` = torn write:
only half the payload reaches disk, simulating a crash mid-append).

Knob reads are dynamic (per part, not per chunk) so tests and bench
can re-point the budget without process restarts.
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, Optional

from ..errors import IoError
from ..observability import memory as obs_memory
from ..observability.tracing import trace_span
from ..testing.faults import fault_point


class SpillCorrupt(IoError):
    """A spill segment read came back short or misaligned (torn write,
    external truncation, disk fault). IoError-shaped: shuffle readers
    wrap it into the tagged ShuffleFetchError recovery path."""


def _env_int(name: str, default: int, floor: int = 1) -> int:
    try:
        return max(int(os.environ.get(name, "") or default), floor)
    except ValueError:
        return default


def shuffle_chunk_bytes() -> int:
    """``BALLISTA_SHUFFLE_CHUNK_BYTES``: max Arrow-IPC record-batch /
    wire-frame size on the shuffle path (default 4 MiB)."""
    return _env_int("BALLISTA_SHUFFLE_CHUNK_BYTES", 4 << 20, floor=1 << 10)


def shuffle_mem_budget() -> int:
    """``BALLISTA_SHUFFLE_MEM_BUDGET``: per-process cap on in-flight
    shuffle buffer bytes (default 256 MiB)."""
    return _env_int("BALLISTA_SHUFFLE_MEM_BUDGET", 256 << 20, floor=1 << 12)


def spill_watermark() -> float:
    """``BALLISTA_SHUFFLE_SPILL_WATERMARK``: fraction of the budget past
    which new chunk buffers divert to disk (default 0.8)."""
    try:
        v = float(os.environ.get("BALLISTA_SHUFFLE_SPILL_WATERMARK",
                                 "") or 0.8)
    except ValueError:
        return 0.8
    return min(max(v, 0.01), 1.0)


def spill_file_bytes() -> int:
    """``BALLISTA_SHUFFLE_SPILL_FILE_MB``: spill segment rotation size
    (default 64 MiB)."""
    return _env_int("BALLISTA_SHUFFLE_SPILL_FILE_MB", 64, floor=1) << 20


def spill_dir() -> str:
    """``BALLISTA_SHUFFLE_SPILL_DIR``: where spill segments land
    (default: a per-process dir under the system tempdir)."""
    d = os.environ.get("BALLISTA_SHUFFLE_SPILL_DIR", "").strip()
    if d:
        return d
    import tempfile

    return os.path.join(tempfile.gettempdir(),
                        f"ballista-spill-{os.getpid()}")


def stream_window_bytes() -> int:
    """``BALLISTA_SHUFFLE_WINDOW_BYTES``: flow-control window a chunk
    stream reader advertises — the server suspends past this many
    unacked in-flight bytes per peer (default 4 chunks)."""
    return _env_int("BALLISTA_SHUFFLE_WINDOW_BYTES",
                    4 * shuffle_chunk_bytes(), floor=1 << 12)


class ShuffleMemoryGovernor:
    """Process-wide accountant for in-flight shuffle buffer bytes.

    Counters follow the engine's benign-race policy for *gauges* but the
    charge/release pair is locked — a lost update here would leak budget
    forever. The budget/watermark are read from the environment at call
    time, so one governor instance serves any knob configuration."""

    def __init__(self):
        self._lock = threading.Lock()
        self.inflight_bytes = 0
        self.peak_inflight_bytes = 0
        self.spilled_bytes_total = 0
        self.spill_chunks_total = 0
        self.denials = 0

    def try_charge(self, nbytes: int) -> bool:
        """Charge ``nbytes`` against the budget unless doing so would
        cross the spill watermark; returns whether the charge landed.
        Never blocks — a refused charge means the caller spills."""
        n = int(nbytes)
        if n <= 0:
            return True
        limit = int(shuffle_mem_budget() * spill_watermark())
        with self._lock:
            if self.inflight_bytes + n > limit:
                self.denials += 1
                return False
            self.inflight_bytes += n
            if self.inflight_bytes > self.peak_inflight_bytes:
                self.peak_inflight_bytes = self.inflight_bytes
        obs_memory.record_host_bytes("shuffle_stream", n)
        return True

    def charge(self, nbytes: int) -> None:
        """Unconditional charge (writer-side transient buffers: they are
        on their way to disk already, spilling them is meaningless)."""
        n = int(nbytes)
        if n <= 0:
            return
        with self._lock:
            self.inflight_bytes += n
            if self.inflight_bytes > self.peak_inflight_bytes:
                self.peak_inflight_bytes = self.inflight_bytes
        obs_memory.record_host_bytes("shuffle_stream", n)

    def release(self, nbytes: int) -> None:
        n = int(nbytes)
        if n <= 0:
            return
        with self._lock:
            self.inflight_bytes = max(0, self.inflight_bytes - n)
        obs_memory.release_host_bytes("shuffle_stream", n)

    def note_spill(self, nbytes: int) -> None:
        with self._lock:
            self.spilled_bytes_total += int(nbytes)
            self.spill_chunks_total += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "inflight_bytes": self.inflight_bytes,
                "peak_inflight_bytes": self.peak_inflight_bytes,
                "spilled_bytes_total": self.spilled_bytes_total,
                "spill_chunks_total": self.spill_chunks_total,
                "denials": self.denials,
                "budget_bytes": shuffle_mem_budget(),
            }

    def reset_stats(self) -> None:
        """Re-baseline the cumulative counters (bench phases, tests).
        ``inflight_bytes`` is live accounting and is NOT reset."""
        with self._lock:
            self.peak_inflight_bytes = self.inflight_bytes
            self.spilled_bytes_total = 0
            self.spill_chunks_total = 0
            self.denials = 0


_governor = ShuffleMemoryGovernor()


def governor() -> ShuffleMemoryGovernor:
    return _governor


class _Segment:
    """One size-rotated spill file: append-only while current, unlinked
    once rotated out and every referencing chunk is released."""

    __slots__ = ("path", "size", "refs", "rotated")

    def __init__(self, path: str):
        self.path = path
        self.size = 0
        self.refs = 0
        self.rotated = False


class SpillRef:
    """Handle to one spilled chunk: (segment, offset, length).

    ``written`` records how many bytes actually reached the file at
    append time — a torn write (crash or injected fault mid-append) can
    persist fewer than ``length``, and because later chunks append at
    the file's REAL end, the torn chunk's window would otherwise read
    back the neighbor's bytes without any short read at all."""

    __slots__ = ("_pool", "_seg", "offset", "length", "written")

    def __init__(self, pool: "SpillPool", seg: _Segment, offset: int,
                 length: int, written: int):
        self._pool = pool
        self._seg = seg
        self.offset = offset
        self.length = length
        self.written = written

    def read(self) -> bytes:
        """Transparent re-read; torn writes and truncation surface as
        :class:`SpillCorrupt`, never as silently misaligned bytes."""
        if self.written != self.length:
            raise SpillCorrupt(
                f"spill segment torn: {self._seg.path} "
                f"offset={self.offset} want={self.length} "
                f"wrote={self.written}"
            )
        try:
            with open(self._seg.path, "rb") as fh:
                fh.seek(self.offset)
                data = fh.read(self.length)
        except OSError as e:
            raise SpillCorrupt(
                f"spill segment unreadable: {self._seg.path}: {e}"
            ) from e
        if len(data) != self.length:
            raise SpillCorrupt(
                f"spill segment truncated: {self._seg.path} "
                f"offset={self.offset} want={self.length} got={len(data)}"
            )
        return data

    def release(self) -> None:
        self._pool._release(self._seg)


class SpillPool:
    """Append-only spill storage in size-rotated segments.

    One process-wide instance (lazily created) serves every spilling
    ChunkBuffer; appends serialize under one lock (chunks are at most
    ``shuffle_chunk_bytes`` so the hold time is one buffered write)."""

    def __init__(self, base_dir: Optional[str] = None,
                 max_file_bytes: Optional[int] = None):
        self._dir = base_dir
        self._max = max_file_bytes
        self._lock = threading.Lock()
        self._current: Optional[_Segment] = None
        self._fh = None
        self._seq = 0
        self.segments_created = 0

    def _roll(self) -> _Segment:
        base = self._dir or spill_dir()
        os.makedirs(base, exist_ok=True)
        path = os.path.join(
            base, f"spill-{os.getpid()}-{self._seq:06d}.bin")
        self._seq += 1
        self.segments_created += 1
        if self._fh is not None:
            self._fh.close()
        if self._current is not None:
            self._current.rotated = True
            self._maybe_unlink(self._current)
        self._current = _Segment(path)
        self._fh = open(path, "wb")
        return self._current

    def append(self, data: bytes) -> SpillRef:
        """Write one chunk; returns its re-read handle. The offset is
        taken from the file's REAL position so a previous torn write
        cannot misalign later chunks."""
        action = fault_point("shuffle.spill.write", nbytes=len(data))
        if action == "drop":
            # torn write: half the payload reaches disk — the re-read
            # detects the short segment as SpillCorrupt
            data_to_write = data[: len(data) // 2]
        else:
            data_to_write = data
        with self._lock, trace_span("shuffle.spill", op="write",
                                    nbytes=len(data)):
            seg = self._current
            if seg is None or seg.size >= (self._max or spill_file_bytes()):
                seg = self._roll()
            offset = self._fh.tell()
            self._fh.write(data_to_write)
            self._fh.flush()
            seg.size = self._fh.tell()
            seg.refs += 1
            # written = real bytes on disk; a mismatch with len(data)
            # marks the ref torn so read() raises SpillCorrupt instead
            # of returning the NEXT chunk's bytes (later appends land
            # at the file's real end)
            return SpillRef(self, seg, offset, len(data),
                            written=seg.size - offset)

    def _release(self, seg: _Segment) -> None:
        with self._lock:
            seg.refs = max(0, seg.refs - 1)
            self._maybe_unlink(seg)

    def _maybe_unlink(self, seg: _Segment) -> None:
        # caller holds the lock (or is single-threaded rollover)
        if seg.rotated and seg.refs == 0:
            try:
                os.unlink(seg.path)
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if self._current is not None:
                self._current.rotated = True
                self._maybe_unlink(self._current)
                self._current = None


_pool_lock = threading.Lock()
_pool: Optional[SpillPool] = None


def spill_pool() -> SpillPool:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = SpillPool()
        return _pool


def _reset_pool() -> None:
    """Tests: drop the process pool so a fresh spill dir takes effect."""
    global _pool
    with _pool_lock:
        p, _pool = _pool, None
    if p is not None:
        p.close()


class ChunkBuffer:
    """One in-flight shuffle part's ordered chunk queue.

    ``put`` is called by the fetch loop per received wire chunk; chunks
    stay in RAM while the governor grants budget, and once one chunk
    spills every later chunk of this part spills too (so replay order
    is RAM-prefix then disk-suffix — always arrival order).
    ``chunks()`` is consumed exactly once by the incremental IPC
    decoder; each chunk's budget/segment is released as it is yielded.
    ``close()`` releases whatever was not consumed (error paths)."""

    __slots__ = ("_gov", "_ram", "_refs", "_spilling", "total_bytes",
                 "spilled_bytes", "_closed")

    def __init__(self, gov: Optional[ShuffleMemoryGovernor] = None):
        from collections import deque

        self._gov = gov or governor()
        self._ram: "deque[bytes]" = deque()
        self._refs: "deque[SpillRef]" = deque()
        self._spilling = False
        self.total_bytes = 0
        self.spilled_bytes = 0
        self._closed = False

    def put(self, data: bytes) -> None:
        n = len(data)
        self.total_bytes += n
        if not self._spilling and self._gov.try_charge(n):
            self._ram.append(data)
            return
        self._spilling = True
        self._refs.append(spill_pool().append(data))
        self.spilled_bytes += n
        self._gov.note_spill(n)

    def chunks(self) -> Iterator[bytes]:
        """Replay in arrival order, releasing as consumed."""
        while self._ram:
            data = self._ram.popleft()
            self._gov.release(len(data))
            yield data
        while self._refs:
            ref = self._refs.popleft()
            with trace_span("shuffle.spill", op="read", nbytes=ref.length):
                data = ref.read()
            ref.release()
            yield data

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for data in self._ram:
            self._gov.release(len(data))
        self._ram.clear()
        for ref in self._refs:
            ref.release()
        self._refs.clear()
