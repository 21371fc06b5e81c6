"""Host/device memory accounting for queries and the health plane.

Host side: instrumented allocation sites (scan parse buffers,
dictionaries, shuffle IPC buffers, cache occupancy) call
:func:`record_host_bytes` / :func:`release_host_bytes` with a category
tag, so the engine can say *what kind* of host memory a query holds —
``rss`` alone can't distinguish a dictionary explosion from shuffle
buffering. Tracking is byte-counting only (no allocator hooks): cheap
ints under a small lock, updated at batch/file granularity, never per
row.

The port of the JAX package's ``observability/memory.py``: the host
side is a copy. Device side: on a card, torch's caching allocator keeps
the numbers (``torch.cuda.memory_allocated`` and
``torch.cuda.max_memory_allocated`` of the device asked for, the current
card by default); on the CPU, where tensors are host memory, the device
bytes are those of the tensors the table cache pins
(``cache/residency.py``), summed by walking its entries — the JAX
package walks ``jax.live_arrays()`` there. A walk is rate-limited
(``_SAMPLE_MIN_INTERVAL``) and the cached value returned in between.

Peaks are monotone by construction (``max`` accumulation, or the
allocator's own peak); code that wants a fresh baseline calls
:func:`reset_peaks`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

import torch

_lock = threading.Lock()
_by_category: Dict[str, int] = {}
_peak_by_category: Dict[str, int] = {}
_current_total = 0
_peak_total = 0

# device sampling state
_SAMPLE_MIN_INTERVAL = 0.25  # seconds between real live-array walks
_device_cached = 0
_device_sampled_at = 0.0
_device_peak = 0


def record_host_bytes(category: str, nbytes: int) -> None:
    """Account ``nbytes`` of host memory under ``category`` (one of
    ``batches``, ``dictionaries``, ``shuffle``, ``cache`` by
    convention; free-form tags are fine)."""
    global _current_total, _peak_total
    n = int(nbytes)
    if n <= 0:
        return
    with _lock:
        cur = _by_category.get(category, 0) + n
        _by_category[category] = cur
        if cur > _peak_by_category.get(category, 0):
            _peak_by_category[category] = cur
        _current_total += n
        if _current_total > _peak_total:
            _peak_total = _current_total


def release_host_bytes(category: str, nbytes: int) -> None:
    global _current_total
    n = int(nbytes)
    if n <= 0:
        return
    with _lock:
        cur = _by_category.get(category, 0)
        taken = min(cur, n)  # never go negative on double-release
        _by_category[category] = cur - taken
        _current_total -= taken


class track_host_bytes:
    """Context manager for TRANSIENT host buffers: records on entry,
    releases on exit — the peak still captures the high-water mark."""

    __slots__ = ("category", "nbytes")

    def __init__(self, category: str, nbytes: int):
        self.category = category
        self.nbytes = int(nbytes)

    def __enter__(self):
        record_host_bytes(self.category, self.nbytes)
        return self

    def __exit__(self, *exc):
        release_host_bytes(self.category, self.nbytes)
        return False


def current_host_bytes() -> int:
    return _current_total


def peak_host_bytes() -> int:
    return _peak_total


def host_memory_snapshot() -> dict:
    with _lock:
        return {
            "current_bytes": _current_total,
            "peak_bytes": _peak_total,
            "by_category": dict(_by_category),
            "peak_by_category": dict(_peak_by_category),
        }


def _card(device=None):
    """The CUDA device ``device`` names, the current card when None and
    one exists, else None (the CPU)."""
    if device is not None:
        device = torch.device(device)
        return device if device.type == "cuda" else None
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return None


def _sample_device_bytes(device=None) -> int:
    """One real device-memory sample: the allocator's bytes in use on a
    card, the table cache's pinned tensors on the CPU."""
    card = _card(device)
    if card is not None:
        # ``torch.cuda.memory_allocated`` reads the same number after
        # flattening every allocator statistic into one dict in Python,
        # about half a millisecond a call, and each operator's output
        # batch reads this
        stats = torch.cuda.memory_stats_as_nested_dict(card)
        return int(stats.get("allocated_bytes", {}).get("all", {})
                   .get("current", 0))
    from ..cache.residency import batch_device_bytes, process_table_cache

    return sum(batch_device_bytes(b) for b in
               process_table_cache().pinned_batches(torch.device("cpu")))


def device_bytes(refresh: bool = False, device=None) -> int:
    """Device bytes in use. On a card the allocator's count (always
    current); on the CPU rate-limited: a real walk happens at most every
    ``_SAMPLE_MIN_INTERVAL`` seconds unless ``refresh=True``, and the
    cached value is returned in between."""
    global _device_cached, _device_sampled_at, _device_peak
    if _card(device) is not None:
        return _sample_device_bytes(device)
    now = time.monotonic()
    if refresh or now - _device_sampled_at >= _SAMPLE_MIN_INTERVAL:
        _device_sampled_at = now
        _device_cached = _sample_device_bytes(device)
        if _device_cached > _device_peak:
            _device_peak = _device_cached
    return _device_cached


def peak_device_bytes(refresh: bool = False, device=None) -> int:
    """Peak device bytes since the last :func:`reset_peaks`: the
    allocator's peak on a card, the peak of the samples on the CPU."""
    card = _card(device)
    if card is not None:
        return int(torch.cuda.max_memory_allocated(card))
    if refresh:
        device_bytes(refresh=True, device=device)
    return _device_peak


def rss_bytes() -> int:
    """CURRENT resident set size of this process. Gauges (heartbeats,
    /metrics) need the live value — a process that spiked and freed
    must read low again. Linux: /proc/self/status VmRSS; elsewhere the
    peak (:func:`peak_rss_bytes`) is the best available approximation."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return peak_rss_bytes()


def peak_rss_bytes() -> int:
    """Lifetime peak resident set size (ru_maxrss is KB on Linux,
    bytes on macOS) — the bench trajectory metric."""
    try:
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss if sys.platform == "darwin" else rss * 1024)
    except Exception:  # noqa: BLE001 - platforms without resource
        return 0


def reset_peaks() -> None:
    """Re-baseline the peak trackers (per-query profiling / tests).
    Current occupancy is kept — peaks restart from it."""
    global _peak_total, _device_peak
    with _lock:
        _peak_total = _current_total
        for k, v in _by_category.items():
            _peak_by_category[k] = v
    card = _card()
    if card is not None:
        torch.cuda.reset_peak_memory_stats(card)
    else:
        _device_peak = device_bytes(refresh=True)


def memory_snapshot() -> dict:
    """Full snapshot for artifacts / the health plane."""
    out = host_memory_snapshot()
    out["device_bytes"] = device_bytes()
    out["peak_device_bytes"] = peak_device_bytes()
    out["rss_bytes"] = rss_bytes()
    return out
