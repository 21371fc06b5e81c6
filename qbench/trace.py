"""The traced run's profile: one ``torch.profiler`` window over a slice
of the measured window, read into device intervals, CUDA runtime calls
and the harness's own spans on one clock.

The profiler records the card's kernels, copies and sets and the CUDA
runtime calls of every thread (CUPTI). The harness's spans (one per
query and one per call inside it) are kept by the harness itself, on
``time.time_ns()``, the clock the profiler's events carry, because the
profiler records annotations only on the thread that started it and the
cluster's sessions run on threads of their own.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

Interval = Tuple[int, int]


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    session: int


class Spans:
    """The harness's spans, kept in memory for the run's readers."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Span] = []

    @contextmanager
    def span(self, name: str, session: int):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.items.append(Span(name, t0, t1, session))


@dataclass
class Profile:
    """What one profiler window saw, clipped to ``[start_ns, end_ns]``."""

    start_ns: int
    end_ns: int
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    runtime: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def device_intervals(self) -> List[Interval]:
        return [(s, e) for _, s, e in self.device]


def union(intervals: List[Interval]) -> List[Interval]:
    """Disjoint, sorted cover of ``intervals``."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered_ns(intervals: List[Interval], lo: int, hi: int) -> int:
    """Nanoseconds of ``[lo, hi]`` that the union of ``intervals`` covers."""
    total = 0
    for s, e in union(intervals):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total += e - s
    return total


def gaps(intervals: List[Interval], lo: int, hi: int) -> List[Interval]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


class Profiler:
    """One ``torch.profiler`` window, opened before the measured window
    and closed after its slice."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        # without a card (the CPU rehearsal) the window records no device
        # work, and the device metrics read nothing
        activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                    else ProfilerActivity.CPU)
        self._prof = profile(activities=[activity])
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None

    def start(self) -> None:
        self._prof.start()

    def mark_start(self) -> None:
        self.start_ns = time.time_ns()

    def stop(self) -> None:
        self.end_ns = time.time_ns()
        self._prof.stop()

    def read(self) -> Profile:
        import torch

        prof = Profile(self.start_ns, self.end_ns)
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self._prof.profiler.kineto_results.events():
            s, e = ev.start_ns(), ev.end_ns()
            if e < self.start_ns or s > self.end_ns:
                continue
            item = (ev.name(), max(s, self.start_ns), min(e, self.end_ns))
            if ev.device_type() == cuda:
                prof.device.append(item)
            elif ev.name().startswith("cuda"):
                prof.runtime.append(item)
        return prof


def top_device_ops(profile: Profile, n: int = 10) -> List[list]:
    """The device operations that took most time: [name, seconds]."""
    by_name: Dict[str, int] = {}
    for name, s, e in profile.device:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in ranked]


def idle_gaps(profile: Profile, spans: List[Span], n: int = 10
              ) -> List[list]:
    """The longest stretches with nothing on the device, each named by
    the innermost harness span each session had open at its middle ("+"
    between sessions; "harness" where none is open): [name, seconds]."""
    found = gaps(profile.device_intervals(), profile.start_ns,
                 profile.end_ns)
    found.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in found[:n]:
        mid = (s + e) // 2
        inner: Dict[int, Span] = {}
        for sp in spans:
            if sp.start_ns <= mid <= sp.end_ns and (
                    sp.session not in inner
                    or sp.start_ns > inner[sp.session].start_ns):
                inner[sp.session] = sp
        names = sorted({sp.name for sp in inner.values()})
        out.append(["+".join(names) or "harness", (e - s) / 1e9])
    return out
