"""Checks on the CPU that governed programs could be captured as CUDA
graphs.

A CUDA graph holds the kernels a program launches and nothing else: a
read of a device value on the host (``.item()``, ``bool(t)``,
``.tolist()``, ``nonzero``, a boolean-mask index, ``bincount``) or an
upload of a host array inside the program fails the capture on a card.
The CPU cannot capture, so ``simulated_capture()`` runs every call of a
capturing namespace (``compile.governor.CAPTURE``) the way the card
would: the first call of a signature runs eagerly with the constants
arena recording (the warm-up), and every call, the first included, then
runs again under the capture flag with a torch function mode that
raises on any such operation and with the arena serving constants only
by content it recorded — a constant the arena lacks is one a replayed
graph would hold stale. The result handed back is the guarded run's.

Usage (tests): ``with simulated_capture(): ctx.sql(q).to_pydict()``.
"""

from __future__ import annotations

import contextlib
import importlib

import torch
from torch.overrides import TorchFunctionMode

# the module (the package re-exports a function under the same name)
gov = importlib.import_module("ballista_tpu_torch.compile.governor")

# torch functions and tensor methods that read a device value back to the
# host or upload host data: illegal while a CUDA graph is captured
_FORBIDDEN = {
    torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__bool__,
    torch.Tensor.__int__, torch.Tensor.__float__, torch.Tensor.__index__,
    torch.Tensor.cpu, torch.Tensor.numpy,
    torch.nonzero, torch.Tensor.nonzero, torch.masked_select,
    torch.Tensor.masked_select, torch.unique, torch.Tensor.unique,
    torch.bincount, torch.Tensor.bincount, torch.tensor, torch.as_tensor,
    torch.Tensor.unique_consecutive, torch.unique_consecutive,
}


class CaptureViolation(AssertionError):
    """A governed program did something a CUDA graph cannot hold."""


class _CaptureGuard(TorchFunctionMode):
    def __init__(self, key):
        super().__init__()
        self.key = key

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _FORBIDDEN:
            raise CaptureViolation(
                f"{getattr(func, '__name__', func)} inside the governed "
                f"program {gov._render_key(self.key)}")
        if func is torch.Tensor.__getitem__ and _has_bool_index(args[1]):
            raise CaptureViolation(
                f"boolean-mask indexing inside the governed program "
                f"{gov._render_key(self.key)}")
        if func is torch.repeat_interleave and "output_size" not in kwargs:
            raise CaptureViolation(
                f"repeat_interleave without output_size inside "
                f"{gov._render_key(self.key)}")
        return func(*args, **kwargs)


def _has_bool_index(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in items)


def _check(gf, args, prog):
    """One governed call as a card would run it (see the module doc)."""
    out = None
    if prog.arena is None:
        prog.arena = {}
        with gov._CaptureScope(prog.arena, None):
            out = gf.fn(*args)  # the warm-up
    real_from_numpy = torch.from_numpy

    def no_upload(*a, **kw):
        raise CaptureViolation(
            f"torch.from_numpy inside the governed program "
            f"{gov._render_key(gf.key)}")

    torch.from_numpy = no_upload
    try:
        with gov._CaptureScope(prog.arena, []), _CaptureGuard(gf.key):
            guarded = gf.fn(*args)
    except gov.CaptureError as e:
        raise CaptureViolation(str(e)) from e
    finally:
        torch.from_numpy = real_from_numpy
    del out
    return guarded


@contextlib.contextmanager
def simulated_capture():
    """Within the ``with``, governed calls on CPU tensors run through the
    capture check. Entries keep their programs, so the check starts from
    a cleared governor and clears it again on the way out."""
    gov.governor().clear()
    gov._cpu_capture_check = _check
    try:
        yield
    finally:
        gov._cpu_capture_check = None
        gov.governor().clear()


# ---------------------------------------------------------------------------
# the graph path on the CPU: torch.cuda's graph API emulated
# ---------------------------------------------------------------------------


class _FakeStream:
    def wait_stream(self, other) -> None:
        pass


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: records the aten calls of
    the capture with their tensors and Python arguments, and a replay
    runs them again on the same tensors, writing each result into the
    tensor the capture produced — the fixed addresses and frozen kernel
    arguments of a real graph, without the card. Reads of device values
    fail the capture, as on a card."""

    _SYNCING = ("_local_scalar_dense", "nonzero", "masked_select",
                "_unique", "unique_dim", "unique_consecutive")

    def __init__(self):
        self.ops = []
        self._recorder = None

    def capture_begin(self, pool=None, capture_error_mode=None) -> None:
        self._recorder = _Recorder(self)
        self._recorder.__enter__()

    def capture_end(self) -> None:
        self._recorder.__exit__(None, None, None)
        self._recorder = None

    def replay(self) -> None:
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            _write_back(out, new, args)


def _storages(args):
    out = set()
    for a in args:
        if isinstance(a, torch.Tensor):
            out.add(a.untyped_storage().data_ptr())
        elif isinstance(a, (list, tuple)):
            out |= _storages(a)
    return out


def _write_back(out, new, args) -> None:
    if isinstance(out, torch.Tensor):
        # an in-place op or a view wrote (or shows) the input's memory
        # already; anything else lands in the capture's own tensor
        if out is not new and out.untyped_storage().data_ptr() \
                not in _storages(args):
            out.copy_(new)
    elif isinstance(out, (list, tuple)):
        for o, n in zip(out, new):
            _write_back(o, n, args)


class _Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, graph: _FakeGraph):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _FakeGraph._SYNCING:
            raise RuntimeError(f"{name} reads a device value during "
                               f"capture")
        out = func(*args, **kwargs)
        self.graph.ops.append((func, args, kwargs, out))
        return out


@contextlib.contextmanager
def emulated_graphs(monkeypatch):
    """Within the ``with``, governed calls on CPU tensors take the card's
    path — warm-up, capture, replays with static buffers — through the
    stand-in graph above. ``monkeypatch`` is pytest's fixture."""
    gov.governor().clear()
    monkeypatch.setattr(gov, "_captures", lambda device: True)
    monkeypatch.setattr(gov, "_pool_and_side_stream",
                        lambda device: (None, _FakeStream()))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    try:
        yield
    finally:
        monkeypatch.undo()
        gov.governor().clear()
