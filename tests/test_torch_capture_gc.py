"""The governor pauses Python's cyclic garbage collector while it
captures a CUDA graph (``compile/governor.py::_collector_paused``).

A ``CUDAGraph`` destroyed on the capturing thread while another graph
is being captured invalidates that capture: the port's benchmark once
raised ``CaptureError`` ("operation failed due to a previous error
during capture") on the H100, after torch warned that a graph was reset
while a stream was capturing. The collector is what can run such a
destructor in the middle of a capture; torch's own ``torch.cuda.graph``
collects before each capture instead. Here: the pause itself, on the
CPU (captures need a card).
"""

import gc
import importlib

import pytest

gov = importlib.import_module("ballista_tpu_torch.compile.governor")


def test_collector_paused_and_restored():
    assert gc.isenabled()
    with gov._collector_paused():
        assert not gc.isenabled()
    assert gc.isenabled()


def test_collector_restored_after_an_exception():
    with pytest.raises(RuntimeError):
        with gov._collector_paused():
            raise RuntimeError("inside")
    assert gc.isenabled()


def test_collector_left_off_when_the_caller_had_it_off():
    gc.disable()
    try:
        with gov._collector_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()
