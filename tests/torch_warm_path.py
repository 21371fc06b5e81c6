"""Shared helpers of the port's tests (``test_torch_ingest.py``,
``test_torch_cache.py``, ``test_torch_lifecycle.py`` and the thread pin
of every file that runs queries): TPC-H SF0.002 data, contexts of the
port on the CPU and of the JAX package, and the comparisons. The JAX package is imported only inside the functions that
run it, so the card-only tests of those files import without it."""

import hashlib
import os
from contextlib import contextmanager

import numpy as np
import torch

QDIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "tpch",
                    "queries")
WARM_QUERIES = ["q1", "q3", "q5", "q16"]


_PINNED_ENV = ("BALLISTA_INGEST_THREADS", "BALLISTA_SCAN_THREADS")


@contextmanager
def pinned_threads(n: int = 2):
    """``n`` torch threads, ``n`` ingest-pool workers and ``n`` scanner
    threads per file, the ingest config re-read on the way in and out.
    The tier runs its files in parallel worker processes on one machine:
    a file of the port's queries then takes ``n`` cores, not every core,
    and does not starve the timing-gated tests beside it."""
    from ballista_tpu_torch import ingest

    prev_threads = torch.get_num_threads()
    prev_env = {k: os.environ.get(k) for k in _PINNED_ENV}
    torch.set_num_threads(n)
    for k in _PINNED_ENV:
        os.environ[k] = str(n)
    ingest.reconfigure()
    try:
        yield
    finally:
        torch.set_num_threads(prev_threads)
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        ingest.reconfigure()


def sql(q: str) -> str:
    return open(os.path.join(QDIR, f"{q}.sql")).read()


def generate_tpch(directory: str) -> str:
    from benchmarks.tpch import datagen

    datagen.generate(directory, scale=0.002, num_parts=2)
    return directory


def port_ctx(data_dir: str, **settings):
    """The port's standalone context on the CPU over the TPC-H tables."""
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    ctx = BallistaContext.standalone(device="cpu", **settings)
    register_tpch(ctx, data_dir)
    return ctx


def reference_result(data_dir: str, q: str):
    """The JAX package's result of ``q`` (a pandas frame)."""
    from ballista_tpu.client import BallistaContext as ReferenceContext
    from benchmarks.tpch.schema_def import register_tpch

    ref = ReferenceContext.standalone()
    register_tpch(ref, data_dir, "tbl")
    return ref.sql(sql(q)).collect()


def assert_equals_reference(got, want) -> None:
    """``got`` (the port's to_pydict) against the JAX package's frame:
    integer, decimal, date and string columns exactly, floats within
    rtol 1e-6 (the parity bar)."""
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        g = got[c]
        assert g.shape == w.shape, c
        if w.dtype.kind == "f":
            assert g.dtype.kind == "f", c
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=c)
        elif w.dtype.kind == "M":  # pandas holds dates at second precision
            assert g.dtype == np.dtype("datetime64[D]"), c
            np.testing.assert_array_equal(g, w.astype("datetime64[D]"),
                                          err_msg=c)
        else:
            assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=c)


def assert_identical(a: dict, b: dict, tag: str = "") -> None:
    """Two results of the port, byte for byte."""
    assert list(a) == list(b), tag
    for c in a:
        ga, gb = np.asarray(a[c]), np.asarray(b[c])
        assert ga.dtype == gb.dtype, f"{tag}.{c}: {ga.dtype} vs {gb.dtype}"
        assert ga.shape == gb.shape, f"{tag}.{c}"
        if ga.dtype.kind == "O":
            assert list(ga) == list(gb), f"{tag}.{c}"
        else:
            assert ga.tobytes() == gb.tobytes(), f"{tag}.{c}"


def reset_port_caches() -> None:
    """Empty the port's table and result caches, zero their counters."""
    from ballista_tpu_torch.cache import reset_cache_stats
    from ballista_tpu_torch.cache import residency, results

    residency._reset_for_tests()
    results._reset_for_tests()
    reset_cache_stats()


def tensor_fingerprint(t: torch.Tensor) -> tuple:
    """(``_version``, sha1 of the bytes) of a CPU tensor."""
    flat = t.detach().reshape(-1).contiguous().view(torch.uint8)
    return t._version, hashlib.sha1(flat.numpy().tobytes()).hexdigest()


def pinned_fingerprints() -> dict:
    """id(tensor) -> (tensor, fingerprint) for every tensor the port's
    table cache pins now."""
    from ballista_tpu_torch.cache.residency import (batch_tensors,
                                                    process_table_cache)

    out = {}
    for b in process_table_cache().pinned_batches():
        for t in batch_tensors(b):
            out[id(t)] = (t, tensor_fingerprint(t))
    return out


def scan_nodes(phys) -> list:
    from ballista_tpu_torch.physical.operators import ScanExec

    out = [phys] if isinstance(phys, ScanExec) else []
    for c in phys.children():
        out += scan_nodes(c)
    return out


def scanned_partitions(phys) -> int:
    """Scan partitions a collect of ``phys`` reads."""
    return sum(s.source.num_partitions() for s in scan_nodes(phys))
