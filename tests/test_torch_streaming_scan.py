"""Byte-range streaming of large files in the port (``ballista_tpu_torch/
io/text.py``), on the CPU, against the JAX package.

A file larger than ``STREAM_CHUNK_BYTES`` streams through the native
scanner in byte ranges (adjacent ranges partition the rows exactly) and
its utf8 codes are remapped onto table-wide dictionaries built by one
shared pre-pass. A tiny chunk size on small data runs the path large
files take. The three cases of ``tests/test_streaming_scan.py`` run on
both packages and must agree; the port adds that a streamed file
bypasses the table cache and that every batch of every chunk carries
one ``Dictionary`` object per column.
"""

import numpy as np
import pytest

import ballista_tpu as ref_pkg
from ballista_tpu.client import BallistaContext as ReferenceContext
from ballista_tpu.io import TblSource as RefTblSource
from ballista_tpu.io import text as ref_text

import ballista_tpu_torch as bt
from ballista_tpu_torch.cache import residency
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.io import TblSource
from ballista_tpu_torch.io import text

from torch_warm_path import (assert_equals_reference, pinned_threads,
                             reset_port_caches)


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """Two torch, ingest and scanner threads for this file's queries
    (``torch_warm_path.pinned_threads``)."""
    with pinned_threads():
        yield


@pytest.fixture(autouse=True)
def tiny_chunks(monkeypatch):
    monkeypatch.setattr(text, "STREAM_CHUNK_BYTES", 512)
    monkeypatch.setattr(ref_text, "STREAM_CHUNK_BYTES", 512)
    reset_port_caches()
    yield
    reset_port_caches()


def _write(tmp_path, rows, name="t.tbl"):
    p = tmp_path / name
    p.write_text("".join(f"{i}|k{i % 7}|{i * 3}|\n" for i in rows))
    return str(p)


def _schema(pkg):
    return pkg.schema(("a", pkg.Int64), ("c", pkg.Utf8), ("b", pkg.Int64))


def _contexts(path):
    port = BallistaContext.standalone(device="cpu")
    port.register_source("t", TblSource(path, _schema(bt), device="cpu"))
    ref = ReferenceContext.standalone()
    ref.register_source("t", RefTblSource(path, _schema(ref_pkg)))
    return port, ref


def test_streaming_matches_whole_file(tmp_path):
    path = _write(tmp_path, range(500))
    src = TblSource(path, _schema(bt), device="cpu")
    assert src.residency_key(0, ["a", "c", "b"]) is None
    batches = list(src.scan(0, ["a", "c", "b"]))
    assert len(batches) > 1  # actually streamed in several ranges
    # one Dictionary object for every batch of every chunk
    assert len({id(b.column("c").dictionary) for b in batches}) == 1
    d = batches[0].column("c").dictionary
    assert sorted(str(v) for v in d.values) == [f"k{i}" for i in range(7)]
    got = {k: np.concatenate([b.to_pydict()[k] for b in batches])
           for k in ("a", "c", "b")}
    np.testing.assert_array_equal(got["a"], np.arange(500))
    np.testing.assert_array_equal(got["b"], np.arange(500) * 3)
    assert list(got["c"][:14]) == [f"k{i % 7}" for i in range(14)]
    # the JAX package streams the same rows in the same batches
    ref = list(RefTblSource(path, _schema(ref_pkg)).scan(0, ["a", "c", "b"]))
    assert [b.capacity for b in batches] == [b.capacity for b in ref]
    want = {k: np.concatenate([np.asarray(b.to_pydict()[k]) for b in ref])
            for k in ("a", "c", "b")}
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[k], want[k])
    assert list(got["c"]) == list(want["c"])


def test_streaming_query_end_to_end(tmp_path):
    """Aggregation over a streamed table == the JAX package == oracle."""
    port, ref = _contexts(_write(tmp_path, range(400)))
    q = "SELECT c, sum(a) AS s, count(*) AS n FROM t GROUP BY c ORDER BY c"
    out = port.sql(q).to_pydict()
    assert_equals_reference(out, ref.sql(q).collect())
    a = np.arange(400)
    for i in range(7):
        m = a % 7 == i
        assert out["c"][i] == f"k{i}"
        assert int(out["s"][i]) == int(a[m].sum())
        assert int(out["n"][i]) == int(m.sum())


def test_streaming_nulls(tmp_path):
    """NULLs (empty fields) surface as validity across range boundaries."""
    p = tmp_path / "n.tbl"
    p.write_text("".join(f"{i}|x{i % 3}||\n" if i % 5 == 0
                         else f"{i}|x{i % 3}|{i}|\n" for i in range(300)))
    port, ref = _contexts(str(p))
    q = ("SELECT c, count(b) AS nb, count(*) AS n FROM t "
         "GROUP BY c ORDER BY c")
    out = port.sql(q).to_pydict()
    assert_equals_reference(out, ref.sql(q).collect())
    assert int(out["n"].sum()) == 300
    assert int(out["nb"].sum()) == 240


def test_streamed_file_bypasses_the_table_cache(tmp_path):
    """Two collects of a streamed table parse twice and pin nothing; the
    same file under the chunk size is cached and served."""
    path = _write(tmp_path, range(500))
    port, _ = _contexts(path)
    q = "SELECT c, sum(b) AS s FROM t GROUP BY c ORDER BY c"
    df = port.sql(q)
    first = df.to_pydict()
    second = df.to_pydict()
    stats = residency.process_table_cache().stats()
    assert stats["entries"] == 0 and stats["resident_bytes"] == 0, stats
    assert stats["fills"] == 0 and stats["hits"] == 0
    assert port.cache_hits["table"] == 0
    for k in first:
        assert list(first[k]) == list(second[k])
    text.STREAM_CHUNK_BYTES = 1 << 30  # the whole-file path caches
    df = port.sql(q)
    df.to_pydict()
    assert list(df.to_pydict()["s"]) == list(first["s"])
    assert residency.process_table_cache().stats()["entries"] == 1
    assert port.cache_hits["table"] == 1


def test_streamed_file_in_a_directory_shares_table_dictionaries(tmp_path):
    """A two-file table whose second file streams: one dictionary per
    column across both partitions' batches, rows equal the JAX
    package's."""
    d = tmp_path / "t"
    d.mkdir()
    _write(d, range(0, 20), "0.tbl")      # under the chunk size
    _write(d, range(20, 420), "1.tbl")    # streamed
    src = TblSource(str(d), _schema(bt), device="cpu")
    assert src.residency_key(0) is not None
    assert src.residency_key(1) is None
    batches = [b for p in range(2) for b in src.scan(p, ["a", "c"])]
    assert len({id(b.column("c").dictionary) for b in batches}) == 1
    port, ref = _contexts(str(d))
    q = "SELECT c, sum(a) AS s, count(*) AS n FROM t GROUP BY c ORDER BY c"
    assert_equals_reference(port.sql(q).to_pydict(), ref.sql(q).collect())
