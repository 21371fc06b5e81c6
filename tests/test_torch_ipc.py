"""The port's Arrow IPC shuffle files (``ballista_tpu_torch/io/ipc.py``)
against the JAX package's (``ballista_tpu/io/ipc.py``).

One batch per column kind (nullable int64 beyond 2^53, decimal with
NULLs, date with NULLs, utf8, a fixed-size list of decimals, a float64)
is built in both packages from the same host arrays. Each round-trips
through the port; the port's file is read by the JAX package
(``read_partition_arrays`` + ``batches_from_parts``) and the JAX
package's file by the port, each equal to the writer's batch; the two
packages write the same bytes and the same column statistics. Then
``PartitionWriter``'s bounded record batches, the reader's legacy-format
sniffing, and the dictionary registry's identity across shuffle reads.

Tolerance: exact (integers, scaled decimals, dates, dictionary values
and float64 values are copied, never computed).
"""

import numpy as np
import pytest

import ballista_tpu as ref_pkg
from ballista_tpu.columnar import ColumnBatch as RefBatch
from ballista_tpu.columnar import Dictionary as RefDictionary
from ballista_tpu.io import ipc as ref_ipc

import ballista_tpu_torch as bt
from ballista_tpu_torch import columnar_registry
from ballista_tpu_torch.columnar import ColumnBatch, Dictionary
from ballista_tpu_torch.io import ipc

BIG = (1 << 60) + 12345  # not representable in float64


def _case(kind):
    """(schema spec, host arrays, validity, dictionary values) of one
    kind; the spec is (name, type name) resolved in either package."""
    n = 11
    valid = np.array([i % 4 != 2 for i in range(n)])
    if kind == "int64":
        vals = np.array([BIG + i if i % 3 else -i for i in range(n)],
                        dtype=np.int64)
        return ("Int64", None), vals, valid, None
    if kind == "decimal":
        vals = np.arange(n, dtype=np.int64) * 12345 - 40000
        return ("Decimal", 2), vals, valid, None
    if kind == "date":
        vals = (np.arange(n, dtype=np.int32) * 97 + 8000).astype(np.int32)
        return ("Date32", None), vals, valid, None
    if kind == "utf8":
        words = np.array(["AIR", "MAIL", "RAIL", "SHIP", "TRUCK"],
                         dtype=object)
        codes = (np.arange(n) * 3 % 5).astype(np.int32)
        return ("Utf8", None), codes, None, words
    if kind == "list":
        vals = np.arange(n * 3, dtype=np.int64).reshape(n, 3) * 7 - 11
        return ("List", 3), vals, valid, None
    if kind == "float64":
        vals = np.linspace(-3.5, 1e12, n)
        return ("Float64", None), vals, valid, None
    raise AssertionError(kind)


KINDS = ["int64", "decimal", "date", "utf8", "list", "float64"]
# the JAX package cannot write a fixed-size list with NULLs (see
# test_reference_cannot_write_nullable_list): across the packages the
# list case has none
CROSS_KINDS = ["int64", "decimal", "date", "utf8", "list-nonnull",
               "float64"]


def _dtype(pkg, spec):
    name, arg = spec
    if name == "Decimal":
        return pkg.Decimal(arg)
    if name == "List":
        from importlib import import_module

        dt = import_module(pkg.__name__ + ".datatypes")
        return dt.FixedSizeList(pkg.Decimal(2), arg)
    return getattr(pkg, name)


def _batches(kind):
    spec, vals, valid, words = _case(kind.replace("-nonnull", ""))
    if kind.endswith("-nonnull"):
        valid = None
    validity = {"v": valid} if valid is not None else None
    mine = ColumnBatch.from_numpy(
        bt.schema(("v", _dtype(bt, spec)), ("k", bt.Int64)),
        {"v": vals, "k": np.arange(len(vals), dtype=np.int64)},
        {"v": Dictionary(words)} if words is not None else None,
        capacity=16, validity=validity, device="cpu")
    theirs = RefBatch.from_numpy(
        ref_pkg.schema(("v", _dtype(ref_pkg, spec)), ("k", ref_pkg.Int64)),
        {"v": vals, "k": np.arange(len(vals), dtype=np.int64)},
        {"v": RefDictionary(words)} if words is not None else None,
        capacity=16, validity=validity)
    return mine, theirs


def _ref_pydict(batch):
    out = batch.to_pydict()
    return {k: np.asarray(v) for k, v in out.items()}


def _equal_pydicts(a, b, tag):
    assert list(a) == list(b), tag
    for c in a:
        ga, gb = np.asarray(a[c]), np.asarray(b[c])
        assert ga.shape == gb.shape, (tag, c)
        if ga.dtype.kind == "O":
            for x, y in zip(ga, gb):
                if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                    np.testing.assert_array_equal(x, y, err_msg=f"{tag}.{c}")
                else:
                    assert (x is None and y is None) or x == y, (tag, c)
        else:
            np.testing.assert_array_equal(ga, gb, err_msg=f"{tag}.{c}")


@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip_in_port(tmp_path, kind):
    mine, _ = _batches(kind)
    path = str(tmp_path / "p" / "data.arrow")
    ipc.write_partition(path, [mine])
    _, arrays, nulls, dicts, _ = ipc.read_partition_arrays(path)
    if kind == "int64":
        assert arrays["v"].dtype == np.int64
        assert arrays["v"][1] == BIG + 1  # exact, no float64 detour
    back = ipc.batches_from_parts(mine.schema, [(arrays, nulls, dicts)],
                                  device="cpu")
    assert len(back) == 1
    _equal_pydicts(back[0].to_pydict(), mine.to_pydict(), kind)


@pytest.mark.parametrize("kind", CROSS_KINDS)
def test_port_file_read_by_reference(tmp_path, kind):
    mine, theirs = _batches(kind)
    path = str(tmp_path / "p" / "data.arrow")
    ipc.write_partition(path, [mine])
    _, arrays, nulls, dicts, _ = ref_ipc.read_partition_arrays(path)
    got = ref_ipc.batches_from_parts(theirs.schema, [(arrays, nulls, dicts)])
    _equal_pydicts(_ref_pydict(got[0]), mine.to_pydict(), kind)


@pytest.mark.parametrize("kind", CROSS_KINDS)
def test_reference_file_read_by_port(tmp_path, kind):
    mine, theirs = _batches(kind)
    path = str(tmp_path / "r" / "data.arrow")
    ref_ipc.write_partition(path, [theirs])
    _, arrays, nulls, dicts, _ = ipc.read_partition_arrays(path)
    got = ipc.batches_from_parts(mine.schema, [(arrays, nulls, dicts)],
                                 device="cpu")
    _equal_pydicts(got[0].to_pydict(), _ref_pydict(theirs), kind)


@pytest.mark.parametrize("kind", CROSS_KINDS)
def test_same_bytes_and_column_stats(tmp_path, kind):
    mine, theirs = _batches(kind)
    p1, p2 = str(tmp_path / "a" / "x.arrow"), str(tmp_path / "b" / "x.arrow")
    st1 = ipc.write_partition(p1, [mine])
    st2 = ref_ipc.write_partition(p2, [theirs])
    assert st1 == st2
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_reference_cannot_write_nullable_list(tmp_path):
    """A deliberate divergence: the JAX package hands pyarrow a numpy
    mask for a fixed-size list, which pyarrow refuses; the port passes an
    Arrow mask and writes it (``test_roundtrip_in_port[list]``)."""
    _, theirs = _batches("list")
    with pytest.raises(TypeError, match="Mask"):
        ref_ipc.write_partition(str(tmp_path / "r" / "x.arrow"), [theirs])


def test_shuffle_split_files_equal_reference(tmp_path):
    """The shuffle write's per-output-partition masks: each q's file
    holds exactly the rows whose id is q, in both packages."""
    from ballista_tpu.kernels.expr_eval import Evaluator as RefEvaluator
    from ballista_tpu.physical.operators import \
        compute_partition_ids as ref_ids
    import jax.numpy as jnp

    from ballista_tpu_torch.kernels.expr_eval import Evaluator
    from ballista_tpu_torch.physical.operators import compute_partition_ids

    mine, theirs = _batches("utf8")
    ids = compute_partition_ids(mine, [bt.col("v")], 3, 0,
                                Evaluator(mine.schema))
    rids = ref_ids(theirs, [ref_pkg.col("v")], 3, 0,
                   RefEvaluator(theirs.schema))
    for q in range(3):
        a, b = str(tmp_path / f"m{q}.arrow"), str(tmp_path / f"r{q}.arrow")
        ipc.write_partition(a, [mine.with_selection(
            mine.selection & (ids == q))])
        ref_ipc.write_partition(b, [theirs.with_selection(
            jnp.logical_and(theirs.selection, rids == q))])
        assert open(a, "rb").read() == open(b, "rb").read(), q


def test_partition_writer_bounds_record_batches(tmp_path):
    s = bt.schema(("a", bt.Int64), ("k", bt.Utf8))
    b = ColumnBatch.from_pydict(s, {"a": list(range(5000)),
                                    "k": [f"v{i % 7}" for i in range(5000)]},
                                device="cpu")
    whole = str(tmp_path / "whole" / "data.arrow")
    sliced = str(tmp_path / "sliced" / "data.arrow")
    ipc.write_partition(whole, [b])
    w = ipc.PartitionWriter(sliced, chunk_bytes=4096)
    w.write_batch(b)
    st = w.close()
    assert st["num_batches"] > 4, "a 4 KiB bound must split the batch"
    n1, a1, _, _, _ = ipc.read_partition_arrays(whole)
    _, a2, _, _, _ = ipc.read_partition_arrays(sliced)
    for name in n1:
        assert np.array_equal(a1[name], a2[name]), name


def test_reader_sniffs_legacy_file_format(tmp_path):
    import pyarrow as pa

    s = bt.schema(("a", bt.Int64))
    b = ColumnBatch.from_pydict(s, {"a": list(range(100))}, device="cpu")
    rb = ipc.batch_to_arrow(b)
    path = str(tmp_path / "legacy.arrow")
    with pa.OSFile(path, "wb") as sink:
        with pa.ipc.new_file(sink, rb.schema) as writer:
            writer.write_batch(rb)
    _, arrays, _, _, kinds = ipc.read_partition_arrays(path)
    assert list(arrays["a"]) == list(range(100))
    assert kinds["a"] == ("int64", 0)
    stream_path = str(tmp_path / "s" / "data.arrow")
    ipc.write_partition(stream_path, [b])
    _, arrays2, _, _, _ = ipc.read_partition_arrays(
        open(stream_path, "rb").read())
    assert np.array_equal(arrays2["a"], arrays["a"])


def test_empty_partition_writer_needs_schema(tmp_path):
    from ballista_tpu_torch.errors import IoError

    s = bt.schema(("a", bt.Int64), ("k", bt.Utf8))
    w = ipc.PartitionWriter(str(tmp_path / "e" / "data.arrow"), schema=s)
    assert w.close()["num_rows"] == 0
    with pytest.raises(IoError):
        ipc.PartitionWriter(str(tmp_path / "f" / "data.arrow")).close()


def test_shuffle_reads_keep_dictionary_identity(tmp_path):
    """Two reads of equal utf8 content give the same ``Dictionary``
    object (the registry adopts by content), so a governed program
    keyed on dictionary identity keeps its signature."""
    mine, _ = _batches("utf8")
    path = str(tmp_path / "p" / "data.arrow")
    ipc.write_partition(path, [mine])
    reads = []
    for _ in range(2):
        parts = [ipc.read_partition_arrays(path)[1:4]]
        reads.append(ipc.batches_from_parts(mine.schema, parts,
                                            device="cpu")[0])
    d0, d1 = (b.column("v").dictionary for b in reads)
    assert d0 is d1
    assert list(d0.values) == list(mine.column("v").dictionary.values)
    # a union of two producers is cached too
    other = ColumnBatch.from_pydict(
        bt.schema(("v", bt.Utf8), ("k", bt.Int64)),
        {"v": ["BOAT", "MAIL"], "k": [1, 2]}, device="cpu")
    p2 = str(tmp_path / "q" / "data.arrow")
    ipc.write_partition(p2, [other])
    unions = []
    for _ in range(2):
        parts = [ipc.read_partition_arrays(p)[1:4] for p in (path, p2)]
        unions.append(ipc.batches_from_parts(mine.schema, parts,
                                             device="cpu"))
    assert unions[0][0].column("v").dictionary is \
        unions[1][1].column("v").dictionary
    got = np.concatenate([b.to_pydict()["v"] for b in unions[0]])
    want = np.concatenate([mine.to_pydict()["v"], other.to_pydict()["v"]])
    assert list(got) == list(want)
    assert columnar_registry.REGISTRY.stats()["unions"] >= 1


def test_concat_unifies_through_the_registry():
    """``concat_batches`` of batches with different dictionaries: one
    cached union per content set, codes remapped on the device."""
    from ballista_tpu_torch.physical.base import concat_batches

    s = bt.schema(("v", bt.Utf8))
    a = ColumnBatch.from_pydict(s, {"v": ["x", "z"]}, device="cpu")
    b = ColumnBatch.from_pydict(s, {"v": ["y", "x"]}, device="cpu")
    one, two = concat_batches(s, [a, b]), concat_batches(s, [a, b])
    assert one.column("v").dictionary is two.column("v").dictionary
    assert list(one.to_pydict()["v"]) == ["x", "z", "y", "x"]
