"""The benchmark's generator against the repository's TPC-H generator:
the same seed gives the same files, and the files parse back to the
arrays the benchmark's reference reads."""

import importlib.util
import os

import numpy as np
import pyarrow.csv as pcsv
import pytest

from qbench.data import generate

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _datagen():
    path = os.path.join(REPO, "benchmarks", "tpch", "datagen.py")
    spec = importlib.util.spec_from_file_location("_datagen_for_qbench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen")
    seed = 2**31 + 5
    _datagen().generate(str(root / "datagen"), scale=0.01, num_parts=1,
                        seed=seed)
    data, wrote = generate.ensure_data(str(root / "qbench"), 0.01, seed,
                                       generate.COLUMNS)
    assert wrote
    return root, data


@pytest.mark.parametrize("table", sorted(generate.COLUMNS))
def test_files_equal_datagen(both, table):
    root, _ = both
    with open(root / "datagen" / table / "partition0.tbl", "rb") as f:
        want = f.read()
    with open(root / "qbench" / f"{table}.tbl", "rb") as f:
        got = f.read()
    assert got == want


@pytest.mark.parametrize("table", sorted(generate.COLUMNS))
def test_files_parse_back_to_arrays(both, table):
    root, data = both
    names = list(generate.COLUMNS[table]) + ["_end"]
    text = pcsv.read_csv(
        root / "qbench" / f"{table}.tbl",
        read_options=pcsv.ReadOptions(column_names=names),
        parse_options=pcsv.ParseOptions(delimiter="|"),
        convert_options=pcsv.ConvertOptions(
            column_types={n: "string" for n in names}))
    for name in generate.COLUMNS[table]:
        cells = np.asarray(text[name].to_pylist(), dtype=object)
        col = data[table][name]
        if isinstance(col, generate.Coded):
            want = col.strings()
        elif not isinstance(col, np.ndarray):
            want = np.asarray(col.to_pylist(), dtype=object)
        elif name in generate.DECIMALS:
            cents = [int(round(float(c) * 100)) for c in cells]
            assert cents == col.tolist(), name
            continue
        elif name in generate.DATES:
            days = np.asarray(cells.astype("datetime64[D]"), dtype=np.int64)
            assert days.tolist() == col.tolist(), name
            continue
        else:
            assert [int(c) for c in cells] == col.tolist(), name
            continue
        assert cells.tolist() == want.tolist(), name


def test_same_seed_reuses_files_and_another_replaces_them(tmp_path):
    d = str(tmp_path / "sf")
    _, wrote = generate.ensure_data(d, 0.01, 7, ["nation", "region"])
    assert wrote
    _, wrote = generate.ensure_data(d, 0.01, 7, ["nation", "region"])
    assert not wrote
    open(os.path.join(d, "stale.tbl"), "w").close()
    _, wrote = generate.ensure_data(d, 0.01, 8, ["nation", "region"])
    assert wrote
    assert sorted(os.listdir(d)) == [".complete", "nation.tbl", "region.tbl"]
