"""The frozen reference queries against the pandas oracles they were
frozen from (``benchmarks/tpch/oracle.py``, run from its own source with
stub schemas), and the float64 control against the exact reference."""

import json
import os
import types

import numpy as np
import pytest

from qbench import check, control
from qbench.data import generate
from qbench.reference import Num, load

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCHEMA_IMPORT = "from .schema_def import TPCH_SCHEMAS"


class _Field:
    def __init__(self, name, kind):
        self.name = name
        self.dtype = types.SimpleNamespace(kind=kind)


class _Schema:
    def __init__(self, cols):
        self.fields = [_Field(n, k) for n, k in cols]

    def names(self):
        return [f.name for f in self.fields]

    def __len__(self):
        return len(self.fields)


def _oracle():
    with open(os.path.join(REPO, "qbench", "data", "schema.json")) as f:
        spec = json.load(f)
    path = os.path.join(REPO, "benchmarks", "tpch", "oracle.py")
    with open(path) as f:
        src = f.read()
    assert src.count(SCHEMA_IMPORT) == 1
    mod = types.ModuleType("_oracle_for_qbench")
    mod.__dict__["TPCH_SCHEMAS"] = {t: _Schema(c)
                                    for t, c in spec["columns"].items()}
    exec(compile(src.replace(SCHEMA_IMPORT, ""), path, "exec"), mod.__dict__)
    return mod


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sf001"))
    tables, _ = generate.ensure_data(d, 0.01, 4242, generate.COLUMNS)
    oracle = _oracle()
    return tables, oracle.load_tables(d), oracle


@pytest.mark.parametrize("q", control.MIX)
def test_reference_equals_oracle(data, q):
    tables, frames, oracle = data
    mod = load(q)
    got = control.ordered(mod, mod.compute(tables, Num(True)))
    want = getattr(oracle, q)(frames)
    assert list(want.columns) == list(mod.COLUMNS)
    assert len(want) == len(got[mod.COLUMNS[0]])
    for c in mod.COLUMNS:
        w = want[c].to_numpy()
        g = np.asarray(got[c])
        if c in mod.DECIMALS:
            # the oracle sums in float64 and does not truncate avg
            np.testing.assert_allclose(g, w.astype(float), rtol=1e-6,
                                       atol=1e-6, err_msg=c)
        elif g.dtype.kind == "M":
            assert (g.astype("datetime64[D]")
                    == w.astype("datetime64[D]")).all(), c
        else:
            assert [check._canon(x) for x in g] == [
                check._canon(x) for x in w], c


@pytest.mark.parametrize("q", control.MIX)
def test_reference_holds_to_itself(data, q):
    tables = data[0]
    mod = load(q)
    full = mod.compute(tables, Num(True))
    assert check.Expected(mod, full).hold(control.ordered(mod, full)) == (
        None, 0.0)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_float64_control_is_not_correct(seed):
    got = control.readings(generate.generate(0.01, seed))
    assert got["decimal_gap_ulp"] > 0


def test_comparison_catches_wrong_answers(data):
    tables = data[0]
    mod = load("q3")
    full = mod.compute(tables, Num(True))
    want = check.Expected(mod, full)
    good = control.ordered(mod, full)
    assert want.hold(good) == (None, 0.0)
    nudged = {c: v.copy() for c, v in good.items()}
    nudged["revenue"][0] = np.nextafter(nudged["revenue"][0], np.inf)
    assert want.hold(nudged) == (None, 1.0)
    swapped = {c: v[::-1].copy() for c, v in good.items()}
    assert "out of order" in want.hold(swapped)[0]
    short = {c: v[:-1] for c, v in good.items()}
    assert "rows" in want.hold(short)[0]
    other = {c: v.copy() for c, v in good.items()}
    other["o_shippriority"][2] += 1
    assert "o_shippriority" in want.hold(other)[0]
    renamed = dict(good)
    renamed["rev"] = renamed.pop("revenue")
    assert "columns" in want.hold(renamed)[0]
