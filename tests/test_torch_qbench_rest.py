"""The 13 exact TPC-H queries of the benchmark's ``sf1-warm-rest13`` cell
(``qbench/traffic/warm-rest-1s.json``) at SF0.01 on the CPU.

- the port's standalone context over ``qbench/data``'s eight tables, each
  in ``CacheSource`` as the cell's configuration deploys them, held to
  the NumPy reference (``qbench/reference/``) by the benchmark's own
  comparison (``qbench/check.py``): no wrong answer, 0 ulp;
- each reference against the pandas oracle it was frozen from
  (``benchmarks/tpch/oracle.py``), as ``qbench/tests`` does for the six of
  the other cells;
- the latency ledger's ``operators`` key and ``join_counters()``: the
  semi, anti, outer and decorrelated joins each query plans, and their
  seconds;
- a warm collect builds no program.

The ``test_cuda_*`` tests run the 13 at SF0.05 on a card against the
reference, and read the device bytes in use there. They skip here;
``python3 -m ballista_tpu_torch.testing.card_checks`` runs them on the
card."""

import json
import os

import numpy as np
import pytest
import torch

from qbench import check, control, deploy
from qbench.data import generate
from qbench.reference import Num, load

from torch_warm_path import pinned_threads

ROOT = os.path.join(os.path.dirname(__file__), "..")
with open(os.path.join(ROOT, "qbench", "traffic", "warm-rest-1s.json")) as f:
    REST = json.load(f)["mix"]
SEED = 2**31 + 1717

# the joins that record spans and counters in each query's plan
# (physical/join.py::join_kind); the others plan inner joins only
KINDS = {
    "q2": {"inner.scalar"},
    "q4": {"semi"},
    "q13": {"left"},
    "q16": {"anti_null_aware"},
    "q18": {"semi"},
    "q20": {"semi", "inner.scalar"},
    "q21": {"left.exists"},
    "q22": {"anti"},
}


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    with pinned_threads():
        yield


def _sql(q):
    with open(os.path.join(ROOT, "qbench", "queries", f"{q}.sql")) as f:
        return f.read()


def _context(data_dir, device):
    from ballista_tpu_torch.client import BallistaContext

    ctx = BallistaContext.standalone(device=device)
    deploy.register(ctx, data_dir, list(generate.COLUMNS), True)
    return ctx


@pytest.fixture(scope="module")
def sf001(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rest_sf001"))
    tables, _ = generate.ensure_data(d, 0.01, SEED, generate.COLUMNS)
    return d, tables


@pytest.fixture(scope="module")
def port(sf001):
    return _context(sf001[0], "cpu")


@pytest.mark.parametrize("q", REST)
def test_port_holds_to_the_reference(sf001, port, q):
    mod = load(q)
    want = check.Expected(mod, mod.compute(sf001[1], Num(True)))
    for _ in range(2):  # the first collect plans, the second reuses it
        assert want.hold(port.sql(_sql(q)).to_pydict()) == (None, 0.0)


@pytest.mark.parametrize("q", REST)
def test_reference_equals_oracle(sf001, q):
    from qbench.tests.test_qbench_reference import _oracle

    oracle = _oracle()
    mod = load(q)
    got = control.ordered(mod, mod.compute(sf001[1], Num(True)))
    want = getattr(oracle, q)(oracle.load_tables(sf001[0]))
    assert list(want.columns) == list(mod.COLUMNS)
    assert len(want) == len(got[mod.COLUMNS[0]]) > 0
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
    # and the comparison holds the reference to itself
    full = mod.compute(sf001[1], Num(True))
    assert check.Expected(mod, full).hold(control.ordered(mod, full)) == (
        None, 0.0)


@pytest.mark.parametrize("q", REST)
def test_ledger_operators(port, q):
    from ballista_tpu_torch.physical.join import join_counters

    before = join_counters()
    port.sql(_sql(q)).to_pydict()
    after = join_counters()
    led = port.last_query_ledger()
    ops = led["operators"]
    kinds = KINDS.get(q, set())
    joins = {k.split(".", 2)[2] for k in ops if k.startswith("join.")}
    assert joins == kinds, ops
    for kind in kinds:
        for span in ("join.build", "join.probe"):
            assert ops[f"{span}.{kind}"] >= 0.0
        assert after[f"{kind}.probes"] > before.get(f"{kind}.probes", 0)
        rows_in = after[f"{kind}.rows_in"] - before.get(f"{kind}.rows_in", 0)
        assert rows_in > 0, kind
    if q in ("q4", "q21"):
        assert sum(ops.values()) > 0.0, ops
    # the seconds lie inside the wall, and phases keep their schema
    assert sum(ops.values()) <= led["wall_seconds"]
    assert abs(sum(led["phases"].values()) + led["unattributed_seconds"]
               - led["wall_seconds"]) < 1e-4


@pytest.mark.parametrize("q", REST)
def test_warm_collect_builds_no_program(port, q):
    """Once a query has run, running it again builds no program. Run
    eagerly, q22's ``substring`` made a new dictionary on every collect,
    and the three programs downstream of it, keyed on its identity, were
    built again each time (a card's captured program replays with the
    dictionary it was captured with)."""
    from ballista_tpu_torch.compile.governor import compile_stats

    for _ in range(2):
        port.sql(_sql(q)).to_pydict()
    before = compile_stats()["programs_built"]
    port.sql(_sql(q)).to_pydict()
    assert compile_stats()["programs_built"] == before


def test_scalar_subqueries_run_once_per_plan(sf001):
    """A scalar subquery is resolved when its plan is first collected;
    the DataFrame the plan cache keeps carries the literal after."""
    ctx = _context(sf001[0], "cpu")
    spans = []
    for _ in range(2):
        ctx.sql(_sql("q22")).to_pydict()
        spans.append(ctx.last_query_ledger()["operators"].get(
            "subquery.scalar", 0.0))
    assert spans[0] > 0.0 and spans[1] == 0.0


# -- on the card ---------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 -m "
                    "ballista_tpu_torch.testing.card_checks runs it there)")


def test_cuda_rest13_sf005_on_the_card(tmp_path):
    _needs_card()
    tables, _ = generate.ensure_data(str(tmp_path), 0.05, SEED,
                                     generate.COLUMNS)
    ctx = _context(str(tmp_path), "cuda")
    for q in REST:
        mod = load(q)
        want = check.Expected(mod, mod.compute(tables, Num(True)))
        for _ in range(2):  # captured, then replayed
            assert want.hold(ctx.sql(_sql(q)).to_pydict()) == (None, 0.0), q


def test_cuda_device_bytes_reads_the_allocator():
    """Every operator's output batch reads the device bytes in use
    (``observability/metrics.py::instrument_execute``); on a card that is
    the caching allocator's count, read without flattening its
    statistics."""
    _needs_card()
    from ballista_tpu_torch.observability import memory

    x = torch.empty(1 << 20, device="cuda")
    assert memory.device_bytes() == torch.cuda.memory_allocated() > 0
    del x
    assert memory.device_bytes() == torch.cuda.memory_allocated()
