"""Whole-stage fusion in the port (``ballista_tpu_torch/physical/
fusion.py``) on the CPU, after the cases of ``tests/test_fusion.py`` that
need no EXPLAIN, AOT or prewarm.

- q1, q5, q12 and q16 at SF0.002: fused equals unfused byte for byte (on
  the CPU both add the same rows in the same order), and both equal the
  JAX package (integer, decimal, date and string columns exactly, float
  columns within rtol 1e-6);
- the fused structure of the port's plans — class, chain operators and
  stage number of every fused node, and every join's fused probe chain —
  equals the JAX package's ``fuse_plan`` for all 22 queries;
- the ``BALLISTA_FUSION=0`` escape hatch, the probe chain fused into a
  join, a re-plan that builds no new entry, the single-partition
  distinct without its dedup;
- ``grouped_distinct_count`` equals the JAX function exactly on seeded
  inputs with NULL keys, NULL values, duplicates and an all-NULL group;
- every program of the 22 fused queries passes the capture check
  (``testing/capture_check.py``), and on the CPU stand-in of the card's
  graph path a cold and a warm collect equal the eager one.
"""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from benchmarks.tpch import datagen
from benchmarks.tpch.schema_def import register_tpch as register_reference
from ballista_tpu.client import BallistaContext as ReferenceContext
from ballista_tpu.execution import plan_logical as reference_plan
from ballista_tpu.kernels.aggregate import \
    grouped_distinct_count as reference_distinct_count
from ballista_tpu.physical.fusion import fuse_plan as reference_fuse_plan

import torch

from ballista_tpu_torch import Int64, schema
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.compile import compile_stats
from ballista_tpu_torch.execution import plan_logical
from ballista_tpu_torch.kernels.aggregate import grouped_distinct_count
from ballista_tpu_torch.physical.aggregate import HashAggregateExec
from ballista_tpu_torch.physical.fusion import (FusedDistinctCountExec,
                                                FusedStageExec, fuse_plan)
from ballista_tpu_torch.physical.join import JoinExec
from ballista_tpu_torch.testing.capture_check import (emulated_graphs,
                                                      simulated_capture)
from ballista_tpu_torch.testing.tpch_schema import register_tpch

from torch_warm_path import pinned_threads

QUERIES = [f"q{i}" for i in range(1, 23)]
QDIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "tpch",
                    "queries")


def _sql(q):
    return open(os.path.join(QDIR, f"{q}.sql")).read()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The tier runs its files in parallel worker processes on one
    machine: this file's torch ops, ingest pool and scanner take two
    threads, not every core, so they do not starve the workers beside
    them (``torch_warm_path.pinned_threads``)."""
    with pinned_threads():
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fusion_tpch_port"))
    datagen.generate(d, scale=0.002, num_parts=2)
    return d


@pytest.fixture(scope="module")
def reference(tpch_dir):
    ctx = ReferenceContext.standalone()
    register_reference(ctx, tpch_dir, "tbl")
    return ctx


def _port(tpch_dir) -> BallistaContext:
    ctx = BallistaContext.standalone(device="cpu")
    register_tpch(ctx, tpch_dir)
    return ctx


def _run(tpch_dir, q, monkeypatch, fusion: str):
    monkeypatch.setenv("BALLISTA_FUSION", fusion)
    df = _port(tpch_dir).sql(_sql(q))
    out = df.to_pydict()
    monkeypatch.delenv("BALLISTA_FUSION")
    return out, df.physical_plan()


def _count_type(phys, cls) -> int:
    n = int(isinstance(phys, cls))
    return n + sum(_count_type(c, cls) for c in phys.children())


def _fused_nodes(phys) -> int:
    """Fused stages, fused distinct counts and joins with a fused probe
    chain in a plan."""
    n = int(isinstance(phys, (FusedStageExec, FusedDistinctCountExec))
            or (isinstance(phys, JoinExec) and bool(phys.probe_chain)))
    return n + sum(_fused_nodes(c) for c in phys.children())


def _byte_identical(a, b, tag):
    assert list(a) == list(b), tag
    for c in a:
        ga, gb = np.asarray(a[c]), np.asarray(b[c])
        assert ga.dtype == gb.dtype and ga.shape == gb.shape, f"{tag}.{c}"
        if ga.dtype.kind == "O":
            assert list(ga) == list(gb), f"{tag}.{c}"
        else:
            assert ga.tobytes() == gb.tobytes(), f"{tag}.{c}"


def _equals_reference(got, want: pd.DataFrame, tag):
    assert list(got) == list(want.columns), tag
    for c in want.columns:
        w, g = want[c].to_numpy(), got[c]
        assert g.shape == w.shape, f"{tag}.{c}"
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f"{tag}.{c}")
        elif w.dtype.kind == "M":
            np.testing.assert_array_equal(g, w.astype("datetime64[D]"),
                                          err_msg=f"{tag}.{c}")
        else:
            assert list(g) == list(w), f"{tag}.{c}"


# ---------------------------------------------------------------------------
# fused == unfused == the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", ["q1", "q5", "q12", "q16"])
def test_fused_equals_unfused_equals_reference(tpch_dir, reference,
                                               monkeypatch, q):
    unfused, _ = _run(tpch_dir, q, monkeypatch, "0")
    fused, phys = _run(tpch_dir, q, monkeypatch, "on")
    assert _fused_nodes(phys) >= 1, phys.pretty()
    _byte_identical(unfused, fused, q)
    _equals_reference(fused, reference.sql(_sql(q)).collect(), q)


# ---------------------------------------------------------------------------
# plan structure against the JAX package's fuse_plan
# ---------------------------------------------------------------------------


def _structure(node, depth=0):
    """(depth, class, fused chain ops, stage number) per node; a join
    carries its fused probe chain's ops."""
    name = type(node).__name__
    if name in ("FusedStageExec", "FusedDistinctCountExec"):
        extra = (tuple(type(o).__name__ for o in node.chain), node.stage_no)
    elif name == "JoinExec":
        extra = (tuple(type(o).__name__ for o in node.probe_chain),)
    else:
        extra = ()
    out = [(depth, name) + extra]
    for c in node.children():
        out += _structure(c, depth + 1)
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_fused_structure_matches_reference(tpch_dir, reference, q):
    port = _port(tpch_dir)
    mine = fuse_plan(plan_logical(port.sql(_sql(q)).plan,
                                  port._planner_options()))
    theirs = reference_fuse_plan(reference_plan(reference.sql(_sql(q)).plan))
    assert _structure(mine) == _structure(theirs), mine.pretty()


def test_fused_operators_in_plans(tpch_dir, monkeypatch):
    _, p1 = _run(tpch_dir, "q1", monkeypatch, "on")
    assert _count_type(p1, FusedStageExec) >= 1, p1.pretty()
    _, p16 = _run(tpch_dir, "q16", monkeypatch, "on")
    assert _count_type(p16, FusedDistinctCountExec) == 1, p16.pretty()


def test_execution_collect_fuses(tpch_dir):
    """``execution.collect`` (plan, fuse, execute) equals the client's
    collect."""
    from ballista_tpu_torch.execution import collect

    port = _port(tpch_dir)
    for q in ("q1", "q16"):
        got = collect(port.sql(_sql(q)).plan, port._planner_options())
        _byte_identical(got, port.sql(_sql(q)).to_pydict(), q)


def test_fusion_escape_hatch(tpch_dir, monkeypatch):
    _, p1 = _run(tpch_dir, "q1", monkeypatch, "0")
    assert _count_type(p1, FusedStageExec) == 0
    _, p16 = _run(tpch_dir, "q16", monkeypatch, "0")
    assert _count_type(p16, FusedDistinctCountExec) == 0


def test_probe_chain_fused_into_join(tpch_dir, monkeypatch):
    _, p5 = _run(tpch_dir, "q5", monkeypatch, "on")

    def any_fused_probe(node):
        if isinstance(node, JoinExec) and node.probe_chain:
            return True
        return any(any_fused_probe(c) for c in node.children())

    assert any_fused_probe(p5), p5.pretty()


def test_replan_of_fused_plan_builds_no_entries(tpch_dir):
    ctx = _port(tpch_dir)
    first = ctx.sql(_sql("q1")).to_pydict()
    ctx._plan_cache.clear()  # fresh DataFrame: plan and fuse again
    before = compile_stats()
    second = ctx.sql(_sql("q1")).to_pydict()
    after = compile_stats()
    assert after["entries_built"] == before["entries_built"]
    assert after["programs_built"] == before["programs_built"]
    _byte_identical(first, second, "q1 re-planned")


def test_distinct_single_partition_drops_dedup():
    """With one input partition the (g, x) dedup partial is pure overhead:
    the fused stage absorbs the dedup's own scan chain instead."""
    ctx = BallistaContext.standalone(device="cpu")
    n = 400
    rng = np.random.RandomState(11)
    k = rng.randint(0, 5, n).astype(np.int64)
    v = rng.randint(0, 50, n).astype(np.int64)
    ctx.register_memtable("t_dist", schema(("k", Int64), ("v", Int64)),
                          {"k": k, "v": v})
    df = ctx.sql("select k, count(distinct v) as dv from t_dist "
                 "where v > 4 group by k order by k")
    out = df.to_pydict()
    phys = df.physical_plan()
    assert _count_type(phys, FusedDistinctCountExec) == 1, phys.pretty()
    # the whole double-agg tower AND the dedup partial are gone
    assert _count_type(phys, HashAggregateExec) == 0, phys.pretty()
    keep = v > 4
    want = {int(g): len(np.unique(v[keep & (k == g)]))
            for g in np.unique(k[keep])}
    assert list(out["k"]) == sorted(want)
    assert list(out["dv"]) == [want[g] for g in sorted(want)]


# ---------------------------------------------------------------------------
# grouped_distinct_count against the JAX function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,nullable_keys,nullable_x,two_keys", [
    (3, False, True, False),
    (5, True, True, False),
    (7, True, False, True),
    (9, True, True, True),
])
def test_grouped_distinct_count_equals_reference(seed, nullable_keys,
                                                 nullable_x, two_keys):
    rng = np.random.default_rng(seed)
    n, cap = 512, 64
    keys = [rng.integers(0, 7, n).astype(np.int64)]
    if two_keys:
        keys.append(rng.integers(-3, 3, n).astype(np.int32))
    x = rng.integers(0, 23, n).astype(np.int64)  # many duplicates
    live = rng.random(n) > 0.2
    kvalid = [rng.random(n) > 0.15 if nullable_keys else None
              for _ in keys]
    xvalid = rng.random(n) > 0.3 if nullable_x else None
    if nullable_x:
        xvalid[keys[0] == 6] = False  # group 6: every x is NULL
    got = grouped_distinct_count(
        [torch.from_numpy(k) for k in keys], torch.from_numpy(live),
        torch.from_numpy(x), cap,
        [None if v is None else torch.from_numpy(v) for v in kvalid],
        None if xvalid is None else torch.from_numpy(xvalid))
    want = reference_distinct_count(
        [jnp.asarray(k) for k in keys], jnp.asarray(live), jnp.asarray(x),
        cap, [None if v is None else jnp.asarray(v) for v in kvalid],
        None if xvalid is None else jnp.asarray(xvalid))
    assert int(got.num_groups) == int(want.num_groups)
    for g, w in [(got.rep_indices, want.rep_indices),
                 (got.group_valid, want.group_valid),
                 (got.aggregates[0], want.aggregates[0]),
                 (got.agg_valid[0], want.agg_valid[0])]:
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.aggregates[0].dtype == torch.int64
    if nullable_x:  # the all-NULL group is there, with a count of 0
        rows = got.rep_indices.numpy()[got.group_valid.numpy()]
        counts = got.aggregates[0].numpy()[got.group_valid.numpy()]
        six = [c for r, c in zip(rows, counts) if keys[0][r] == 6
               and (kvalid[0] is None or kvalid[0][r])]
        assert six and all(c == 0 for c in six)


# ---------------------------------------------------------------------------
# capturable programs, and the graph path on the CPU
# ---------------------------------------------------------------------------


def test_every_fused_program_is_capturable(tpch_dir):
    """All 22 queries, cold and warm, with every governed program run
    under the capture check; results equal the eager run's."""
    eager = {q: _port(tpch_dir).sql(_sql(q)).to_pydict() for q in QUERIES}
    with simulated_capture():
        ctx = _port(tpch_dir)
        for q in QUERIES:
            df = ctx.sql(_sql(q))
            for _ in range(2):
                _byte_identical(df.to_pydict(), eager[q], q)


@pytest.mark.parametrize("settings", [
    {}, {"join.partitioned.threshold": "100", "agg.partitions": "4"}],
    ids=["plain", "shuffled"])
def test_graph_path_cold_and_warm_equal_eager(tpch_dir, monkeypatch,
                                              settings):
    """The card's path — warm-up, capture, then replays into static
    buffers — on a CPU stand-in of the graph API. Shuffled, q3's
    partitioned probes and q5's partial aggregates keep several outputs
    of one entry alive at once."""
    qs = ["q1", "q3", "q5", "q16"] if settings else QUERIES

    def ctx():
        c = BallistaContext.standalone(device="cpu", **settings)
        register_tpch(c, tpch_dir)
        return c

    eager = {q: ctx().sql(_sql(q)).to_pydict() for q in qs}
    with emulated_graphs(monkeypatch):
        c = ctx()
        before = compile_stats()
        for q in qs:
            df = c.sql(_sql(q))
            _byte_identical(df.to_pydict(), eager[q], f"{q} cold")
            mid = compile_stats()
            _byte_identical(df.to_pydict(), eager[q], f"{q} warm")
            end = compile_stats()
            assert end["graph_replays"] > mid["graph_replays"], q
        assert compile_stats()["graph_captures"] > before["graph_captures"]
