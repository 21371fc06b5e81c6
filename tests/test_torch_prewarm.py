"""The prewarm pass (``ballista_tpu_torch/compile/prewarm.py``,
``BALLISTA_PREWARM``) on the CPU at SF0.002, against the JAX package's
``compile/prewarm.py``:

- ``collect_targets`` of the 22 fused TPC-H plans names the same
  programs (governed namespace and key), at the same predicted
  capacities, over the same columns as the JAX package's;
- with ``BALLISTA_PREWARM=1`` the 22 results equal those with it off,
  byte for byte, and no warm-up failed;
- the placeholder batch runs through every target of the 22 plans on
  the CPU without an error, and its output has no live row;
- on the CPU stand-in of the card's graph path
  (``testing/capture_check.py::emulated_graphs``): q6's prewarmed
  ``agg.scalar`` signature is replayed by the real call exactly where
  the predicted capacity equals the scan's concatenated one (at SF0.002
  it does for both partitions), and q1's partial ``agg.grouped``, whose
  key columns are utf8, is only warmed up by the pass (no program kept),
  captured by the real call for the real dictionaries and still right;
  collecting q1 under a second fresh plan with the pass on adds no
  program to that entry.

The JAX package's targets are read on its plans without running them.
"""

import os
import threading

import pytest

from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.compile import compile_stats, governor
from ballista_tpu_torch.compile import prewarm
from ballista_tpu_torch.execution import plan_logical
from ballista_tpu_torch.physical.fusion import FusedStageExec, fuse_plan
from ballista_tpu_torch.testing.capture_check import emulated_graphs
from ballista_tpu_torch.testing.tpch_schema import register_tpch

from torch_warm_path import (assert_identical, generate_tpch,
                             pinned_threads, reset_port_caches, sql)

QUERIES = [f"q{i}" for i in range(1, 23)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with pinned_threads():
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("prewarm_tpch")))


@pytest.fixture(scope="module")
def reference(tpch_dir):
    from ballista_tpu.client import BallistaContext as ReferenceContext
    from benchmarks.tpch.schema_def import register_tpch as register_ref

    ctx = ReferenceContext.standalone()
    register_ref(ctx, tpch_dir, "tbl")
    return ctx


def _port(tpch_dir) -> BallistaContext:
    ctx = BallistaContext.standalone(device="cpu")
    register_tpch(ctx, tpch_dir)
    return ctx


def _fused(ctx, q):
    return fuse_plan(plan_logical(ctx.sql(sql(q)).plan,
                                  ctx._planner_options()))


def _describe(targets):
    """(namespace, key past the operator signature, input capacity,
    column names and kinds) of each target."""
    out = []
    for fn, batch in targets:
        key = fn.gf.key
        out.append((key[0], tuple(key[2:]),
                    int(batch.selection.shape[0]),
                    tuple((f.name, f.dtype.kind)
                          for f in batch.schema.fields)))
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_targets_equal_the_reference(tpch_dir, reference, q):
    from ballista_tpu.compile.prewarm import \
        collect_targets as reference_targets
    from ballista_tpu.execution import plan_logical as reference_plan
    from ballista_tpu.physical.fusion import fuse_plan as reference_fuse

    mine = _describe(prewarm.collect_targets(_fused(_port(tpch_dir), q)))
    theirs = _describe(reference_targets(reference_fuse(
        reference_plan(reference.sql(sql(q)).plan))))
    assert mine == theirs


def test_placeholder_batch_runs_through_every_target(tpch_dir):
    ctx = _port(tpch_dir)
    warmed = 0
    for q in QUERIES:
        for fn, batch in prewarm.collect_targets(_fused(ctx, q)):
            assert int(batch.num_rows) == 0
            assert not bool(batch.selection.any())
            out = fn.gf.fn(batch)  # the program itself, not a warm
            first = out[0] if isinstance(out, tuple) else out
            if hasattr(first, "selection"):
                assert not bool(first.selection.any()), (q, fn.gf.key[0])
            before = compile_stats()["prewarm_compiles"]
            if fn.warm(batch):
                warmed += 1
                assert compile_stats()["prewarm_compiles"] == before + 1
    assert warmed > 0


def _joined_prewarm(monkeypatch, threads=None):
    """Make each collect wait for its prewarm thread before its scans
    start (the race made deterministic); ``threads`` collects them."""
    real = prewarm.maybe_prewarm

    def waiting(phys):
        t = real(phys)
        if t is not None:
            t.join(120)
            assert not t.is_alive(), (
                "_joined_prewarm: the prewarm thread did not end within 120 s")
            if threads is not None:
                threads.append(t)
        return t

    monkeypatch.setattr(prewarm, "maybe_prewarm", waiting)


def test_prewarm_results_equal_without_it(tpch_dir, monkeypatch):
    reset_port_caches()
    off = {q: _port(tpch_dir).sql(sql(q)).to_pydict() for q in QUERIES}
    before = compile_stats()
    monkeypatch.setenv("BALLISTA_PREWARM", "1")
    threads = []
    _joined_prewarm(monkeypatch, threads)
    reset_port_caches()
    for q in QUERIES:
        assert_identical(_port(tpch_dir).sql(sql(q)).to_pydict(), off[q], q)
    after = compile_stats()
    assert threads and all(t.name == "ballista-prewarm" for t in threads)
    assert after["prewarm_failures"] == before["prewarm_failures"]


def _capacity(sig) -> int:
    """The batch capacity of a call signature: its longest leading
    dimension."""
    return max((shape[0] for shape, _dtype, _dev in sig[1] if shape),
               default=0)


def _stage(phys, grouped: bool):
    found = []

    def walk(n):
        if isinstance(n, FusedStageExec) and n.mode == "partial" and \
                bool(n.group_exprs) == grouped:
            found.append(n)
        for c in n.children():
            walk(c)

    walk(phys)
    assert len(found) == 1, phys.pretty()
    return found[0]


def test_emulated_graphs_reuse_q6_and_recapture_q1(tpch_dir, monkeypatch):
    eager = {q: _port(tpch_dir).sql(sql(q)).to_pydict()
             for q in ("q1", "q6")}
    with emulated_graphs(monkeypatch):
        monkeypatch.setenv("BALLISTA_PREWARM", "1")
        _joined_prewarm(monkeypatch)
        reset_port_caches()

        # q6: a numeric/date scalar stage
        df = _port(tpch_dir).sql(sql("q6"))
        assert_identical(df.to_pydict(), eager["q6"], "q6")
        stage = _stage(df.physical_plan(), grouped=False)
        predicted = prewarm._fused_capacity_hint(stage.source.source)
        actual = {sum(b.capacity for b in stage.source.execute(p))
                  for p in range(stage.source.output_partitioning()
                                 .num_partitions)}
        gf = stage._scalar_fn().gf
        programs = {_capacity(sig): prog for sig, prog in gf.programs.items()}
        assert predicted in programs
        # replayed by the real call where the capacities agree
        reused = predicted in actual
        assert (programs[predicted].calls > 1) == reused
        assert set(programs) == actual | {predicted}
        # at SF0.002 the prediction is exact for every partition
        assert actual == {predicted}, (actual, predicted)

        # q1: the partial stage groups by two utf8 columns: the pass
        # warms it up on placeholder dictionaries and keeps no program
        # (no real call could replay it); the real call captures its own
        warmed = compile_stats()["prewarm_compiles"]
        df = _port(tpch_dir).sql(sql("q1"))
        assert_identical(df.to_pydict(), eager["q1"], "q1")
        assert compile_stats()["prewarm_compiles"] > warmed
        stage = _stage(df.physical_plan(), grouped=True)
        gf = stage._grouped_fn(stage.group_capacity).gf
        assert gf.programs
        for sig in gf.programs:
            assert _placeholder_dictionaries(sig) == 0, sig


def _placeholder_dictionaries(obj) -> int:
    """How many of the prewarm pass's one-entry placeholder dictionaries
    a call signature holds."""
    from ballista_tpu_torch.columnar import Dictionary

    if isinstance(obj, Dictionary):
        return int(list(obj.values) == [""])
    if isinstance(obj, tuple):
        return sum(_placeholder_dictionaries(x) for x in obj)
    return 0


def test_prewarm_of_a_utf8_stage_keeps_no_program(tpch_dir, monkeypatch):
    """Every new plan gets a prewarm pass, whose placeholder dictionaries
    are new objects: q1 collected under two fresh plans with the pass on
    leaves its partial ``agg.grouped`` entry with the programs of the
    first collect's real calls, which the second replays."""
    with emulated_graphs(monkeypatch):
        monkeypatch.setenv("BALLISTA_PREWARM", "1")
        _joined_prewarm(monkeypatch)
        reset_port_caches()
        counts = []
        for _ in range(2):
            st0 = compile_stats()
            df = _port(tpch_dir).sql(sql("q1"))
            df.to_pydict()
            st1 = compile_stats()
            stage = _stage(df.physical_plan(), grouped=True)
            gf = stage._grouped_fn(stage.group_capacity).gf
            counts.append((len(gf.programs),
                           st1["prewarm_compiles"] - st0["prewarm_compiles"],
                           st1["graph_captures"] - st0["graph_captures"]))
        (first, warmed1, _), (second, warmed2, captured2) = counts
        assert warmed1 > 0 and warmed2 > 0, counts  # the pass ran twice
        assert first > 0 and second == first, counts
        assert captured2 == 0, counts
