"""The standalone adaptive pass of the port (``ballista_tpu_torch/
adaptive``) against the JAX package's, on the CPU.

- The pure rule and config cases of ``tests/test_adaptive.py`` run on
  both packages' functions with the same inputs: the same assertions
  hold on each, and the two return the same layouts, notes and configs.
- The four standalone tests of ``tests/test_adaptive.py`` are twinned:
  join demotion, a skew split, a lone repartition's coalescing and the
  nine TPC-H queries at SF0.002 (two files a table). The port has no
  EXPLAIN, so the adapted physical trees are compared instead — node
  types, adaptive notes and layouts — the port's taken from the
  collected plan, the JAX package's from ``BallistaContext.
  _apply_adaptive`` on its planned, fused tree. Rows are identical with
  the pass on and off (floats within the JAX test's rtol 1e-9), and the
  first and the kept (second) collect equal the JAX package.
- ``observed_partition_rows`` equals the JAX package's on the same data.
"""

import numpy as np
import pytest

import ballista_tpu as ref_pkg
from ballista_tpu.adaptive import config as ref_config
from ballista_tpu.adaptive import rules as ref_rules
from ballista_tpu.client import BallistaContext as ReferenceContext
from ballista_tpu.execution import plan_logical as reference_plan
from ballista_tpu.io import TblSource as RefTblSource
from ballista_tpu.physical.fusion import maybe_fuse as reference_fuse
from ballista_tpu.physical.planner import \
    PlannerOptions as ReferencePlannerOptions

import ballista_tpu_torch as bt
from ballista_tpu_torch.adaptive import config as port_config
from ballista_tpu_torch.adaptive import rules as port_rules
from ballista_tpu_torch.adaptive.standalone import AdaptiveShuffleReadExec
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.execution import plan_logical
from ballista_tpu_torch.io import TblSource
from ballista_tpu_torch.physical.fusion import maybe_fuse
from ballista_tpu_torch.physical.join import JoinExec
from ballista_tpu_torch.physical.operators import RepartitionExec

from torch_warm_path import (assert_equals_reference, generate_tpch,
                             pinned_threads, reset_port_caches, sql)

MB = 1024 * 1024


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """Two torch, ingest and scanner threads for this file's queries
    (``torch_warm_path.pinned_threads``)."""
    with pinned_threads():
        yield


# ---------------------------------------------------------------------------
# the pure rules and config, on both packages
# ---------------------------------------------------------------------------


def _coalesce_merges_small_partitions(cfg, r):
    layout = r.plan_shuffle_reads(
        [10] * 8, cfg.AdaptiveConfig(target_partition_bytes=100))
    assert layout == [[(0, 8, 0, 0)]]
    assert r.describe_layout(8, layout) == "coalesced 8→1"
    return layout


def _coalesce_respects_target_and_adjacency(cfg, r):
    layout = r.plan_shuffle_reads(
        [60, 30, 30, 90, 10], cfg.AdaptiveConfig(target_partition_bytes=100))
    assert layout == [[(0, 2, 0, 0)], [(2, 3, 0, 0)], [(3, 5, 0, 0)]]
    return layout


def _coalesce_identity_returns_none(cfg, r):
    c = cfg.AdaptiveConfig(target_partition_bytes=100)
    out = [r.plan_shuffle_reads([200, 150, 300], c),
           r.plan_shuffle_reads([], c),
           r.plan_shuffle_reads([10] * 4, cfg.AdaptiveConfig(enabled=False)),
           r.plan_shuffle_reads([10] * 4, cfg.AdaptiveConfig(coalesce=False))]
    assert out == [None] * 4
    return out


def _skew_splits_by_producer_subranges(cfg, r):
    c = cfg.AdaptiveConfig(target_partition_bytes=100, skew_factor=2.0)
    producer_bytes = [[10, 10, 10, 10]] * 3 + [[200, 200, 5, 0]]
    layout = r.plan_shuffle_reads([40, 40, 40, 405], c,
                                  producer_bytes=producer_bytes)
    plain = [x for ranges in layout for x in ranges if x[3] == 0]
    splits = [x for ranges in layout for x in ranges if x[3] != 0]
    assert all(x[0] == 3 and x[1] == 4 for x in splits)
    assert len(splits) >= 2
    assert splits[0][2] == 0 and splits[-1][3] == 4
    for a, b in zip(splits, splits[1:]):
        assert a[3] == b[2]
    assert plain and r.layout_has_splits(layout)
    note = r.describe_layout(4, layout)
    assert "split skewed partition" in note
    return layout, note


def _skew_guards(cfg, r):
    c = cfg.AdaptiveConfig(target_partition_bytes=100, skew_factor=2.0)
    one_producer = [[10, 0]] * 3 + [[400, 0]]
    a = r.plan_shuffle_reads([10, 10, 10, 400], c,
                             producer_bytes=one_producer)
    many = [[10] * 4] * 3 + [[100] * 4]
    b = r.plan_shuffle_reads([10, 10, 10, 400], c, producer_bytes=many,
                             allow_skew=False)
    d = r.plan_shuffle_reads(
        [10, 10, 10, 400],
        cfg.AdaptiveConfig(target_partition_bytes=100, skew_factor=2.0,
                           skew=False),
        producer_bytes=many)
    for layout in (a, b, d):
        assert layout is None or not r.layout_has_splits(layout)
    return a, b, d


def _split_producers_mass_on_last_producer(cfg, r):
    ranges = r._split_producers([1, 0, 0, 1000], 100)
    assert len(ranges) >= 2
    assert ranges[0][0] == 0 and ranges[-1][1] == 4
    for a, b in zip(ranges, ranges[1:]):
        assert a[1] == b[0]
    return ranges


def _skew_detected_on_skew_bytes_not_combined(cfg, r):
    c = cfg.AdaptiveConfig(target_partition_bytes=100, skew_factor=2.0)
    combined = [40, 40, 40, 600]
    light = r.plan_shuffle_reads(combined, c,
                                 producer_bytes=[[10, 10]] * 3 + [[15, 15]],
                                 skew_bytes=[20, 20, 20, 30])
    assert light is None or not r.layout_has_splits(light)
    heavy = r.plan_shuffle_reads(combined, c,
                                 producer_bytes=[[10, 10]] * 3 + [[300, 300]],
                                 skew_bytes=[20, 20, 20, 600])
    assert heavy is not None and r.layout_has_splits(heavy)
    return light, heavy


def _should_broadcast(cfg, r):
    c = cfg.AdaptiveConfig(broadcast_threshold_bytes=32 * MB)
    out = [r.should_broadcast(1 * MB, c), r.should_broadcast(33 * MB, c),
           r.should_broadcast(1, cfg.AdaptiveConfig(broadcast=False)),
           r.should_broadcast(1, cfg.AdaptiveConfig(enabled=False))]
    assert out == [True, False, False, False]
    return out


def _config_defaults(cfg, r):
    c = cfg.AdaptiveConfig.from_settings({}, env={})
    assert c.enabled and c.coalesce and c.broadcast and c.skew
    assert c.target_partition_bytes == 64 * MB
    assert c.broadcast_threshold_bytes == 32 * MB
    assert c.skew_factor == 4.0
    return vars(c)


def _config_env_overrides_and_settings_precedence(cfg, r):
    env = {"BALLISTA_ADAPTIVE_TARGET_PARTITION_BYTES": "1000",
           "BALLISTA_ADAPTIVE_SKEW_FACTOR": "8",
           "BALLISTA_ADAPTIVE_BROADCAST": "off"}
    a = cfg.AdaptiveConfig.from_settings({}, env=env)
    assert a.target_partition_bytes == 1000
    assert a.skew_factor == 8.0
    assert not a.broadcast_enabled
    b = cfg.AdaptiveConfig.from_settings(
        {"adaptive.target_partition_bytes": "2000",
         "adaptive.broadcast": "on"}, env=env)
    assert b.target_partition_bytes == 2000
    assert b.broadcast_enabled
    return vars(a), vars(b)


def _config_per_rule_gates_and_validation(cfg, r):
    a = cfg.AdaptiveConfig.from_settings({"adaptive.enabled": "off"}, env={})
    assert not (a.coalesce_enabled or a.broadcast_enabled or a.skew_enabled)
    b = cfg.AdaptiveConfig.from_settings({"adaptive.coalesce": "off"}, env={})
    assert not b.coalesce_enabled and b.skew_enabled
    with pytest.raises(ValueError, match="target_partition_bytes"):
        cfg.AdaptiveConfig.from_settings(
            {"adaptive.target_partition_bytes": "lots"}, env={})
    with pytest.raises(ValueError, match="skew_factor"):
        cfg.AdaptiveConfig.from_settings({"adaptive.skew_factor": "0.5"},
                                         env={})
    return vars(a), vars(b)


RULE_CASES = [
    _coalesce_merges_small_partitions,
    _coalesce_respects_target_and_adjacency,
    _coalesce_identity_returns_none,
    _skew_splits_by_producer_subranges,
    _skew_guards,
    _split_producers_mass_on_last_producer,
    _skew_detected_on_skew_bytes_not_combined,
    _should_broadcast,
    _config_defaults,
    _config_env_overrides_and_settings_precedence,
    _config_per_rule_gates_and_validation,
]


@pytest.mark.parametrize("case", RULE_CASES,
                         ids=[c.__name__.strip("_") for c in RULE_CASES])
def test_rules_and_config_equal_reference(case):
    assert case(port_config, port_rules) == case(ref_config, ref_rules)


# ---------------------------------------------------------------------------
# adapted trees: the port's collected plan against the JAX package's pass
# ---------------------------------------------------------------------------


def _adapted_structure(node, depth=0):
    """(depth, class, adaptive facts) per node: an adaptive reader's note
    and layout, a join's note and partitioning, a repartition's
    partition count."""
    name = type(node).__name__
    if name == "AdaptiveShuffleReadExec":
        extra = (node.note, [list(map(tuple, r)) for r in node.layout])
    elif name == "JoinExec":
        extra = (node.adaptive_note, node.partitioned)
    elif name == "RepartitionExec":
        extra = (node.num_partitions,)
    else:
        extra = ()
    out = [(depth, name) + extra]
    for c in node.children():
        out += _adapted_structure(c, depth + 1)
    return out


def _reference_adapted(ref: ReferenceContext, query: str):
    """The JAX package's adapted tree of ``query``: planned, fused, then
    its standalone collect's adaptive pass."""
    phys = reference_plan(ref.sql(query).plan,
                          ReferencePlannerOptions.from_settings(ref.settings))
    return ref._apply_adaptive(reference_fuse(phys))


def _nodes(plan, cls):
    out = [plan] if isinstance(plan, cls) else []
    for c in plan.children():
        out += _nodes(c, cls)
    return out


def _rows_equal(a: dict, b: dict, tag: str) -> None:
    """Two results of the port: the same rows in the same order; floats
    within the JAX test's rtol 1e-9 (a different plan may add in a
    different order)."""
    assert list(a) == list(b), tag
    for c in a:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype == y.dtype and x.shape == y.shape, f"{tag}.{c}"
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-9,
                                       err_msg=f"{tag}.{c}")
        else:
            assert list(x) == list(y), f"{tag}.{c}"


def _write_tbl(path, rows):
    with open(path, "w") as fh:
        for r in rows:
            fh.write("|".join(str(x) for x in r) + "|\n")


@pytest.fixture(scope="module")
def join_data(tmp_path_factory):
    """The data of ``tests/test_adaptive.py``'s standalone tests: two dim
    fragments with heavy skew onto key 7, one fact file."""
    d = tmp_path_factory.mktemp("aqe_port")
    dim_dir = d / "dim"
    dim_dir.mkdir()
    for part in range(2):
        _write_tbl(dim_dir / f"{part}.tbl",
                   [(7 if i % 10 else i % 50, f"s{i % 6}")
                    for i in range(1500)])
    fact = d / "fact.tbl"
    _write_tbl(fact, [(i, i % 50, f"{(i % 9) + 0.5:.2f}")
                      for i in range(5000)])
    return str(dim_dir), str(fact)


JOIN_SQL = ("select seg, sum(v) as sv from fact, dim "
            "where fkey = dkey group by seg order by seg")


def _schemas(pkg):
    dec = pkg.Decimal(2)
    return (pkg.schema(("dkey", pkg.Int64), ("seg", pkg.Utf8)),
            pkg.schema(("fid", pkg.Int64), ("fkey", pkg.Int64), ("v", dec)))


def _join_contexts(join_data, **settings):
    """(port on the CPU, JAX package) over the join data, co-partitioned
    joins forced on at this size, as the JAX tests force them."""
    dim_dir, fact = join_data
    s = {"join.partitioned.threshold": "100", **settings}
    port = BallistaContext.standalone(device="cpu", **s)
    dim_s, fact_s = _schemas(bt)
    port.register_source("dim", TblSource(dim_dir, dim_s, device="cpu"))
    port.register_source("fact", TblSource(fact, fact_s, device="cpu"))
    ref = ReferenceContext.standalone(**s)
    rdim_s, rfact_s = _schemas(ref_pkg)
    ref.register_source("dim", RefTblSource(dim_dir, rdim_s))
    ref.register_source("fact", RefTblSource(fact, rfact_s))
    return port, ref


def _twin(port, ref, query: str):
    """Collect ``query`` twice on the port (cold, then the kept plan) and
    hold both results and the adapted tree against the JAX package's.
    Returns (first result, adapted plan)."""
    reset_port_caches()
    df = port.sql(query)
    first = df.to_pydict()
    plan = df.physical_plan()
    kept = df.to_pydict()
    assert df.physical_plan() is plan  # the layouts froze at the first
    want = ref.sql(query).collect()
    assert_equals_reference(first, want)
    assert_equals_reference(kept, want)
    assert _adapted_structure(plan) == _adapted_structure(
        _reference_adapted(ref, query)), plan.pretty()
    return first, plan


def test_standalone_join_demotion_and_determinism(join_data):
    port, ref = _join_contexts(join_data)
    on, plan = _twin(port, ref, JOIN_SQL)
    off_ctx, _ = _join_contexts(join_data, **{"adaptive.enabled": "off"})
    _rows_equal(on, off_ctx.sql(JOIN_SQL).to_pydict(), "demotion")
    # the observed build side is tiny: the join was demoted
    notes = [j.adaptive_note for j in _nodes(plan, JoinExec)]
    assert any(n and n.startswith("broadcast build") for n in notes), notes
    assert not _nodes(plan, AdaptiveShuffleReadExec)


def test_standalone_skew_split_and_determinism(join_data):
    aggressive = {"adaptive.broadcast_threshold_bytes": "1",
                  "adaptive.target_partition_bytes": "4000",
                  "adaptive.skew_factor": "2"}
    port, ref = _join_contexts(join_data, **aggressive)
    on, plan = _twin(port, ref, JOIN_SQL)
    off_ctx, _ = _join_contexts(join_data, **{"adaptive.enabled": "off"})
    _rows_equal(on, off_ctx.sql(JOIN_SQL).to_pydict(), "skew")
    readers = _nodes(plan, AdaptiveShuffleReadExec)
    assert readers
    assert any("split skewed partition" in r.note for r in readers)


def test_standalone_lone_repartition_coalesce(join_data):
    """A user .repartition() outside any join coalesces (whole buckets
    only) and rows survive unchanged."""
    dim_dir, _ = join_data

    def port_frame(**settings):
        ctx = BallistaContext.standalone(device="cpu", **settings)
        ctx.register_source("dim", TblSource(dim_dir, _schemas(bt)[0],
                                             device="cpu"))
        return ctx.table("dim").repartition(6, [bt.col("seg")]) \
            .aggregate([bt.col("seg")], [bt.sum_(bt.col("dkey")).alias("s")])

    ref = ReferenceContext.standalone(
        **{"adaptive.target_partition_bytes": str(64 * MB)})
    ref.register_source("dim", RefTblSource(dim_dir, _schemas(ref_pkg)[0]))
    rdf = ref.table("dim").repartition(6, [ref_pkg.col("seg")]).aggregate(
        [ref_pkg.col("seg")], [ref_pkg.sum_(ref_pkg.col("dkey")).alias("s")])

    df = port_frame(**{"adaptive.target_partition_bytes": str(64 * MB)})
    got = df.to_pydict()
    plan = df.physical_plan()
    off = port_frame(**{"adaptive.enabled": "0"}).to_pydict()
    order, order_off = np.argsort(got["seg"]), np.argsort(off["seg"])
    assert list(got["seg"][order]) == list(off["seg"][order_off])
    assert list(got["s"][order]) == list(off["s"][order_off])
    readers = _nodes(plan, AdaptiveShuffleReadExec)
    assert [r.note for r in readers] == ["coalesced 6→1"]
    theirs = ref._apply_adaptive(reference_fuse(reference_plan(
        rdf.plan, ReferencePlannerOptions.from_settings(ref.settings))))
    assert _adapted_structure(plan) == _adapted_structure(theirs)
    want = rdf.collect().sort_values("seg").reset_index(drop=True)
    assert list(got["seg"][order]) == list(want["seg"])
    assert list(got["s"][order]) == list(want["s"])


def test_result_cache_serves_a_kept_adapted_plan(join_data):
    """The result cache keys the plan as planned, so the second collect
    of a kept plan hits although the first adapted it."""
    port, _ = _join_contexts(join_data, **{"result_cache.enabled": "on"})
    reset_port_caches()
    df = port.sql(JOIN_SQL)
    first = df.to_pydict()
    assert _nodes(df.physical_plan(), JoinExec)[0].adaptive_note
    second = df.to_pydict()
    assert port.cache_hits["result"] == 1
    _rows_equal(first, second, "result cache")


def test_observed_partition_rows_equal_reference(join_data):
    """Every repartition of the co-partitioned plan reports the JAX
    package's row histogram, per partition and per source fragment."""
    port, ref = _join_contexts(join_data, **{"adaptive.enabled": "off"})
    mine = maybe_fuse(plan_logical(port.sql(JOIN_SQL).plan,
                                   port._planner_options()))
    theirs = reference_fuse(reference_plan(
        ref.sql(JOIN_SQL).plan,
        ReferencePlannerOptions.from_settings(ref.settings)))
    from ballista_tpu.physical.operators import \
        RepartitionExec as RefRepartitionExec

    got = [r.observed_partition_rows() for r in _nodes(mine, RepartitionExec)]
    want = [r.observed_partition_rows()
            for r in _nodes(theirs, RefRepartitionExec)]
    assert len(got) == 2 and got == want
    assert [r.num_fragments() for r in _nodes(mine, RepartitionExec)] == \
        [r.num_fragments() for r in _nodes(theirs, RefRepartitionExec)]


# ---------------------------------------------------------------------------
# TPC-H: rows identical with the pass on and off
# ---------------------------------------------------------------------------

TPCH_QUERIES = ["q1", "q3", "q5", "q12", "q14", "q16", "q17", "q18", "q19"]
# aggressive thresholds so the rules fire at toy scale (the JAX test's);
# with demotion off, the co-partitioned joins coalesce and split instead,
# as q3 and q5 do at SF1
FORCE = {"join.partitioned.threshold": "50",
         "adaptive.target_partition_bytes": "20000",
         "adaptive.skew_factor": "2"}
SETTINGS = {"force": FORCE,
            "no_broadcast": {**FORCE, "adaptive.broadcast": "off"}}


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("aqe_port_tpch")))


@pytest.fixture(scope="module", params=list(SETTINGS))
def tpch_contexts(request, tpch_dir):
    from benchmarks.tpch.schema_def import register_tpch as register_ref
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    settings = SETTINGS[request.param]
    on = BallistaContext.standalone(device="cpu", **settings)
    off = BallistaContext.standalone(
        device="cpu", **{**settings, "adaptive.enabled": "off"})
    ref = ReferenceContext.standalone(**settings)
    for ctx in (on, off):
        register_tpch(ctx, tpch_dir)
    register_ref(ref, tpch_dir, "tbl")
    return on, off, ref


@pytest.mark.parametrize("qname", TPCH_QUERIES)
def test_tpch_rows_identical_with_aqe(tpch_contexts, qname):
    on, off, ref = tpch_contexts
    got, _ = _twin(on, ref, sql(qname))
    _rows_equal(got, off.sql(sql(qname)).to_pydict(), qname)
