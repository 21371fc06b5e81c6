"""The port's benchmark line: TPC-H q1 on one card (the counterpart of
the repo's ``bench.py``, which measures the JAX package).

    python -m ballista_tpu_torch.bench [--scale 1.0] [--data DIR]
        [--runs 3] [--device cuda|cpu]

Prints ONE JSON line on stdout, with ``bench.py``'s keys where the port
has the quantity::

    {"metric": "tpch_q1_rows_per_sec_warm", "value": N, "unit": "rows/s",
     "vs_baseline": N, "device": "<card>", "power_limit_w": W, ...}

``vs_baseline`` is the warm q1 rows/s over the reference's one
published number, q1 at SF1 in 1956.1 ms on a docker-compose cluster
(``rust/benchmarks/tpch/README.md:70-84``): other hardware's number,
kept so the two lines read alike. ``device`` and ``power_limit_w`` name
the card (``nvidia-smi --query-gpu=name,power.limit``).

Phases, in ``bench.py``'s order: a cold q1 (the table cache emptied
before each run, so every run parses and uploads) with the
parse/H2D/execute split; a warm q1 over cached tables, with the kernel's
launches in one warm collect; q5 (its first run under the profiler, the
wall-time lanes and the progress callbacks), q3, q18 and q16; the cache
phase; a fixed-budget spill q5 through a ``LocalCluster``; and the
per-stage decomposition of q1 (``stages``). Each phase's end is logged
on stderr. A phase that raises ends the run with a non-zero exit, after
the line so far (``"partial"`` names the phase) is printed.

What differs from ``bench.py``, and why:

- no TPU probe, no watchdog and no CPU retry: the run is on the device
  asked for (``--device``, default ``cuda``), and without a card it
  exits non-zero before anything runs;
- the compile fields read the port's governor, where a program is a
  CUDA graph: ``compile_count`` its captures, ``compile_seconds`` the
  seconds of first calls (warm-up and capture), ``jit_programs`` the
  governed entries built; ``persistent_cache_hit`` and ``aot_loads``
  are 0 by design, since a CUDA graph does not outlive its process
  (``compile/aot.py``); the line measures the port's defaults, so
  ``BALLISTA_PREWARM`` and the AOT directory stay unset;
- ``peak_device_bytes`` is ``torch.cuda.max_memory_allocated``;
- the port always takes the CUDA kernel for dense grouped sums on a
  card and has no ``BALLISTA_PALLAS`` knob, so there is no Pallas A/B:
  the line carries ``kernel_launches_per_warm_q1`` instead;
- ``stages`` has no XLA cost analysis and no ``est_mfu``: q1 is integer
  work, and a bf16 peak says nothing about it. The bytes the q1 program
  must move are counted from its shapes (each input read once, each
  output written once) and reported as ``kernel_gb_per_s`` and a share
  of the card's HBM peak, with the peak assumed beside it. On a card,
  ``stages.kernel_trace`` splits one more replay's device time
  (``torch.profiler``) into the dense grouped-sums kernel, the other
  kernels, memcpy and memset.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .benchmarks import (REF_ROWS_PER_SEC, REPO_ROOT, add_device_argument,
                         card_info, count_lineitem_rows, ensure_tpch,
                         query_sql, register_tables, require_device,
                         same_result, sync, timed)

# H100 SXM, NVIDIA's data sheet; ``stages`` reports its share beside it
PEAK_HBM_BYTES_PER_S = 3.35e12
WARM_BATCH_CAPACITY = 1 << 23  # the warm tables' batches on a card


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cold_phase_split(run_fn, device="cpu"):
    """Run ``run_fn()`` and attribute its wall time across the ingest
    phases (parse / H2D / the execute remainder) from the port's
    process-wide accumulators (``ingest.phase_totals``).

    ``parse_seconds``/``h2d_seconds`` are thread time: with the ingest
    pipeline on they overlap each other and the card's work, so they can
    sum past the wall; ``execute_seconds`` is the remainder, clamped at
    0. With the pipeline gated off (serial scans) the three sum to the
    wall. Returns ``(run_fn's result, phase dict)``."""
    from .ingest import phase_totals

    p0 = phase_totals()
    sync(device)
    t0 = time.perf_counter()
    ret = run_fn()
    sync(device)
    wall = time.perf_counter() - t0
    p1 = phase_totals()
    parse = p1["parse"] - p0["parse"]
    h2d = p1["h2d"] - p0["h2d"]
    return ret, {
        "wall_seconds": round(wall, 4),
        "parse_seconds": round(parse, 4),
        "h2d_seconds": round(h2d, 4),
        "execute_seconds": round(max(wall - parse - h2d, 0.0), 4),
    }


def profiled_query(ctx, name: str, sql: str, runs: int, result: dict,
                   lane_prefix: str, progress_field: str = "") -> None:
    """One query's first run under a profiler window (its wall-time
    lanes land as ``{lane_prefix}device_blocked_seconds`` etc.; q5 keeps
    the unprefixed names), then the fastest of ``runs - 1`` warm runs.
    With ``progress_field``, the first run's ``on_progress`` callbacks
    are counted there."""
    from .observability.export import compute_lanes
    from .observability.profiler import Profiler

    device = ctx.device
    df = ctx.sql(sql)
    samples = []
    prof = Profiler(label=f"{name}-first").start()
    try:
        first, _ = timed(lambda: df.to_pydict(
            on_progress=samples.append if progress_field else None), device)
    finally:
        session = prof.stop()
    if progress_field:
        result[progress_field] = len(samples)
    lane_info = compute_lanes(session)
    lanes = lane_info["lanes"]
    result[f"{lane_prefix}device_blocked_seconds"] = lanes["device_blocked"]
    result[f"{lane_prefix}host_dictionary_seconds"] = \
        lanes["host_dictionary"]
    result[f"{lane_prefix}compile_trace_lower_seconds"] = \
        lanes["compile_trace_lower"]
    result[f"{lane_prefix}attributed_fraction"] = \
        lane_info["attributed_fraction"]
    warm = min(timed(df.to_pydict, device)[0] for _ in range(max(runs - 1, 1)))
    result[f"{name}_first_seconds"] = round(first, 4)
    result[f"{name}_warm_seconds"] = round(warm, 4)


def _tensor_bytes(batch) -> int:
    """Bytes of every tensor of a batch: values, validity masks and the
    selection."""
    total = batch.selection.numel() * batch.selection.element_size()
    for c in batch.columns:
        total += c.values.numel() * c.values.element_size()
        if c.validity is not None:
            total += c.validity.numel() * c.validity.element_size()
    return int(total)


def _parse_lineitem(src, names):
    """(rows, physical arrays, dictionaries, validity masks) of
    ``names`` over every partition of ``src``, through the source's own
    host-side parse (``TblSource.parsed``, what a scan's uncached path
    runs before it uploads)."""
    import numpy as np

    n_total, arrays, dicts, valids = 0, None, {}, {}
    for p in range(src.num_partitions()):
        for n, arrs, ds, vs in src.parsed(p, names):
            if arrays is None:
                arrays, dicts, valids, n_total = arrs, ds, dict(vs or {}), n
                continue
            # several partitions or ranges: a host concatenation (a cost
            # of the parse stage)
            for k in set(valids) | set(vs or {}):
                left = valids.get(k, np.ones(n_total, dtype=bool))
                right = (vs or {}).get(k, np.ones(n, dtype=bool))
                valids[k] = np.concatenate([left, right])
            arrays = {k: np.concatenate([arrays[k], arrs[k]])
                      for k in arrays}
            n_total += n
    return n_total, arrays, dicts, valids


def instrument_q1(data_dir: str, runs: int, device="cpu",
                  trace: bool = False) -> dict:
    """Per-stage decomposition of q1: parse (the native ``.tbl`` scan
    into numpy), h2d (host to device) and kernel (the port's own q1
    partial aggregate, the date filter and ``HashAggregateExec``'s
    grouped program, run as one governed program: a captured CUDA graph
    on a card). ``kernel_aot_compile_s`` is that program's first call
    (warm-up, and capture on a card); ``kernel_s`` the fastest later
    call, timed with CUDA events on a card. With ``trace`` on a card,
    ``kernel_trace`` splits one more replay's device time by what ran
    (``replay_trace``)."""
    from . import col, count, lit, sum_
    from . import expr as ex
    from .columnar import ColumnBatch, round_capacity
    from .compile.governor import governed
    from .io import TblSource
    from .kernels.expr_eval import Evaluator
    from .physical.aggregate import HashAggregateExec
    from .physical.base import PhysicalPlan
    from .testing.tpch_schema import TPCH_SCHEMAS

    device = torch.device(device)
    out: dict = {}
    schema = TPCH_SCHEMAS["lineitem"]
    src = TblSource(os.path.join(data_dir, "lineitem"), schema,
                    device=device)
    names = ["l_returnflag", "l_linestatus", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
    sub = schema.project(names)

    # -- stage: parse (file -> numpy physical arrays, native scanner) -----
    t0 = time.perf_counter()
    n_total, arrays, dicts, valids = _parse_lineitem(src, names)
    parse_s = time.perf_counter() - t0
    in_bytes = sum(a.nbytes for a in arrays.values())
    out["parse_s"] = round(parse_s, 4)
    out["parse_mb_per_s"] = round(in_bytes / parse_s / 1e6, 1)

    # -- stage: h2d (host numpy -> device tensors) ----------------------
    cap = round_capacity(n_total)
    sync(device)
    t0 = time.perf_counter()
    batch = ColumnBatch.from_numpy(sub, arrays, dicts, capacity=cap,
                                   validity=valids or None, device=device)
    batch.wait_upload()
    sync(device)
    h2d_s = time.perf_counter() - t0
    out["h2d_s"] = round(h2d_s, 4)
    out["h2d_gb_per_s"] = round(in_bytes / h2d_s / 1e9, 2)
    out["rows"] = n_total

    # -- stage: kernel (the port's q1 partial aggregate, governed) --------
    class _Stub(PhysicalPlan):
        def output_schema(self):
            return sub

        def children(self):
            return []

        def with_new_children(self, children):
            return self

    cutoff = ex.parse_date_literal("1998-09-02")
    pred = col("l_shipdate") <= ex.Literal(cutoff,
                                           sub.field("l_shipdate").dtype)
    disc_price = col("l_extendedprice") * (lit(1) - col("l_discount"))
    charge = disc_price * (lit(1) + col("l_tax"))
    aggs = [
        sum_(col("l_quantity")).alias("sum_qty"),
        sum_(col("l_extendedprice")).alias("sum_base_price"),
        sum_(disc_price).alias("sum_disc_price"),
        sum_(charge).alias("sum_charge"),
        sum_(col("l_discount")).alias("sum_disc"),
        count().alias("count_order"),
    ]
    partial = HashAggregateExec(
        "partial", [col("l_returnflag"), col("l_linestatus")], aggs,
        _Stub(), group_capacity=8,
    )
    ev = Evaluator(sub)
    body = partial._grouped_body(8)

    def build():
        def q1_program(b):
            live = b.selection & ev.evaluate_predicate(pred, b)
            return body(b.with_selection(live))

        return q1_program

    program = governed(("agg.grouped", "bench.instrument_q1", cap), build)
    sync(device)
    t0 = time.perf_counter()
    res, _ = program(batch)
    sync(device)
    out["kernel_aot_compile_s"] = round(time.perf_counter() - t0, 3)
    kernel_bytes = _tensor_bytes(batch) + _tensor_bytes(res)

    def run_kernel() -> float:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            program(batch)
            end.record()
            # a timed run ends here: the clock waits for the card
            # ballista: ignore[sync-span]
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t = time.perf_counter()
        program(batch)
        return time.perf_counter() - t

    run_kernel()  # the first replay
    kernel_s = min(run_kernel() for _ in range(max(runs, 2)))
    out["kernel_s"] = round(kernel_s, 6)
    out["kernel_rows_per_s"] = round(n_total / kernel_s, 1)
    out["kernel_bytes_accessed"] = kernel_bytes
    out["kernel_gb_per_s"] = round(kernel_bytes / kernel_s / 1e9, 2)
    if device.type == "cuda":
        out["kernel_hbm_share"] = round(
            kernel_bytes / kernel_s / PEAK_HBM_BYTES_PER_S, 4)
        out["peak_hbm_bytes_per_s_assumed"] = PEAK_HBM_BYTES_PER_S
        if trace:
            out["kernel_trace"] = replay_trace(lambda: program(batch))
    return out


def replay_trace(fn) -> dict:
    """``fn()`` (one replay of a captured program) under
    ``torch.profiler``: the card's busy ms split into the dense
    grouped-sums kernel, the other kernels, memcpy and memset records,
    with the largest of the other kernels by name. Device times only;
    a caller that watches kernel calls (``dense_sums.observe``) adds its
    own work to the trace."""
    from torch.profiler import ProfilerActivity, profile

    # the trace holds the replay alone: the card is idle before it, and
    # the window closes after the card's work
    # ballista: ignore[sync-span]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        # ballista: ignore[sync-span]
        torch.cuda.synchronize()
    split = {"dense_grouped_sums_ms": 0.0, "other_kernels_ms": 0.0,
             "memcpy_ms": 0.0, "memset_ms": 0.0}
    others = []
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if e.device_type != torch.autograd.DeviceType.CUDA or ms <= 0:
            continue
        name = e.key.lower()
        if "dense_grouped_sums" in name:
            split["dense_grouped_sums_ms"] += ms
        elif name.startswith("memcpy"):
            split["memcpy_ms"] += ms
        elif name.startswith("memset"):
            split["memset_ms"] += ms
        else:
            split["other_kernels_ms"] += ms
            others.append((e.key[:80], round(ms, 4), e.count))
    split = {k: round(v, 4) for k, v in split.items()}
    split["busy_ms"] = round(sum(split.values()), 4)
    split["top_other_kernels"] = sorted(others, key=lambda t: -t[1])[:8]
    return split


def record_compiles(result: dict, device) -> None:
    """The governor's, memory's, spill's and caches' counters, as
    ``bench.py``'s ``record_compiles`` names them."""
    from .cache import cache_counters
    from .compile.governor import compile_stats
    from .distributed import spill as _spill
    from .observability import memory as obs_memory

    st = compile_stats()
    result["compile_count"] = int(st["graph_captures"])
    result["compile_seconds"] = round(float(st["first_call_seconds"]), 3)
    result["persistent_cache_hit"] = 0
    result["jit_programs"] = int(st["entries_built"])
    result["aot_loads"] = 0
    result["graph_replays"] = int(st["graph_replays"])
    result["peak_rss_mb"] = round(obs_memory.peak_rss_bytes() / 1e6, 1)
    result["peak_device_bytes"] = int(
        obs_memory.peak_device_bytes(refresh=True, device=device))
    result["peak_host_tracked_bytes"] = int(obs_memory.peak_host_bytes())
    gov = _spill.governor().stats()
    result["spill_bytes"] = int(gov["spilled_bytes_total"])
    result["shuffle_peak_inflight_mb"] = round(
        gov["peak_inflight_bytes"] / 1e6, 2)
    cc = cache_counters()
    result["table_cache_hits"] = int(cc["table_cache_hits"])
    result["result_cache_hits"] = int(cc["result_cache_hits"])
    result["donated_buffers"] = int(cc["donated_buffers"])


def _cold_q1(data_dir: str, device, result: dict):
    """The cold phase: every run parses (the table cache emptied first),
    the first with the parse/H2D/execute split. Returns q1's result."""
    from .cache.residency import process_table_cache
    from .client import BallistaContext

    sql = query_sql("q1")
    ctx = BallistaContext.standalone(device=device)
    register_tables(ctx, data_dir, tables=("lineitem",))

    def run_once():
        process_table_cache().invalidate()
        return timed(ctx.sql(sql).to_pydict, device)

    (first, out), phases = cold_phase_split(run_once, device)
    cold_s, again = run_once()
    if not same_result(out, again):
        raise AssertionError("q1: the second cold run's result differs")
    rows = count_lineitem_rows(data_dir)
    result.update({
        "parse_seconds": phases["parse_seconds"],
        "h2d_seconds": phases["h2d_seconds"],
        "execute_seconds": phases["execute_seconds"],
        "lineitem_rows": rows,
        "cold_seconds": round(cold_s, 4),
        "cold_rows_per_sec": round(rows / cold_s, 1),
        "cold_vs_baseline": round(rows / cold_s / REF_ROWS_PER_SEC, 3),
        "first_run_seconds": round(first, 4),
        "q1_groups": int(len(next(iter(out.values())))),
    })
    return out


def _warm_context(data_dir: str, device):
    from .client import BallistaContext

    kw = ({"batch_capacity": WARM_BATCH_CAPACITY}
          if torch.device(device).type == "cuda" else {})
    ctx = BallistaContext.standalone(device=device)
    register_tables(ctx, data_dir, cached=True, **kw)
    return ctx


def _warm_q1(ctx, runs: int, result: dict, want) -> None:
    from .kernels import dense_sums

    df = ctx.sql(query_sql("q1"))
    if not same_result(df.to_pydict(), want):  # load and capture once
        raise AssertionError("q1 over cached tables differs from cold q1")
    warm = min(timed(df.to_pydict, ctx.device)[0] for _ in range(runs))
    sync(ctx.device)
    before = dense_sums.launch_count
    out = df.to_pydict()
    sync(ctx.device)
    launches = dense_sums.launch_count - before
    if not same_result(out, want):
        raise AssertionError("warm q1 differs from cold q1")
    value = result["lineitem_rows"] / warm
    result.update({
        "value": round(value, 1),
        "vs_baseline": round(value / REF_ROWS_PER_SEC, 3),
        "warm_seconds": round(warm, 4),
        "kernel_launches_per_warm_q1": launches,
    })


def _cache_phase(data_dir: str, result: dict, device) -> None:
    """The warm-path serving caches, three legs on an emptied table
    cache (``bench.py``'s ``_cache_phase``): q1 twice (the second scans
    pinned batches), q1 twice with the result cache on (the second
    returns cached rows), and a fixed-budget leg whose budget admits
    lineitem but not lineitem and orders, then shrinks to 1 MB so the q1
    re-scan degrades to re-ingest. Results stay identical throughout."""
    from .cache import cache_counters, reset_cache_stats, residency
    from .client import BallistaContext

    sql = query_sql("q1")

    def fresh_ctx(settings=None, tables=("lineitem",)):
        ctx = BallistaContext(settings, device=device)
        register_tables(ctx, data_dir, tables=tables)
        return ctx

    residency.reset()
    reset_cache_stats()
    df = fresh_ctx().sql(sql)
    cold, base = timed(df.to_pydict, device)
    warm, warm_out = timed(df.to_pydict, device)
    fill_bytes = int(cache_counters()["table_cache_resident_bytes"])
    result["cache_cold_q1_seconds"] = round(cold, 4)
    result["cache_warm_q1_seconds"] = round(warm, 4)
    result["cache_q1_speedup"] = round(cold / warm, 2) if warm > 0 else 0.0
    result["cache_q1_identical"] = int(same_result(base, warm_out))
    result["table_cache_fill_bytes"] = fill_bytes

    df_rc = fresh_ctx({"result_cache.enabled": "on"}).sql(sql)
    df_rc.to_pydict()  # miss and fill
    rc, hit = timed(df_rc.to_pydict, device)
    result["result_cache_hit_seconds"] = round(rc, 4)
    result["result_cache_speedup"] = round(warm / rc, 1) if rc > 0 else 0.0
    result["result_cache_identical"] = int(same_result(base, hit))

    budget_mb = max(1, -(-fill_bytes // int(0.9 * (1 << 20))))
    residency.reset()
    saved = os.environ.get("BALLISTA_TABLE_CACHE_BUDGET_MB")
    os.environ["BALLISTA_TABLE_CACHE_BUDGET_MB"] = str(budget_mb)
    try:
        ctx_b = fresh_ctx(tables=("lineitem", "orders"))
        dfb = ctx_b.sql(sql)
        out1 = dfb.to_pydict()  # fills lineitem under the sized budget
        os.environ["BALLISTA_TABLE_CACHE_BUDGET_MB"] = "1"
        ctx_b.sql("SELECT COUNT(*) AS n FROM orders").to_pydict()  # evicts
        out2 = dfb.to_pydict()  # no longer fits: re-ingest
        cc = cache_counters()
        result["cache_budget_mb"] = budget_mb
        result["cache_budget_peak_resident_bytes"] = int(
            cc["table_cache_peak_resident_bytes"])
        result["cache_budget_ok"] = int(
            cc["table_cache_peak_resident_bytes"] <= budget_mb << 20)
        result["cache_budget_evictions"] = int(cc["table_cache_evictions"])
        result["cache_budget_identical"] = int(
            same_result(base, out1) and same_result(base, out2))
    finally:
        if saved is None:
            os.environ.pop("BALLISTA_TABLE_CACHE_BUDGET_MB", None)
        else:
            os.environ["BALLISTA_TABLE_CACHE_BUDGET_MB"] = saved
        residency.reset()
    for key in ("cache_q1_identical", "result_cache_identical",
                "cache_budget_identical"):
        if not result[key]:
            raise AssertionError(f"cache phase: {key} is 0")


def _spill_q5(data_dir: str, result: dict, device, want) -> None:
    """q5 on an in-process ``LocalCluster`` on ``device`` with remote
    fetches forced and a shuffle memory budget below one part's wire
    volume, so past-watermark chunks spill to disk (``bench.py``'s
    ``_spill_q5``); its result must equal the standalone q5's."""
    from .client import BallistaContext
    from .distributed import spill as _spill
    from .distributed.executor import LocalCluster
    from .observability import memory as obs_memory
    from .physical.shuffle import ShuffleReaderExec

    budget = 128 << 10
    chunk = 32 << 10
    saved = {k: os.environ.get(k) for k in
             ("BALLISTA_SHUFFLE_MEM_BUDGET", "BALLISTA_SHUFFLE_CHUNK_BYTES")}
    os.environ["BALLISTA_SHUFFLE_MEM_BUDGET"] = str(budget)
    os.environ["BALLISTA_SHUFFLE_CHUNK_BYTES"] = str(chunk)
    force_remote0 = ShuffleReaderExec.FORCE_REMOTE
    ShuffleReaderExec.FORCE_REMOTE = True
    gov = _spill.governor()
    gov.reset_stats()
    rss0 = obs_memory.peak_rss_bytes()
    cluster = LocalCluster(num_executors=2, concurrent_tasks=2,
                           device=device)
    try:
        ctx = BallistaContext.remote("localhost", cluster.port,
                                     device=device,
                                     **{"job.timeout": "600"})
        register_tables(ctx, data_dir)
        wall, out = timed(ctx.sql(query_sql("q5")).to_pydict, device)
    finally:
        cluster.shutdown()
        ShuffleReaderExec.FORCE_REMOTE = force_remote0
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if not _same_q5(out, want):
        raise AssertionError("spill q5 differs from the standalone q5")
    st = gov.stats()
    result["spill_q5_seconds"] = round(wall, 4)
    result["spill_bytes"] = int(st["spilled_bytes_total"])
    result["shuffle_peak_inflight_mb"] = round(
        st["peak_inflight_bytes"] / 1e6, 2)
    result["spill_budget_mb"] = round(budget / 1e6, 2)
    result["spill_chunk_mb"] = round(chunk / 1e6, 2)
    result["spill_q5_peak_rss_mb"] = round(
        max(obs_memory.peak_rss_bytes(), rss0) / 1e6, 1)


def _same_q5(got, want) -> bool:
    """q5's rows, as a remote frame decodes them (revenue may arrive as
    a float) against the standalone collect's."""
    import numpy as np

    if list(got) != list(want):
        return False
    return (np.array_equal(np.asarray(got["n_name"]),
                           np.asarray(want["n_name"]))
            and np.allclose(np.asarray(got["revenue"], dtype=np.float64),
                            np.asarray(want["revenue"], dtype=np.float64),
                            rtol=1e-9, atol=0.0))


def run_bench(data_dir: str, runs: int, device, result: dict,
              scale=None, trace: bool = True) -> dict:
    """Every phase over the TPC-H data in ``data_dir``, filling
    ``result`` (the JSON line) as it goes; ``result["partial"]`` names
    the phase under way and is dropped at the end. ``trace`` traces one
    replay of the q1 program (``stages.kernel_trace``, on a card).
    Returns q1's result (``to_pydict``) for callers that check it."""
    device = torch.device(device)
    result.update({
        "metric": "tpch_q1_rows_per_sec_warm", "value": 0,
        "unit": "rows/s", "vs_baseline": 0.0, "platform": device.type,
        "scale": scale, "runs": runs,
    })
    result.update(card_info(device))

    t_start = time.perf_counter()

    def phase(name: str) -> None:
        result["partial"] = name
        record_compiles(result, device)
        log(f"# bench: {name} at {time.perf_counter() - t_start:.1f} s")

    result["partial"] = "cold"
    q1 = _cold_q1(data_dir, device, result)
    phase("cold_done")
    ctx = _warm_context(data_dir, device)
    _warm_q1(ctx, runs, result, q1)
    phase("warm_done")
    profiled_query(ctx, "q5", query_sql("q5"), runs, result, lane_prefix="",
                   progress_field="progress_samples")
    result["q5_rows_per_sec"] = round(
        result["lineitem_rows"] / result["q5_warm_seconds"], 1)
    phase("q5_done")
    for qname in ("q3", "q18"):
        profiled_query(ctx, qname, query_sql(qname), runs, result,
                       lane_prefix=f"{qname}_")
    phase("q3_q18_done")
    profiled_query(ctx, "q16", query_sql("q16"), runs, result,
                   lane_prefix="q16_")
    q5 = ctx.sql(query_sql("q5")).to_pydict()
    del ctx
    phase("q16_done")
    _cache_phase(data_dir, result, device)
    phase("cache_done")
    _spill_q5(data_dir, result, device, q5)
    phase("spill_q5_done")
    result["stages"] = instrument_q1(data_dir, runs, device, trace=trace)
    phase("stages_done")
    result.pop("partial")
    record_compiles(result, device)
    return q1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--data", default=os.path.join(REPO_ROOT, "bench_data"))
    ap.add_argument("--runs", type=int, default=3)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device, "bench")
    data_dir = ensure_tpch(os.path.join(args.data, f"sf{args.scale:g}"),
                           args.scale, log=log)
    result: dict = {}
    try:
        run_bench(data_dir, args.runs, device, result, scale=args.scale)
    except BaseException:
        # the line so far names the phase that failed; the exit is not 0
        print(json.dumps(result), flush=True)
        raise
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
