"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA card, ``nvcc`` and ``g++``; it imports torch, numpy, pyarrow and the
port (``ballista_tpu_torch``), never jax or the JAX package, and needs no
pandas. Phases, in order (any failure is an uncaught exception and a
non-zero exit):

1. card: the name and power limit as nvidia-smi reports them;
2. build: the CUDA kernel (nvcc, sm_90a), the native scanner (g++) and
   the native shuffle server (g++) from the checkout's sources, the
   three compilers started together;
   then the set-up: TPC-H data at SF1 (``benchmarks/tpch/datagen.py``)
   in ``bench_data/sf1``, reused while its ``.complete`` marker holds the
   current ``DATAGEN_VERSION``;
3. kernel check: ``dense_grouped_sums`` against its plain torch version,
   bit for bit in all three outputs (sums, counts, first live rows), at
   q1's partial-aggregate shape (N = the scan's slot count, G = 6, K = 7,
   even groups, 2% dead rows); at G = 256 with validity-mask columns, a
   ragged N and full-range values that wrap; with every live row in one
   group at G = 6 and at G = 256 (the worst contention); with groups whose
   first live row lies far beyond the first block's rows; on misaligned
   views (``base[1:]`` of every column) with a ragged N, which run the
   VEC = 1 instantiation; at the final aggregate's K = 12 with six rows
   and with a ragged N; and at K = 100 (two launches, each opting into
   more than 48 KB of shared memory). The first six are timed beside the
   plain version, one ``index_add_`` call and one ``scatter_reduce_``
   call that finds the first rows: each call by its own CUDA events after
   a 256 MB write has flushed the L2 cache, the host's launch hidden
   behind a sleep on the card (``ms``) or not (``call_ms``);
4. TPC-H q1 and q6 through ``BallistaContext.standalone()`` on "cuda",
   fused (the default) and run as captured CUDA graphs: the kernel's
   launch count is reset just before and read just after each q1
   collect (>= 2 launches: partial and final aggregate; a warm collect's
   launches are replays of the captured ones); every kernel call of
   every collect, the replayed ones included, is observed and its
   outputs held against the plain version on its inputs, bit for bit;
   the kernel is launched again on the inputs of every call q1's cold
   collect made, the partial's timed, on a misaligned copy of the
   partial's inputs (the VEC = 1 instantiation, ``vec1_ms``), and
   replayed inside a graph that holds only it (``graph_ms``,
   ``graph_call_ms``); results must equal the port on the CPU and an
   integer numpy group-by of the scanned columns, exactly;
5. TPC-H q3 and q5 at SF1 over all eight tables, cold and warm: each
   physical plan (adapted) is printed; q3's plan with the adaptive pass
   off must hold a co-partitioned ``JoinExec`` over two
   ``RepartitionExec``s; the kernel's launch count
   is reset just before and read just after each q5 collect (>= 2), every
   observed call is held against the plain version, and the kernel is
   launched again on the inputs of every call of q5's cold collect (the
   largest timed); results must equal the port on the CPU and a numpy
   implementation of each query over the scanned columns (sorted-key
   joins, int64 decimals), exactly;
6. fusion: q1, q3, q5 and q16 at SF1 with fusion on and with
   ``BALLISTA_FUSION=0``, each from a cleared governor, cold and warm:
   results equal to the port on the CPU, exactly; the warm collect must
   replay graphs and capture none; q1's and q5's warm collects must count
   kernel launches (replays); every observed kernel call bit-equal to the
   plain version; fused nodes present only with fusion on (q16's one
   ``FusedDistinctCountExec``); captures, replays, capture seconds and
   peak memory of each, and one profiled warm collect (wall, card-busy
   share, kernels on the card, host-side launches by kind);
7. ingest and warm path: q1, q3, q5 and q16 at SF1, each cold and then
   warm, from a cleared table cache and governor, at the default table
   cache budget, at ``BALLISTA_TABLE_CACHE_BUDGET_MB=8192`` (every table
   of the four fits), with ``BALLISTA_TABLE_CACHE=off`` and with the
   serial loop (``BALLISTA_PREFETCH_BATCHES=0`` and
   ``BALLISTA_INGEST_THREADS=1``); then q1 at a 1 MB budget, which must
   re-ingest. Each collect equals the port on the CPU, every observed
   kernel call is bit-equal to the plain version, and after each no
   tensor the cache pins was written (``_version`` and a copy). Each
   prints its wall, the cache's hits, fills, evictions and resident
   bytes, ``elapsed_parse`` and ``elapsed_h2d``, donated buffers and
   bytes, captures, replays and peak memory. At 8192 MB a warm collect
   must serve every scan partition from the cache (no fill, no parse),
   replay and capture nothing, and a profiled one must copy under 1 MB
   to the card (the trace's memcpy records); so must a second context's
   first collect of each query. Then the upload-under-capture check:
   three producer threads upload lineitem chunks on their own streams
   while q1 runs cold and 16 more programs are captured; some upload
   must be queued while a capture is open, every upload must equal its
   source and every program its eager result;
8. the adaptive pass: q3, q5 and a hash-shuffled aggregate
   (``agg.partitions=8``, grouped by ``l_suppkey``) at SF1 with the pass
   on (the default) and off, each cold and warm from a cleared table
   cache and governor at an 8192 MB budget: results equal the port on
   the CPU and numpy, exactly; the warm collect must replay and capture
   nothing; every observed kernel call bit-equal to the plain version,
   q5's launches counted around its collect; with the pass on, q3's and
   q5's warm collects are timed in turns with the concurrent child
   partitions and with the serial loop (7 pairs: medians, quartiles);
   with the pass on the
   adapted plan is printed and its readers must cover every bucket and
   source fragment once, with the pass off q3 and q5 must hold a
   co-partitioned join. Prints the rules that fired, walls, the
   repartitions' host seconds, count fetches against input batches,
   replays, and a profiled warm collect's card-busy share and
   device-to-host copies;
9. byte-range streaming: q1 at SF1 with lineitem parsed whole and then
   streamed in 128 MB ranges (``io.text.STREAM_CHUNK_BYTES`` set, then
   restored), cold and warm from a cleared table cache and governor:
   each equal to the port on the CPU, the streamed file never cached,
   the kernel's launches counted around each collect and every observed
   call bit-equal to the plain version; prints walls, chunks,
   ``elapsed_parse`` and ``elapsed_h2d``;
10. float sums at SF1: q8, q14 and q17 (the queries with a Float64
   result column) on the card and through the port on the CPU: the
   largest relative error of each float column is printed and must stay
   within rtol 1e-6; every other column exactly;
11. hash partition ids on the card: ``hash_partition_ids`` on full-range
   int64 keys and on SF1 ``l_orderkey``, and ``compute_partition_ids`` on
   ``l_orderkey``, on the utf8 ``l_shipmode`` and on both, for P = 8 and
   P = 7, each equal to the ids the CPU computes, bit for bit;
12. all 22 TPC-H queries at SF0.05 (two files a table, in
   ``bench_data/sf0.05``), fused, on the card and through the port on
   the CPU: integer, decimal, date and string columns equal exactly,
   float columns within rtol 1e-6;
13. Parquet: the SF1 tables converted once to Parquet in
   ``bench_data/sf1_parquet`` (``testing/parquet_convert.py``: the port's
   own ``.tbl`` scan on the CPU and pyarrow, the JAX package converter's
   layout and column types; reused while its ``.complete`` marker holds),
   the pyarrow memory pool's backend, the Parquet bytes beside the
   ``.tbl`` bytes, the host seconds of the Parquet scan's utf8 path on
   ``l_returnflag``; then q1, q3 and q5 from Parquet on the card, cold and
   warm from a cleared table cache and governor at the 8192 MB budget:
   the warm collect served from the table cache (every scan a hit, no
   fill, no parse) and replaying only; each result equal to the same
   query over ``.tbl`` on the card and over the same Parquet on the CPU,
   exactly; kernel launches counted around each collect and every
   observed call bit-equal to the plain version; prints walls,
   ``elapsed_parse``, ``elapsed_h2d``, hits and fills;
14. cluster: a ``LocalCluster(num_executors=2, concurrent_tasks=2)`` in
   this process (the scheduler plans on the CPU, the executors run their
   tasks on the card and serve shuffle files through the port's native
   data-plane server, which must be the ``NativeDataPlane``), queried
   through ``BallistaContext.remote``. q1, q3 and q5 at SF1 with
   lineitem and orders split line-wise into 4 files each (in
   ``bench_data/sf1_split``, cut from the files of the set-up), twice:
   each result equal to the standalone collect on the card (floats
   within rtol 1e-6); every leaf of every task plan the executors
   deserialized on the card; both executors ran tasks; the second run
   captures no graph; kernel launches counted around each collect and
   every observed call bit-equal to the plain version; prints the tasks
   of each stage per executor, the replanner's decisions, the shuffle
   bytes written and read and the cluster wall against the standalone
   warm wall. Then q5 with every read fetched through the data-plane
   sockets, one profiled cluster q5 (card-busy share, device-to-host and
   host-to-device copies and bytes), all 22 queries at SF0.05 through
   the cluster against phase 12's standalone results on the card, and
   ``python -m ballista_tpu_torch.distributed.executor_main --local`` as
   a subprocess on the card: it answers q1 at SF0.05 through
   ``BallistaContext.remote`` and exits 0 through the drain path on
   SIGTERM;
15. observability, EXPLAIN and Flight, at SF1: (a) a fresh process
   (``--first-collect``) runs q1 cold, warm, and cold again after
   clearing the table cache and the governor, and prints each one's
   latency ledger (``ctx.last_query_ledger()``) and lanes
   (``system.query_lanes``): the phases must sum to the wall within
   1 ms, both cold collects must show compile time, the warm one none;
   (b) ``EXPLAIN`` and ``EXPLAIN VERBOSE`` of q1 and q5 on the card must
   equal the port's text on the CPU, and ``EXPLAIN ANALYZE`` of each
   its operators and output rows, the kernel's launches counted around
   each (>= 2) and every observed call bit-equal to the plain version;
   (c) ``EXPLAIN ANALYZE`` q1 through a ``LocalCluster(2, 2)`` on the
   card runs as one task whose operators and rows equal the standalone
   ANALYZE's, launches counted; (d) ``scheduler_main --flight-port 0
   --device cuda`` in a process of its own with two executors of this
   process on the card: a ``pyarrow.flight`` client registers the tables
   with DDL tickets, q1 (launches counted) and ``EXPLAIN`` q1 equal the
   standalone results, and SIGTERM drains the scheduler (exit 0); (e) a
   cold q5 with ``on_progress`` sampling every 10 ms equals the cold q5
   without it and captures as many graphs, its last snapshot at
   fraction 1.0; (f) warm q1 timed in turns (7 rounds, medians) with
   the ledger and the query history on, with both off, and without the
   recorder;
16. scalar subqueries, prewarm and AOT: (a) q11, q15 and q22 at SF1
   server-planned (``plan.server=on``) through a ``LocalCluster(2, 2)`` on
   the card, whose scheduler runs each query's scalar subquery on the
   card: results equal the standalone collect on the card and the port
   on the CPU, the literal each subquery becomes on the scheduler, on
   the standalone card and on the CPU is logged and must agree (decimal,
   date and integer exactly, float within rtol 1e-6), the kernel's
   launches counted per query and inside its subquery, every observed
   call bit-equal to the plain version; (b) the same three at SF0.05
   over ``scheduler_main --flight-port 0 --device cuda`` (the loopback
   context resolves the subqueries on the card), equal to phase 12's
   standalone results, the kernel calls of their tasks (in this
   process's executors) bit-equal to the plain version; (c) in fresh processes (``--prewarm-child``),
   three with ``BALLISTA_PREWARM=1`` and three without in turns, then
   one without it under ``CUDA_MODULE_LOADING=EAGER``, the process's
   first q1 and first q6 at SF1: wall, the ledger's phases and lanes, the prewarm
   pass's programs, seconds and failures (must be 0), the real call's
   captures, the foreground's wait on the capture lock, the kernel's
   launches (the prewarm warm-up's included), each of its calls bit-equal
   to the plain version, and the card memory the process holds after the
   collect; every result equal to the first run's, q1 also to the port on the CPU; (d) q1 with
   ``BALLISTA_FUSION_AOT_DIR`` naming an empty directory: it stays
   empty, ``aot_loads`` and ``aot_exports`` 0, the result equal;
17. the mesh: a ``LocalCluster(2, 2, num_devices=4)`` on the card (four
   mesh slots an executor, all on the card) runs q1, q3 and q5 at SF1
   (lineitem and orders in 4 files, ``agg.partitions=4``) three times
   through mesh-fused stages: every task plan on the card, q1's holding a
   ``MeshAggExec`` and q3's and q5's a ``MeshJoinExec`` over 4 slots;
   each result equal to phase 14's unfused cluster and the numpy
   implementations (floats within rtol 1e-6); every observed kernel call
   bit-equal to the plain version, q1's final aggregate launching it once
   per slot; walls, captures, replays, peak memory and launches per run,
   and a profiled repeated q5 (card-busy share). Then each join type
   (inner, left, semi, anti, full, left with NULL keys, null-aware anti)
   of ``MeshJoinExec`` over 4 slots against ``JoinExec`` on the card, on
   a seeded pair of 1,000,000 probe and 250,000 build rows, row for row;
   and ``executor_main --local --num-devices 4`` fusing q1 at SF0.05
   (equal to the standalone result, 4 slots reported, drained on
   SIGTERM). The cross-process path is not run: one card;
18. the measurement entry points: (a) ``ballista_tpu_torch.
   bench`` in this process at SF1 with 3 runs, from a cleared governor,
   under an observer that holds every kernel call it makes against the
   plain version as the call happens, bit for bit; its q1 equal to
   phase 4's numpy result, every field of the line present and its
   ``value`` above 0; (b) ``python -m ballista_tpu_torch.bench --scale
   0.05 --runs 1`` as a child process on the card: its last line parses
   and names the card; (c) the TPC-H CLI's ``benchmark``, q1 and q5 at
   SF1 standalone (equal to numpy and to the port on the CPU) and q1 at
   SF0.05 through ``--host``/``--port`` against a ``LocalCluster`` on the
   card (equal to phase 12); (d) ``bench_serving``'s three phases at
   SF0.05, 4 sessions of 6 queries (no serving error, a recovered job, an
   autoscaling event); (e) the scaling curves over 1, 2 and 4 slots on
   the card (each strong curve's results equal at every slot count);
19. in a process of its own, a governed program that cannot be captured
   (it reads a device value on the host) must raise ``CaptureError``
   rather than run eagerly;
20. the kernel list, as one JSON line; its times, replicas and VEC are
    those on q1's main-path inputs, with q5's launches and times beside
    them, and the launches of q5 through the adapted join, of q1 over
    the streamed lineitem, of q1 and q5 from Parquet, of q1 and q5
    through the cluster's executor tasks (their first runs), of
    ``EXPLAIN ANALYZE`` q1 and q5 standalone and q1 through the cluster,
    of q1 sent over Arrow Flight, of the first q1 with the prewarm pass
    on and off (per fresh process), inside each server-planned
    subquery, of the first mesh q1 (``mesh_q1_launches``; 4 of them
    its final aggregate's, one per slot), of the whole bench run of
    phase 18 (``bench_launches``) and of one warm q1 inside it
    (``bench_q1_launches``).

It uses one card: the first that ``CUDA_VISIBLE_DEVICES`` lists, else
card 0. The last line of standard output is ``{"ok": true, "device":
{...}}``. Option: ``--profile`` (one more warm collect each of q1, q3 and
q5 under ``torch.profiler``: device time by kernel, the share of the wall
time the card was busy, and the operators' metrics).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
QUERY_DIR = os.path.join("benchmarks", "tpch", "queries")
SCALE = 1.0  # TPC-H scale factor: lineitem holds about 6.0 M rows
SMALL_SCALE = 0.05  # the 22-query check: lineitem holds about 300 K rows
QUERIES = [f"q{i}" for i in range(1, 23)]
HOLD_CYCLES = 4_000_000  # about 2 ms: longer than queueing one call
FLUSH_BYTES = 256 << 20  # written before every timed call: 5x the 50 MB L2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3, hold: bool = True) -> float:
    """Mean milliseconds of one ``fn()`` call on the card, each call timed
    by its own pair of CUDA events after a write of ``FLUSH_BYTES`` has
    evicted its inputs from the L2 cache, as a caller whose inputs another
    operator just produced finds it. With ``hold``, a sleep on the card
    holds the stream while the host queues the call, so the events time
    the device's work; without it, the card waits for the host, and the
    events time the call as its caller sees it, host-side launch
    included."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        else:
            torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in times) / iters


# -- phase 1 ----------------------------------------------------------------


def use_one_card() -> str:
    """Makes the first card ``CUDA_VISIBLE_DEVICES`` lists (card 0 when
    unset) the only one this process sees, before CUDA starts, and
    returns its id; an empty list stays empty and shows no card."""
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"  # nvidia-smi's order
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    return card


def phase_card(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(out)
    return out


# -- phase 2 ----------------------------------------------------------------


def phase_build() -> None:
    from ballista_tpu_torch import native_build
    from ballista_tpu_torch.io import native
    from ballista_tpu_torch.kernels import dense_sums

    errors = []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)
            return
        log(f"# built {name} in {time.perf_counter() - t0:.2f}s")

    threads = [threading.Thread(target=run, args=("dense_grouped_sums (nvcc)",
                                                  dense_sums.build)),
               threading.Thread(target=run, args=("tblscan (g++)",
                                                  native.build)),
               threading.Thread(target=run, args=(
                   "shuffle_server (g++)",
                   native_build.build_shuffle_server))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def setup_data(scale: float = SCALE, num_parts: int = 1) -> str:
    from benchmarks.tpch import datagen

    data_dir = os.path.join("bench_data", f"sf{scale:g}")
    marker = os.path.join(data_dir, ".complete")
    want = f"v{datagen.DATAGEN_VERSION} parts={num_parts}"
    have = open(marker).read().strip() if os.path.exists(marker) else None
    if have != want:
        t0 = time.perf_counter()
        datagen.generate(data_dir, scale=scale, num_parts=num_parts)
        with open(marker, "w") as f:
            f.write(want)
        log(f"# set-up: generated TPC-H sf{scale:g} in "
            f"{time.perf_counter() - t0:.1f}s")
    else:
        log(f"# set-up: reusing TPC-H sf{scale:g} ({want})")
    return data_dir


def lineitem_rows(data_dir: str) -> int:
    path = os.path.join(data_dir, "lineitem", "partition0.tbl")
    with open(path, "rb") as f:
        return sum(chunk.count(b"\n")
                   for chunk in iter(lambda: f.read(1 << 24), b""))


# -- phase 3 ----------------------------------------------------------------


def kernel_bound_ms(n_rows: int, n_live: int, k: int, g: int):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (gids 4 B, live 1 B and K int64 values per row read once, the
    [G, K+1] int64 sums and [G] int64 first rows written once) over the
    memory rate, and its K+1 integer additions and one comparison per
    live row over the float32 rate (the card lists no int64 rate; integer
    operations are no faster)."""
    nbytes = n_rows * (4 + 1 + 8 * k) + g * (k + 2) * 8
    ops = n_live * (k + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(gids, live, values, g: int, label: str, timed: bool,
                 vec: Optional[int] = 4):
    """Kernel vs plain version on the same inputs, bit for bit in sums,
    counts and first rows, after checking that the launch plan uses the
    ``vec`` instantiation (any, when None); with ``timed``, also the
    times. Returns a dict of the numbers."""
    from ballista_tpu_torch.kernels import dense_sums as ds

    plan = ds.launch_plan(gids, live, values, g)
    if vec is not None and plan.vec != vec:
        raise AssertionError(f"{label}: planned VEC = {plan.vec}, "
                             f"expected {vec}")
    sums, counts, first = ds.dense_grouped_sums(gids, live, values, g)
    torch.cuda.synchronize()
    ref_sums, ref_counts, ref_first = ds.dense_grouped_sums_reference(
        gids, live, values, g)
    got = torch.stack(sums + [counts, first])
    want = torch.stack(ref_sums + [ref_counts, ref_first])
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{label}: kernel differs from its plain "
                             f"version in {bad} of {got.numel()} results "
                             f"(first rows {first.tolist()[:8]} vs "
                             f"{ref_first.tolist()[:8]})")
    n, k = int(gids.shape[0]), len(values)
    res = {"n": n, "k": k, "g": g, "max_abs_err": 0,  # bit-equal
           "vec": plan.vec, "replicas": plan.launches[0].replicas,
           "blocks": plan.launches[0].blocks}
    if timed:
        res["ms"] = cuda_ms(lambda: ds.dense_grouped_sums(gids, live,
                                                          values, g))
        res["call_ms"] = cuda_ms(lambda: ds.dense_grouped_sums(
            gids, live, values, g), hold=False)
        res["plain_ms"] = cuda_ms(lambda: ds.dense_grouped_sums_reference(
            gids, live, values, g))
        # yardstick: ONE index_add_ over all K+1 columns, inputs prepared
        # outside the timed call (the port never calls this)
        slot = torch.where(live & (gids >= 0) & (gids < g),
                           gids.to(torch.int64), g)
        stacked = torch.stack(list(values) + [live.to(torch.int64)], dim=1)
        acc = torch.zeros((g + 1, k + 1), dtype=torch.int64,
                          device=gids.device)
        res["library_ms"] = cuda_ms(lambda: acc.index_add_(0, slot, stacked))
        # and ONE scatter_reduce_ that finds the first rows, as the port
        # did before the kernel found them (the port never calls it)
        pos = torch.arange(n, dtype=torch.int64, device=gids.device)
        low = torch.full((g + 1,), n, dtype=torch.int64, device=gids.device)
        res["first_row_ms"] = cuda_ms(
            lambda: low.scatter_reduce_(0, slot, pos, reduce="amin"))
        del slot, stacked, pos
        n_live = int((live & (gids >= 0) & (gids < g)).sum())
        res["bound_ms"], res["bound_by"] = kernel_bound_ms(n, n_live, k, g)
    log(f"# {label}: N={n} G={g} K={k} bit-equal to the plain version "
        f"(VEC={res['vec']}, R={res['replicas']}, {res['blocks']} blocks)"
        + (f"; kernel {res['ms']:.4f} ms (with its host-side launch "
           f"{res['call_ms']:.4f} ms), plain {res['plain_ms']:.4f} ms, "
           f"index_add_ {res['library_ms']:.4f} ms, first-row "
           f"scatter_reduce_ {res['first_row_ms']:.4f} ms, bound "
           f"{res['bound_ms']:.4f} ms ({res['bound_by']}), "
           f"{100 * res['bound_ms'] / res['ms']:.1f}% of the bound"
           if timed else ""))
    return res


def q1_partial_slots(rows: int) -> int:
    """Slots of the batch q1's partial aggregate sees: the scan's
    batches of ``DEFAULT_BATCH_CAPACITY`` rows (or one ladder rung when
    the file is smaller), concatenated."""
    from ballista_tpu_torch.columnar import DEFAULT_BATCH_CAPACITY
    from ballista_tpu_torch.compile import bucket_capacity

    cap = min(DEFAULT_BATCH_CAPACITY, bucket_capacity(max(rows, 1)))
    return -(-max(rows, 1) // cap) * cap


def phase_kernel_check(rows: int):
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")

    # case 1: q1's partial shape, rows spread evenly over the groups
    n, g, k = q1_partial_slots(rows), 6, 7
    gids = torch.from_numpy(rng.integers(0, g, n, dtype=np.int32)).to(dev)
    live = torch.from_numpy(rng.random(n) >= 0.02).to(dev)
    values = [torch.from_numpy(rng.integers(0, 10 ** 12, n)).to(dev)
              for _ in range(k)]
    q1_shape = check_kernel(gids, live, values, g,
                            "q1 partial shape, even groups", timed=True)
    del gids, live, values

    # case 2: G = 256, 4 sums + 2 validity masks as 0/1 columns (the
    # aggregate layer's encoding), ragged N, values spanning int64
    n, g = 3_000_017, 256
    gids = torch.from_numpy(rng.integers(0, g, n, dtype=np.int32)).to(dev)
    live = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    full = [torch.from_numpy(rng.integers(np.iinfo(np.int64).min,
                                          np.iinfo(np.int64).max, n,
                                          endpoint=True)).to(dev)
            for _ in range(4)]
    masks = [torch.from_numpy(rng.random(n) < 0.5).to(dev) for _ in range(2)]
    values = [torch.where(masks[i % 2], v, 0) for i, v in enumerate(full)]
    values += [m.to(torch.int64) for m in masks]
    check_kernel(gids, live, values, g, "G=256 wrapping", timed=True)
    del gids, live, full, masks, values

    # cases 3 and 4: every live row in one group, the worst contention
    n = q1_partial_slots(rows)
    for g, k in ((6, 7), (256, 6)):
        gids = torch.full((n,), g // 2, dtype=torch.int32, device=dev)
        live = torch.from_numpy(rng.random(n) >= 0.02).to(dev)
        values = [torch.from_numpy(rng.integers(0, 10 ** 12, n)).to(dev)
                  for _ in range(k)]
        check_kernel(gids, live, values, g, f"G={g}, one group", timed=True)
        del gids, live, values

    # case 5: first live rows far beyond the first block's rows: group 3's
    # rows are dead before row n/2, group 5 appears only near the end, and
    # group 4 never has a live row
    n, g, k = q1_partial_slots(rows), 6, 7
    gids_np = rng.integers(0, 4, n, dtype=np.int32)
    gids_np[n - 1000:n - 10] = 5
    gids_np[rng.random(n) < 0.01] = 4
    live_np = rng.random(n) >= 0.02
    live_np[(gids_np == 3) & (np.arange(n) < n // 2)] = False
    live_np[gids_np == 4] = False
    gids = torch.from_numpy(gids_np).to(dev)
    live = torch.from_numpy(live_np).to(dev)
    values = [torch.from_numpy(rng.integers(0, 10 ** 12, n)).to(dev)
              for _ in range(k)]
    check_kernel(gids, live, values, g, "late first rows", timed=True)
    del gids, live, values, gids_np, live_np

    # case 6: misaligned views (base[1:] of every column), ragged N: the
    # VEC = 1 instantiation
    n, g, k = q1_partial_slots(rows) - 3, 6, 7
    gids = torch.from_numpy(rng.integers(0, g, n + 1,
                                         dtype=np.int32)).to(dev)[1:]
    live = torch.from_numpy(rng.random(n + 1) >= 0.02).to(dev)[1:]
    values = [torch.from_numpy(rng.integers(0, 10 ** 12, n + 1)).to(dev)[1:]
              for _ in range(k)]
    check_kernel(gids, live, values, g, "misaligned, ragged", timed=True,
                 vec=1)
    del gids, live, values

    # case 7: the final aggregate's width (K = 12, R = 32): six rows (one
    # four-row step and a ragged tail of two), and a ragged N over many
    # blocks
    g, k = 6, 12
    for n in (6, 1_000_002):
        gids = torch.from_numpy(rng.integers(0, g, n, dtype=np.int32)).to(dev)
        live = torch.from_numpy(rng.random(n) >= 0.02).to(dev)
        values = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n))
                  .to(dev) for _ in range(k)]
        check_kernel(gids, live, values, g, f"K=12, N={n}", timed=False)
        del gids, live, values

    # case 8: more value columns than one launch takes (two launches), each
    # with [G, K+1] accumulators above the default 48 KB of shared memory
    n, g, k = 200_003, 256, 100
    gids = torch.from_numpy(rng.integers(-3, g + 3, n, dtype=np.int32)).to(dev)
    live = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    values = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)).to(dev)
              for _ in range(k)]
    check_kernel(gids, live, values, g, "K=100, two launches", timed=False)
    return q1_shape


# -- phase 4 ----------------------------------------------------------------


class KernelCallLog:
    """Keeps a copy of the inputs and outputs of every executed call of
    ``dense_grouped_sums`` while it is entered — eager calls, and the
    calls replayed inside a captured CUDA graph, whose tensors are the
    graph's static buffers (``dense_sums.observe``) — to hold each call's
    outputs against the plain version on its inputs afterwards. Counts
    nothing and launches nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, gids, live, values, num_groups, sums, counts, first):
        self.calls.append((gids.clone(), live.clone(),
                           [v.clone() for v in values], num_groups,
                           [t.clone() for t in sums], counts.clone(),
                           first.clone()))

    def __enter__(self):
        from ballista_tpu_torch.kernels import dense_sums as ds

        self._observing = ds.observe(self)
        self._observing.__enter__()
        return self

    def __exit__(self, *exc):
        return self._observing.__exit__(*exc)

    def inputs(self, i: int):
        gids, live, values, g = self.calls[i][:4]
        return gids, live, values, g


def check_observed(calls, label: str) -> None:
    """Each observed call's sums, counts and first rows against the plain
    version on that call's inputs, bit for bit."""
    from ballista_tpu_torch.kernels import dense_sums as ds

    for i, (gids, live, values, g, sums, counts, first) in enumerate(calls):
        ref_sums, ref_counts, ref_first = ds.dense_grouped_sums_reference(
            gids, live, values, g)
        got = torch.stack(sums + [counts, first])
        want = torch.stack(ref_sums + [ref_counts, ref_first])
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(
                f"{label}: observed call {i + 1} of {len(calls)} differs "
                f"from the plain version in {bad} of {got.numel()} results")
    log(f"# {label}: all {len(calls)} observed kernel calls bit-equal to "
        f"the plain version")


def graph_replay_ms(gids, live, values, g):
    """(device ms, ms with the host's launch) of one replay of a CUDA
    graph that holds only the kernel's call on these inputs — the
    launch a governed program pays for the kernel, against ``call_ms``'s
    Python wrapper. Captured through the governor (so the capture counts
    nothing); the replays are timed on the graph itself, outside every
    counted window."""
    from ballista_tpu_torch.compile import governed
    from ballista_tpu_torch.kernels import dense_sums as ds

    gf = governed(("agg.grouped", "chip_smoke.kernel_only"),
                  lambda: ds.dense_grouped_sums)
    gf(gids, live, values, g)  # warm-up and capture
    prog = next(iter(gf.programs.values()))
    ref = ds.dense_grouped_sums_reference(gids, live, values, g)
    prog.graph.replay()
    torch.cuda.synchronize()
    got = torch.stack([t for t in prog.static_out])
    want = torch.stack(ref[0] + [ref[1], ref[2]])
    if not torch.equal(got, want):
        raise AssertionError("the kernel replayed in its graph differs "
                             "from the plain version")
    return cuda_ms(prog.graph.replay), cuda_ms(prog.graph.replay,
                                                 hold=False)


def misaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to ``base[1:]`` of a one-longer tensor: off the 16-byte
    (int32, int64) and 4-byte (bool) alignment of an allocation."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    base[1:].copy_(t)
    return base[1:]


def numpy_reference(data_dir: str):
    """q1 and q6 computed from the scanned columns with numpy in int64 —
    an implementation independent of the port's operators. Returns the
    logical values the engine's collect produces."""
    from ballista_tpu_torch.io import native
    from ballista_tpu_torch.testing.tpch_schema import TPCH_SCHEMAS

    sch = TPCH_SCHEMAS["lineitem"]
    cols = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus", "l_shipdate"]
    path = os.path.join(data_dir, "lineitem", "partition0.tbl")
    n, a, dicts, valids = native.scan_file(path, sch, cols)
    if valids:
        raise AssertionError(f"unexpected NULLs in {sorted(valids)}")
    day = lambda s: int(np.datetime64(s, "D").astype(np.int64))  # noqa: E731
    qty, price, disc, tax = (a[c].astype(np.int64) for c in cols[:4])
    ship = a["l_shipdate"]

    # q1: l_shipdate <= 1998-12-01 - 90 days; scales 2, 2, 4, 6
    m = ship <= day("1998-09-02")
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    rf = np.asarray(dicts["l_returnflag"], dtype=object)[a["l_returnflag"]]
    ls = np.asarray(dicts["l_linestatus"], dtype=object)[a["l_linestatus"]]
    keys = sorted(set(zip(rf[m], ls[m])))
    q1 = {c: [] for c in ("l_returnflag", "l_linestatus", "sum_qty",
                          "sum_base_price", "sum_disc_price", "sum_charge",
                          "avg_qty", "avg_price", "avg_disc", "count_order")}

    def avg6(total: int, count: int, scale: int) -> int:
        # Decimal(6) average truncated toward zero (total >= 0 here)
        return (total * 10 ** (6 - scale)) // count

    for r, s in keys:
        g = m & (rf == r) & (ls == s)
        cnt = int(g.sum())
        sq, sp = int(qty[g].sum()), int(price[g].sum())
        sd = int(disc[g].sum())
        q1["l_returnflag"].append(r)
        q1["l_linestatus"].append(s)
        q1["sum_qty"].append((sq, 2))
        q1["sum_base_price"].append((sp, 2))
        q1["sum_disc_price"].append((int(disc_price[g].sum()), 4))
        q1["sum_charge"].append((int(charge[g].sum()), 6))
        q1["avg_qty"].append((avg6(sq, cnt, 2), 6))
        q1["avg_price"].append((avg6(sp, cnt, 2), 6))
        q1["avg_disc"].append((avg6(sd, cnt, 2), 6))
        q1["count_order"].append(cnt)

    # q6: revenue = sum(price * disc), scale 4
    m6 = ((ship >= day("1994-01-01")) & (ship < day("1995-01-01"))
          & (disc >= 5) & (disc <= 7) & (qty < 2400))
    q6 = {"revenue": [(int((price[m6] * disc[m6]).sum()), 4)]}

    def decode(d):
        out = {}
        for k, v in d.items():
            if v and isinstance(v[0], tuple):
                out[k] = (np.asarray([x for x, _ in v], np.int64)
                          .astype(np.float64) / (10.0 ** v[0][1]))
            else:
                out[k] = np.asarray(v, dtype=object if isinstance(v[0], str)
                                    else np.int64)
        return out

    return {"q1": decode(q1), "q6": decode(q6)}


def assert_equal_results(name: str, got, want) -> None:
    if list(got) != list(want):
        raise AssertionError(f"{name}: columns {list(got)} != {list(want)}")
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{name}.{c}: {g[:8]} != {w[:8]}")


def phase_queries(data_dir: str):
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.kernels import dense_sums as ds
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    sqls = {q: open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
            for q in ("q1", "q6")}
    rows = lineitem_rows(data_dir)
    ctx = BallistaContext.standalone()  # device="cuda"
    register_tpch(ctx, data_dir, tables=["lineitem"])
    results, timings, launches = {}, {}, []
    spy_shapes, main_calls = [], []
    for q in ("q1", "q6"):
        for run in ("cold", "warm"):
            df = ctx.sql(sqls[q])
            with KernelCallLog() as spy:
                torch.cuda.synchronize()
                ds.launch_count = 0
                t0 = time.perf_counter()
                out = df.to_pydict()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                n_launch = ds.launch_count
            spy_shapes += [(int(c[0].shape[0]), len(c[2]), c[3])
                           for c in spy.calls]
            # every call, the warm collect's graph replays included
            check_observed(spy.calls, f"{q} {run}")
            if q == "q1" and run == "cold":
                main_calls = [spy.inputs(i) for i in range(len(spy.calls))]
            if q == "q1":
                launches.append(n_launch)
                if n_launch < 2:
                    raise AssertionError(
                        f"q1 {run}: dense_grouped_sums launched "
                        f"{n_launch} times, expected >= 2 (partial + final)")
            timings[f"{q}_{run}_s"] = secs
            log(f"# {q} {run}: {secs:.4f} s, {rows / secs:,.0f} rows/s, "
                f"dense_grouped_sums launches {n_launch}")
            results[(q, run)] = out
    for q in ("q1", "q6"):
        assert_equal_results(f"{q} warm vs cold", results[(q, "warm")],
                             results[(q, "cold")])

    # the kernel on the exact inputs of every call in q1's cold collect
    # (partial and final aggregate); the first, the partial one, is timed
    if len(main_calls) < 2:
        raise AssertionError(f"q1 called dense_grouped_sums "
                             f"{len(main_calls)} times, expected >= 2")
    checked = [check_kernel(gids, live, values, g,
                            f"q1 main-path call {i + 1} of {len(main_calls)}",
                            timed=i == 0, vec=None)
               for i, (gids, live, values, g) in enumerate(main_calls)]
    main_path = checked[0]
    # the partial aggregate's inputs again, off the vector alignment: the
    # VEC = 1 instantiation on the same rows
    gids, live, values, g = main_calls[0]
    off = [misaligned_copy(t) for t in [gids, live] + values]
    vec1 = check_kernel(off[0], off[1], off[2:], g,
                        "q1 main-path call 1, misaligned copy", timed=True,
                        vec=1)
    main_path["vec1_ms"] = vec1["ms"]
    # the same call replayed inside a CUDA graph that holds only it
    main_path["graph_ms"], main_path["graph_call_ms"] = graph_replay_ms(
        gids, live, values, g)
    log(f"# q1 main-path call 1 replayed in its own graph: "
        f"{main_path['graph_ms']:.4f} ms on the card, "
        f"{main_path['graph_call_ms']:.4f} ms with the host's launch "
        f"(launched directly: {main_path['ms']:.4f} / "
        f"{main_path['call_ms']:.4f} ms)")
    del main_calls, gids, live, values, off

    # the same queries through the port on the CPU
    cpu = BallistaContext.standalone(device="cpu")
    register_tpch(cpu, data_dir, tables=["lineitem"])
    ref = numpy_reference(data_dir)
    for q in ("q1", "q6"):
        got = results[(q, "cold")]
        assert_equal_results(f"{q} cuda vs cpu", got,
                             cpu.sql(sqls[q]).to_pydict())
        assert_equal_results(f"{q} cuda vs numpy", got, ref[q])
        log(f"# {q}: cuda == port on cpu == numpy group-by "
            f"({len(next(iter(got.values())))} rows)")
    return timings, launches, sorted(set(spy_shapes)), main_path, ref["q1"]


# -- phase 5 ----------------------------------------------------------------


def scan_table(data_dir: str, table: str, cols):
    """Columns of one TPC-H table as the native scanner parses them, utf8
    columns decoded to Python strings."""
    from ballista_tpu_torch.io import native
    from ballista_tpu_torch.testing.tpch_schema import TPCH_SCHEMAS

    path = os.path.join(data_dir, table, "partition0.tbl")
    _, a, dicts, valids = native.scan_file(path, TPCH_SCHEMAS[table], cols)
    if valids:
        raise AssertionError(f"unexpected NULLs in {sorted(valids)}")
    return {c: (np.asarray(dicts[c], dtype=object)[a[c]] if c in dicts
                else a[c]) for c in cols}


def day(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


def pk_lookup(pk: np.ndarray, probe: np.ndarray):
    """(found, row): the row of each probe key in the unique key column
    ``pk``, by a sorted search."""
    order = np.argsort(pk, kind="stable")
    spk = pk[order]
    pos = np.minimum(np.searchsorted(spk, probe), len(spk) - 1)
    return spk[pos] == probe, order[pos]


def group_sums(keys: np.ndarray, values: np.ndarray):
    """(unique keys, exact int64 sum per key)."""
    order = np.argsort(keys, kind="stable")
    k, v = keys[order], values[order]
    if not len(k):
        return k, v
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    return k[starts], np.add.reduceat(v, starts)


def numpy_q3(data_dir: str):
    """TPC-H q3 with numpy over the scanned columns: sorted-key joins,
    int64 revenue at scale 4 (price and discount are Decimal(2))."""
    c = scan_table(data_dir, "customer", ["c_custkey", "c_mktsegment"])
    o = scan_table(data_dir, "orders", ["o_orderkey", "o_custkey",
                                        "o_orderdate", "o_shippriority"])
    li = scan_table(data_dir, "lineitem", ["l_orderkey", "l_extendedprice",
                                           "l_discount", "l_shipdate"])
    cut = day("1995-03-15")
    building = np.sort(c["c_custkey"][c["c_mktsegment"] == "BUILDING"])
    pos = np.minimum(np.searchsorted(building, o["o_custkey"]),
                     len(building) - 1)
    om = (o["o_orderdate"] < cut) & (building[pos] == o["o_custkey"])
    found, row = pk_lookup(o["o_orderkey"], li["l_orderkey"])
    keep = found & om[row] & (li["l_shipdate"] > cut)
    rev = (li["l_extendedprice"].astype(np.int64)
           * (100 - li["l_discount"].astype(np.int64)))[keep]
    keys, sums = group_sums(li["l_orderkey"][keep], rev)
    _, orow = pk_lookup(o["o_orderkey"], keys)
    date = o["o_orderdate"][orow]
    top = np.lexsort((keys, date, -sums))[:10]
    return {"l_orderkey": keys[top],
            "revenue": sums[top].astype(np.float64) / 1e4,
            "o_orderdate": date[top].astype("datetime64[D]"),
            "o_shippriority": o["o_shippriority"][orow][top]}


def numpy_q5(data_dir: str):
    """TPC-H q5 with numpy over the scanned columns."""
    r = scan_table(data_dir, "region", ["r_regionkey", "r_name"])
    n = scan_table(data_dir, "nation", ["n_nationkey", "n_name",
                                        "n_regionkey"])
    s = scan_table(data_dir, "supplier", ["s_suppkey", "s_nationkey"])
    c = scan_table(data_dir, "customer", ["c_custkey", "c_nationkey"])
    o = scan_table(data_dir, "orders", ["o_orderkey", "o_custkey",
                                        "o_orderdate"])
    li = scan_table(data_dir, "lineitem", ["l_orderkey", "l_suppkey",
                                           "l_extendedprice", "l_discount"])
    asia = r["r_regionkey"][r["r_name"] == "ASIA"]
    f_o, orow = pk_lookup(o["o_orderkey"], li["l_orderkey"])
    odate = o["o_orderdate"][orow]
    f_c, crow = pk_lookup(c["c_custkey"], o["o_custkey"][orow])
    f_s, srow = pk_lookup(s["s_suppkey"], li["l_suppkey"])
    snat = s["s_nationkey"][srow]
    f_n, nrow = pk_lookup(n["n_nationkey"], snat)
    keep = (f_o & f_c & f_s & f_n
            & (odate >= day("1994-01-01")) & (odate < day("1995-01-01"))
            & (c["c_nationkey"][crow] == snat)
            & np.isin(n["n_regionkey"][nrow], asia))
    rev = (li["l_extendedprice"].astype(np.int64)
           * (100 - li["l_discount"].astype(np.int64)))[keep]
    keys, sums = group_sums(nrow[keep], rev)
    top = np.lexsort((keys, -sums))
    return {"n_name": n["n_name"][keys[top]],
            "revenue": sums[top].astype(np.float64) / 1e4}


def find_nodes(plan, cls):
    out = [plan] if isinstance(plan, cls) else []
    for c in plan.children():
        out += find_nodes(c, cls)
    return out


def phase_joins(data_dir: str):
    """q3 and q5 at SF1: plans, launch counts, the kernel on every q5
    call, results against the port on the CPU and numpy."""
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.execution import plan_logical
    from ballista_tpu_torch.kernels import dense_sums as ds
    from ballista_tpu_torch.physical.fusion import maybe_fuse
    from ballista_tpu_torch.physical.join import JoinExec
    from ballista_tpu_torch.physical.operators import RepartitionExec
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    ctx = BallistaContext.standalone()  # device="cuda"
    register_tpch(ctx, data_dir)
    timings, q5_launches, q5_calls, results = {}, [], [], {}
    for q in ("q3", "q5"):
        df = ctx.sql(open(os.path.join(QUERY_DIR, f"{q}.sql")).read())
        for run in ("cold", "warm"):
            with KernelCallLog() as spy:
                torch.cuda.synchronize()
                ds.launch_count = 0
                t0 = time.perf_counter()
                out = df.to_pydict()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                n_launch = ds.launch_count
            check_observed(spy.calls, f"{q} {run}")
            if q == "q5":
                q5_launches.append(n_launch)
                if n_launch < 2:
                    raise AssertionError(
                        f"q5 {run}: dense_grouped_sums launched {n_launch} "
                        f"times, expected >= 2 (partial + final)")
                if run == "cold":
                    q5_calls = [spy.inputs(i) for i in range(len(spy.calls))]
            timings[f"{q}_{run}_s"] = secs
            log(f"# {q} {run}: {secs:.4f} s, dense_grouped_sums launches "
                f"{n_launch}")
            results[(q, run)] = out
        assert_equal_results(f"{q} warm vs cold", results[(q, "warm")],
                             results[(q, "cold")])
        plan = df.physical_plan()
        for line in plan.pretty().splitlines():
            log(f"#   {line}")
        if q == "q3":
            # the planner's plan, before the adaptive pass rewrites its
            # readers (phase 8 runs it with the pass off and on)
            off = BallistaContext.standalone(**{"adaptive.enabled": "off"})
            register_tpch(off, data_dir)
            planned = maybe_fuse(plan_logical(off.sql(
                open(os.path.join(QUERY_DIR, "q3.sql")).read()).plan,
                off._planner_options()))
            copart = [j for j in find_nodes(planned, JoinExec)
                      if j.partitioned
                      and isinstance(j.build, RepartitionExec)
                      and isinstance(j.probe, RepartitionExec)]
            if not copart:
                raise AssertionError("q3's plan holds no co-partitioned "
                                     "JoinExec over two RepartitionExecs")

    # the kernel on the inputs of every call of q5's cold collect; the
    # call with the most rows is timed
    if len(q5_calls) < 2:
        raise AssertionError(f"q5 called dense_grouped_sums "
                             f"{len(q5_calls)} times, expected >= 2")
    biggest = max(range(len(q5_calls)),
                  key=lambda i: int(q5_calls[i][0].shape[0]))
    checked = [check_kernel(gids, live, values, g,
                            f"q5 main-path call {i + 1} of {len(q5_calls)}",
                            timed=i == biggest, vec=None)
               for i, (gids, live, values, g) in enumerate(q5_calls)]
    q5_main = checked[biggest]
    q5_shapes = sorted({(c["n"], c["k"], c["g"]) for c in checked})
    del q5_calls

    cpu = BallistaContext.standalone(device="cpu")
    register_tpch(cpu, data_dir)
    refs = {"q3": numpy_q3(data_dir), "q5": numpy_q5(data_dir)}
    for q in ("q3", "q5"):
        got = results[(q, "cold")]
        t0 = time.perf_counter()
        want = cpu.sql(open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
                       ).to_pydict()
        cpu_s = time.perf_counter() - t0
        assert_equal_results(f"{q} cuda vs cpu", got, want)
        assert_equal_results(f"{q} cuda vs numpy", got, refs[q])
        log(f"# {q}: cuda == port on cpu ({cpu_s:.2f} s) == numpy "
            f"({len(next(iter(got.values())))} rows)")
    return timings, q5_launches, q5_main, q5_shapes


# -- phase 6 ----------------------------------------------------------------

FUSION_QUERIES = ("q1", "q3", "q5", "q16")


def count_nodes(plan, names) -> int:
    n = int(type(plan).__name__ in names
            or bool(getattr(plan, "probe_chain", ())))
    return n + sum(count_nodes(c, names) for c in plan.children())


def profile_warm(df):
    """One more warm collect of ``df`` under ``torch.profiler``: (wall s,
    device-busy ms, kernels the card ran, host-side launches by kind,
    device-to-host copies: the host's fetches)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.to_pydict()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, kernels, host, dtoh = 0.0, 0, {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.key.startswith("Memcpy DtoH"):
                dtoh += e.count
            if e.self_device_time_total > 0:
                busy += e.self_device_time_total / 1e3
                if not e.key.startswith(("Memcpy", "Memset")):
                    kernels += e.count
        elif e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cudaGraphLaunch",
                       "cudaMemcpyAsync", "cudaMemsetAsync"):
            host[e.key] = host.get(e.key, 0) + e.count
    return wall, busy, kernels, host, dtoh


def phase_fusion(data_dir: str):
    """q1, q3, q5 and q16 at SF1 with fusion on and with
    ``BALLISTA_FUSION=0``, each from a cleared governor: cold and warm
    collects (the warm one must replay graphs and capture none), results
    against the port on the CPU, every kernel call observed and held
    against the plain version, captures, replays and peak memory, and a
    profiled warm collect."""
    import gc

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.compile import compile_stats, governor
    from ballista_tpu_torch.kernels import dense_sums as ds
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    sqls = {q: open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
            for q in FUSION_QUERIES}
    cpu = BallistaContext.standalone(device="cpu")
    register_tpch(cpu, data_dir)
    want = {q: cpu.sql(sqls[q]).to_pydict() for q in FUSION_QUERIES}
    fused_names = ("FusedStageExec", "FusedDistinctCountExec")
    rows = []
    for setting in ("on", "0"):
        os.environ["BALLISTA_FUSION"] = setting
        try:
            for q in FUSION_QUERIES:
                governor().clear()
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                ctx = BallistaContext.standalone()
                register_tpch(ctx, data_dir)
                df = ctx.sql(sqls[q])
                row = {"query": q, "fusion": setting}
                with KernelCallLog() as spy:
                    for run in ("cold", "warm"):
                        st0 = compile_stats()
                        ds.launch_count = 0
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        out = df.to_pydict()
                        torch.cuda.synchronize()
                        row[f"{run}_s"] = time.perf_counter() - t0
                        st1 = compile_stats()
                        row[f"{run}_captures"] = (st1["graph_captures"]
                                                  - st0["graph_captures"])
                        row[f"{run}_replays"] = (st1["graph_replays"]
                                                 - st0["graph_replays"])
                        row[f"{run}_capture_s"] = (st1["capture_seconds"]
                                                   - st0["capture_seconds"])
                        row[f"{run}_kernel_launches"] = ds.launch_count
                        # these four hold no float-computed column:
                        # every column must match exactly
                        assert_equal_results(
                            f"{q} fusion={setting} {run} cuda vs cpu", out,
                            want[q])
                check_observed(spy.calls, f"{q} fusion={setting}")
                row["observed_kernel_calls"] = len(spy.calls)
                del spy
                row["peak_mb"] = (torch.cuda.max_memory_allocated()
                                  - base) / 2 ** 20
                if row["warm_captures"] or not row["warm_replays"]:
                    raise AssertionError(
                        f"{q} fusion={setting}: the warm collect captured "
                        f"{row['warm_captures']} graphs and replayed "
                        f"{row['warm_replays']}; it must replay only")
                if q in ("q1", "q5") and not row["warm_kernel_launches"]:
                    raise AssertionError(
                        f"{q} fusion={setting}: no dense_grouped_sums "
                        f"launch counted in the warm collect's replays")
                fused = count_nodes(df.physical_plan(), fused_names)
                if (fused > 0) != (setting == "on"):
                    raise AssertionError(
                        f"{q} fusion={setting}: {fused} fused nodes")
                if q == "q16" and setting == "on" and count_nodes(
                        df.physical_plan(), ("FusedDistinctCountExec",)) != 1:
                    raise AssertionError("q16 plans no FusedDistinctCountExec")
                row["fused_nodes"] = fused
                (row["profiled_wall_s"], row["busy_ms"],
                 row["device_kernels"], row["host_launches"],
                 row["dtoh_copies"]) = profile_warm(df)
                row["busy_share"] = row["busy_ms"] / (
                    1e3 * row["profiled_wall_s"])
                rows.append(row)
                log(f"# fusion={setting} {q}: cold {row['cold_s']:.4f} s "
                    f"({row['cold_captures']} captures, "
                    f"{row['cold_capture_s']:.3f} s capturing), warm "
                    f"{row['warm_s']:.4f} s ({row['warm_replays']} "
                    f"replays), kernel launches cold/warm "
                    f"{row['cold_kernel_launches']}/"
                    f"{row['warm_kernel_launches']}, peak "
                    f"{row['peak_mb']:.1f} MB over {base / 2 ** 20:.1f} MB; "
                    f"profiled warm {row['profiled_wall_s'] * 1e3:.1f} ms, "
                    f"card busy {row['busy_ms']:.1f} ms "
                    f"({100 * row['busy_share']:.1f}%), "
                    f"{row['device_kernels']} kernels on the card, host "
                    f"launches {json.dumps(row['host_launches'])}; "
                    f"{fused} fused nodes; == port on cpu")
                del df, ctx
        finally:
            os.environ.pop("BALLISTA_FUSION", None)
    governor().clear()
    return rows, want


# -- phase 7 ----------------------------------------------------------------

INGEST_CONFIGS = (
    ("default budget", {}),
    ("8192 MB budget", {"BALLISTA_TABLE_CACHE_BUDGET_MB": "8192"}),
    ("cache off", {"BALLISTA_TABLE_CACHE": "off"}),
    ("serial", {"BALLISTA_PREFETCH_BATCHES": "0",
                "BALLISTA_INGEST_THREADS": "1"}),
)
INGEST_KNOBS = ("BALLISTA_TABLE_CACHE", "BALLISTA_TABLE_CACHE_BUDGET_MB",
                "BALLISTA_PREFETCH_BATCHES", "BALLISTA_INGEST_THREADS")


def set_ingest_env(env: dict) -> None:
    """The ingest and table-cache knobs of one configuration (the rest at
    their defaults), with the ingest pool rebuilt to match."""
    from ballista_tpu_torch import ingest

    for knob in INGEST_KNOBS:
        os.environ.pop(knob, None)
    os.environ.update(env)
    ingest.reconfigure()


def scan_phase_seconds(phys) -> tuple:
    """(elapsed_parse, elapsed_h2d) summed over the plan's scans: the
    host's thread-seconds of the latest collect."""
    from ballista_tpu_torch.physical.operators import ScanExec

    parse = h2d = 0.0
    for node in find_nodes(phys, ScanExec):
        vals = node.metrics().values()
        parse += vals.get("elapsed_parse", 0.0)
        h2d += vals.get("elapsed_h2d", 0.0)
    return parse, h2d


def scan_partitions(phys) -> int:
    from ballista_tpu_torch.physical.operators import ScanExec

    return sum(n.source.num_partitions() for n in find_nodes(phys, ScanExec))


class PinnedSnapshot:
    """A copy of every tensor the table cache pins, taken when it is
    first seen, with its ``_version``: no later query may write into a
    pinned tensor. Entries evicted from the cache are dropped."""

    def __init__(self):
        self.seen = {}

    def check(self, label: str) -> int:
        from ballista_tpu_torch.cache.residency import (batch_tensors,
                                                        process_table_cache)

        now = {id(t): t for b in process_table_cache().pinned_batches()
               for t in batch_tensors(b)}
        for key in [k for k in self.seen if k not in now]:
            del self.seen[key]  # evicted
        for key, (t, version, copy) in self.seen.items():
            if t._version != version or not torch.equal(t, copy):
                raise AssertionError(f"{label}: a tensor the table cache "
                                     f"pins was written")
        for key, t in now.items():
            if key not in self.seen:
                self.seen[key] = (t, t._version, t.clone())
        return len(self.seen)


def profile_copies(fn, label: str) -> dict:
    """``fn()`` under ``torch.profiler``: wall s, card-busy ms, and the
    device-to-host and host-to-device copies with their bytes, read from
    the trace's memcpy records."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0)
    # what held the card longest: kernels by name (a replayed graph's
    # kernels too) and the operators that launched them eagerly
    def top(kind):
        return sorted(((e.key, e.self_device_time_total / 1e3)
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0
                       and e.device_type == kind),
                      key=lambda kv: -kv[1])[:8]
    os.makedirs("bench_data", exist_ok=True)
    path = os.path.join("bench_data", f"trace-{label}-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = {"wall_s": wall, "busy_ms": busy, **{
        name: [[k[:70], round(ms, 4)] for k, ms in top(kind)]
        for name, kind in (
            ("top_kernels_ms", torch.autograd.DeviceType.CUDA),
            ("top_ops_ms", torch.autograd.DeviceType.CPU))}}
    for kind in ("DtoH", "HtoD"):
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"
                  and kind in e.get("name", "")]
        if any("bytes" not in e.get("args", {}) for e in copies):
            raise AssertionError(f"{label}: a memcpy record of the trace "
                                 f"has no byte count")
        out[f"{kind.lower()}_copies"] = len(copies)
        out[f"{kind.lower()}_bytes"] = sum(e["args"]["bytes"] for e in copies)
    return out


def profile_h2d(df, label: str):
    """One more collect of ``df`` under ``torch.profiler``: (wall s,
    card-busy ms, host-to-device copies, their bytes)."""
    out = profile_copies(df.to_pydict, label)
    return out["wall_s"], out["busy_ms"], out["htod_copies"], out["htod_bytes"]


def upload_under_capture(data_dir: str, sql: str, want) -> dict:
    """Producer threads upload q1's lineitem columns on their own streams,
    in 2^20-row chunks, while this thread runs q1 cold from a cleared
    governor, which captures its programs, and then captures 16 programs
    of 200 kernels each: every upload must equal its host source, every
    program its eager result, q1 the port on the CPU, and some upload
    must have been queued while a capture was open."""
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.columnar import ColumnBatch, side_stream_uploads
    from ballista_tpu_torch.compile import compile_stats, governed, governor
    from ballista_tpu_torch.io import native
    from ballista_tpu_torch.testing.tpch_schema import (TPCH_SCHEMAS,
                                                        register_tpch)

    sch = TPCH_SCHEMAS["lineitem"]
    cols = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_shipdate"]
    n, arrays, _, _ = native.scan_file(
        os.path.join(data_dir, "lineitem", "partition0.tbl"), sch, cols)
    sub = sch.project(cols)
    chunk = 1 << 20
    stop = threading.Event()
    uploads, spans, errors = [], [], []

    def producer(k: int):
        try:
            start = k * chunk
            while not stop.is_set():
                lo = start % n
                part = {c: a[lo:lo + chunk] for c, a in arrays.items()}
                t0 = time.perf_counter()
                with side_stream_uploads():
                    b = ColumnBatch.from_numpy(sub, part, capacity=chunk,
                                               device="cuda")
                spans.append((t0, time.perf_counter()))
                uploads.append((lo, b))
                while len(uploads) > 48:  # bound the card memory held
                    uploads.pop(0)
                start += 3 * chunk
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)

    # the governor's captures, as the card's graph API sees them
    windows = []
    real_begin = torch.cuda.CUDAGraph.capture_begin
    real_end = torch.cuda.CUDAGraph.capture_end

    def begin(graph, *a, **kw):
        windows.append([time.perf_counter(), None])
        return real_begin(graph, *a, **kw)

    def end(graph, *a, **kw):
        out = real_end(graph, *a, **kw)
        windows[-1][1] = time.perf_counter()
        return out

    def many_kernels(x):
        for _ in range(200):
            x = x * 3 + 1
        return x.cumsum(0)

    governor().clear()
    ctx = BallistaContext.standalone()
    register_tpch(ctx, data_dir, tables=["lineitem"])
    threads = [threading.Thread(target=producer, args=(k,)) for k in range(3)]
    st0 = compile_stats()["graph_captures"]
    torch.cuda.CUDAGraph.capture_begin = begin
    torch.cuda.CUDAGraph.capture_end = end
    for t in threads:
        t.start()
    try:
        got = ctx.sql(sql).to_pydict()
        q1_captures = compile_stats()["graph_captures"] - st0
        x = torch.arange(1 << 20, device="cuda")
        want_x = many_kernels(x)
        for i in range(16):
            fn = governed(("sort.run", "chip_smoke.upload_capture", i),
                          lambda: many_kernels)
            for _ in range(3):  # capture, then two replays
                if not torch.equal(fn(x), want_x):
                    raise AssertionError("a program captured while "
                                         "producers uploaded is wrong")
        torch.cuda.synchronize()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.CUDAGraph.capture_begin = real_begin
        torch.cuda.CUDAGraph.capture_end = real_end
    if any(t.is_alive() for t in threads):
        raise AssertionError("an upload producer did not stop")
    if errors:
        raise errors[0]
    assert_equal_results("q1 under concurrent uploads", got, want)
    if not q1_captures:
        raise AssertionError("q1 captured no program")
    during = sum(any(a < w1 and w0 < b for w0, w1 in windows)
                 for a, b in spans)
    if not during:
        raise AssertionError("no upload was queued while a capture was open")
    for lo, b in uploads:
        b.wait_upload()
        rows = min(chunk, n - lo)
        for c in cols:
            if not np.array_equal(b.column(c).values[:rows].cpu().numpy(),
                                  arrays[c][lo:lo + rows]):
                raise AssertionError(f"upload of {c} rows {lo}.. differs "
                                     f"from its source")
    log(f"# upload under capture: {len(windows)} captures ({q1_captures} "
        f"of q1's cold collect) while 3 producers queued {len(spans)} "
        f"uploads of {chunk} rows, {during} of them while a capture was "
        f"open; every program right, the last {len(uploads)} uploads equal "
        f"their sources, q1 == port on cpu")
    return {"captures": len(windows), "q1_captures": q1_captures,
            "uploads": len(spans), "uploads_during_capture": during}


def phase_ingest(data_dir: str, want: dict):
    """The ingest and warm path at SF1: q1, q3, q5 and q16, each cold and
    then warm, from a cleared table cache and governor, under each of
    ``INGEST_CONFIGS``; q1 at a 1 MB budget; the upload-under-capture
    check. Every collect equals the port on the CPU, every kernel call
    the plain version, and no query writes into a pinned tensor."""
    import gc

    from ballista_tpu_torch.cache import cache_counters, reset_cache_stats
    from ballista_tpu_torch.cache import residency
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.compile import compile_stats, governor
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    sqls = {q: open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
            for q in FUSION_QUERIES}
    rows = []

    def run(df, q, config, run_name, snap):
        reset_cache_stats()
        st0 = compile_stats()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with KernelCallLog() as spy:
            t0 = time.perf_counter()
            out = df.to_pydict()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        st1 = compile_stats()
        cc = cache_counters()
        parse, h2d = scan_phase_seconds(df.physical_plan())
        row = {"query": q, "config": config, "run": run_name, "wall_s": wall,
               "hits": cc["table_cache_hits"],
               "fills": cc["table_cache_fills"],
               "evictions": cc["table_cache_evictions"],
               "resident_mb": cc["table_cache_resident_bytes"] / 2 ** 20,
               "parse_s": parse, "h2d_s": h2d,
               "donated_buffers": cc["donated_buffers"],
               "donated_mb": cc["donated_bytes"] / 2 ** 20,
               "captures": st1["graph_captures"] - st0["graph_captures"],
               "replays": st1["graph_replays"] - st0["graph_replays"],
               "peak_mb": (torch.cuda.max_memory_allocated() - base) / 2 ** 20,
               "partitions": scan_partitions(df.physical_plan())}
        assert_equal_results(f"{q} {config} {run_name} cuda vs cpu", out,
                             want[q])
        check_observed(spy.calls, f"{q} {config} {run_name}")
        row["observed_kernel_calls"] = len(spy.calls)
        row["pinned_tensors"] = snap.check(f"{q} {config} {run_name}")
        log(f"# ingest {config} {q} {run_name}: {wall:.4f} s; cache hits "
            f"{row['hits']}/{row['partitions']} partitions, fills "
            f"{row['fills']}, evictions {row['evictions']}, resident "
            f"{row['resident_mb']:.1f} MB; parse {parse:.4f} s, h2d "
            f"{h2d:.4f} s (host thread-seconds); donated "
            f"{row['donated_buffers']} ({row['donated_mb']:.1f} MB); "
            f"captures {row['captures']}, replays {row['replays']}; peak "
            f"{row['peak_mb']:.1f} MB over {base / 2 ** 20:.1f} MB; == port "
            f"on cpu")
        rows.append(row)
        return row

    try:
        for config, env in INGEST_CONFIGS:
            set_ingest_env(env)
            residency.reset()
            governor().clear()
            snap = PinnedSnapshot()
            ctx = BallistaContext.standalone()
            register_tpch(ctx, data_dir)
            for q in FUSION_QUERIES:
                df = ctx.sql(sqls[q])
                run(df, q, config, "cold", snap)
                warm = run(df, q, config, "warm", snap)
                if config == "8192 MB budget":
                    if (warm["fills"] or warm["parse_s"]
                            or warm["hits"] != warm["partitions"]):
                        raise AssertionError(
                            f"{q} at 8192 MB: the warm collect must serve "
                            f"every scan partition from the cache: {warm}")
                    if warm["captures"] or not warm["replays"]:
                        raise AssertionError(
                            f"{q} at 8192 MB: the warm collect must replay "
                            f"and capture none: {warm}")
                    (warm["profiled_wall_s"], warm["busy_ms"],
                     warm["h2d_copies"], warm["h2d_bytes"]) = profile_h2d(
                        df, q)
                    warm["busy_share"] = warm["busy_ms"] / (
                        1e3 * warm["profiled_wall_s"])
                    # table data is hundreds of MB; what a warm collect
                    # may still upload is constants of a few KB
                    if warm["h2d_bytes"] > (1 << 20):
                        raise AssertionError(
                            f"{q} at 8192 MB: the warm collect copied "
                            f"{warm['h2d_bytes']} bytes to the card")
                    log(f"# ingest 8192 MB {q} warm, profiled: "
                        f"{warm['profiled_wall_s'] * 1e3:.1f} ms, card busy "
                        f"{warm['busy_ms']:.1f} ms "
                        f"({100 * warm['busy_share']:.1f}%), "
                        f"{warm['h2d_copies']} host-to-device copies of "
                        f"{warm['h2d_bytes']} bytes in all")
                elif config == "cache off" and (warm["hits"] or warm["fills"]):
                    raise AssertionError(f"{q} cache off: {warm}")
                del df
            del ctx
            if config == "8192 MB budget":
                # a second context over the same files: every scan is a
                # hit, and its sources adopt the cached batches'
                # dictionaries, so the first context's graphs replay
                other = BallistaContext.standalone()
                register_tpch(other, data_dir)
                for q in FUSION_QUERIES:
                    r = run(other.sql(sqls[q]), q, config, "second context",
                            snap)
                    if (r["fills"] or r["hits"] != r["partitions"]
                            or r["captures"] or not r["replays"]):
                        raise AssertionError(
                            f"{q}: a second context's collect must be "
                            f"served from the cache and replay only: {r}")
                del other
        # q1 at a 1 MB budget: no table fits, every collect re-ingests
        set_ingest_env({"BALLISTA_TABLE_CACHE_BUDGET_MB": "1"})
        residency.reset()
        snap = PinnedSnapshot()
        ctx = BallistaContext.standalone()
        register_tpch(ctx, data_dir)
        df = ctx.sql(sqls["q1"])
        for run_name in ("cold", "warm"):
            r = run(df, "q1", "1 MB budget", run_name, snap)
            if r["hits"] or not r["parse_s"]:
                raise AssertionError(f"q1 at 1 MB must re-ingest: {r}")
        del df, ctx
        set_ingest_env({})
        residency.reset()
        capture = upload_under_capture(data_dir, sqls["q1"], want["q1"])
    finally:
        set_ingest_env({})
    residency.reset()
    governor().clear()
    log(f"# ingest host: {os.cpu_count()} CPUs")
    return rows, capture


# -- phase 8 ----------------------------------------------------------------

# the hash-shuffled aggregate of phase 8: 10,000 suppliers at SF1
AGG8_SQL = ("select l_suppkey, sum(l_quantity) as sum_qty, count(*) as n "
            "from lineitem group by l_suppkey order by l_suppkey")
ADAPTIVE_QUERIES = ("q3", "q5", "agg8")


def numpy_agg8(data_dir: str):
    li = scan_table(data_dir, "lineitem", ["l_suppkey", "l_quantity"])
    keys, sums = group_sums(li["l_suppkey"],
                            li["l_quantity"].astype(np.int64))
    _, counts = group_sums(li["l_suppkey"],
                           np.ones(len(li["l_suppkey"]), np.int64))
    return {"l_suppkey": keys, "sum_qty": sums.astype(np.float64) / 100,
            "n": counts}


def adaptive_notes(plan) -> list:
    """The rules that fired in an adapted plan: each adaptive reader's
    note (once per reader pair) and each demoted join's."""
    from ballista_tpu_torch.adaptive.standalone import AdaptiveShuffleReadExec
    from ballista_tpu_torch.physical.join import JoinExec

    notes = [f"join: {j.adaptive_note}" for j in find_nodes(plan, JoinExec)
             if j.adaptive_note]
    notes += [f"read: {r.note} ({r.repart.num_partitions} buckets -> "
              f"{len(r.layout)} tasks)"
              for r in find_nodes(plan, AdaptiveShuffleReadExec)]
    return notes


def check_adapted_shape(plan, label: str) -> None:
    """Every adaptive reader covers each (bucket, source fragment) of its
    repartition exactly once, and the two readers of a co-partitioned
    join group the same buckets into the same tasks."""
    from ballista_tpu_torch.adaptive.standalone import AdaptiveShuffleReadExec
    from ballista_tpu_torch.physical.join import JoinExec

    for r in find_nodes(plan, AdaptiveShuffleReadExec):
        # the fragments of the latest collect (num_fragments() would
        # materialize the released repartition again)
        n = r.repart.num_partitions
        frags = int(r.repart.metrics().values()["input_batches"])
        seen = np.zeros((n, frags), np.int64)
        for ranges in r.layout:
            for olo, ohi, flo, fhi in ranges:
                seen[olo:ohi, flo:(fhi or frags)] += 1
        if not (seen == 1).all():
            raise AssertionError(f"{label}: a reader's layout does not "
                                 f"cover every bucket once: {r.layout}")
    for j in find_nodes(plan, JoinExec):
        if j.partitioned and isinstance(j.build, AdaptiveShuffleReadExec):
            tasks = [[(a, b) for a, b, _, _ in t] for t in j.build.layout]
            if tasks != [[(a, b) for a, b, _, _ in t]
                         for t in j.probe.layout]:
                raise AssertionError(f"{label}: the join's readers group "
                                     f"different buckets")


def repartition_facts(plan) -> dict:
    """Summed over the plan's repartitions: host seconds materializing
    (the child's execution included), count fetches and input batches
    (one fetch per batch before this change)."""
    from ballista_tpu_torch.physical.operators import RepartitionExec

    out = {"repartitions": 0, "materialize_s": 0.0, "count_fetches": 0,
           "input_batches": 0}
    for node in find_nodes(plan, RepartitionExec):
        vals = node.metrics().values()
        out["repartitions"] += 1
        out["materialize_s"] += vals.get("elapsed_materialize", 0.0)
        out["count_fetches"] += int(vals.get("count_fetches", 0))
        out["input_batches"] += int(vals.get("input_batches", 0))
    return out


SERIAL_ENV = {"BALLISTA_PREFETCH_BATCHES": "0", "BALLISTA_INGEST_THREADS": "1"}
AB_PAIRS = 7


def pipelined_vs_serial(df, q: str, want, budget_env: dict) -> dict:
    """Warm collects of ``df`` (the pass on, every scan a cache hit) with
    the concurrent child partitions and with the serial loop
    (``SERIAL_ENV``), ``AB_PAIRS`` pairs in turns, the order alternating:
    (median, lower quartile, upper quartile) seconds of each."""
    walls = {"pipelined": [], "serial": []}
    for i in range(AB_PAIRS):
        order = ("pipelined", "serial") if i % 2 == 0 else ("serial",
                                                             "pipelined")
        for mode in order:
            set_ingest_env({**budget_env,
                            **(SERIAL_ENV if mode == "serial" else {})})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = df.to_pydict()
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            assert_equal_results(f"{q} warm {mode} cuda vs cpu", out, want)
    set_ingest_env(budget_env)
    out = {mode: [float(np.median(w)), float(np.percentile(w, 25)),
                  float(np.percentile(w, 75))] for mode, w in walls.items()}
    log(f"# adaptive=on {q} warm, {AB_PAIRS} pairs in turns: pipelined "
        f"median {out['pipelined'][0]:.4f} s (quartiles "
        f"{out['pipelined'][1]:.4f}-{out['pipelined'][2]:.4f}), serial loop "
        f"median {out['serial'][0]:.4f} s (quartiles "
        f"{out['serial'][1]:.4f}-{out['serial'][2]:.4f})")
    return out


def phase_adaptive(data_dir: str, want: dict):
    """q3, q5 and a hash-shuffled aggregate (``agg.partitions=8``) at SF1
    with the adaptive pass on (the default) and off, each cold and warm
    from a cleared table cache and governor at an 8192 MB budget: results
    equal the port on the CPU and numpy exactly; the warm collect replays
    and captures nothing; every observed kernel call bit-equal to the
    plain version; q5's launches counted (the kernel's path through the
    adapted join). Prints the adapted plans, the rules that fired, walls,
    repartition host seconds, count fetches, replays and a profiled warm
    collect (card-busy share, device-to-host copies)."""
    import gc

    from ballista_tpu_torch.cache import residency
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.compile import compile_stats, governor
    from ballista_tpu_torch.kernels import dense_sums as ds
    from ballista_tpu_torch.physical.join import JoinExec
    from ballista_tpu_torch.physical.operators import RepartitionExec
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    sqls = {q: open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
            for q in ("q3", "q5")}
    sqls["agg8"] = AGG8_SQL
    agg8 = {"agg.partitions": "8"}
    cpu = BallistaContext.standalone(device="cpu", **agg8)
    register_tpch(cpu, data_dir, tables=["lineitem"])
    want = {"q3": want["q3"], "q5": want["q5"],
            "agg8": cpu.sql(AGG8_SQL).to_pydict()}
    refs = {"q3": numpy_q3(data_dir), "q5": numpy_q5(data_dir),
            "agg8": numpy_agg8(data_dir)}
    for q in ADAPTIVE_QUERIES:
        assert_equal_results(f"{q} cpu vs numpy", want[q], refs[q])
    rows, q5_launches = [], None
    set_ingest_env({"BALLISTA_TABLE_CACHE_BUDGET_MB": "8192"})
    try:
        for setting in ("on", "off"):
            for q in ADAPTIVE_QUERIES:
                residency.reset()
                governor().clear()
                gc.collect()
                settings = {"adaptive.enabled": setting,
                            **(agg8 if q == "agg8" else {})}
                ctx = BallistaContext.standalone(**settings)
                register_tpch(ctx, data_dir)
                df = ctx.sql(sqls[q])
                row = {"query": q, "adaptive": setting}
                for run in ("cold", "warm"):
                    with KernelCallLog() as spy:
                        st0 = compile_stats()
                        torch.cuda.synchronize()
                        ds.launch_count = 0
                        t0 = time.perf_counter()
                        out = df.to_pydict()
                        torch.cuda.synchronize()
                        row[f"{run}_s"] = time.perf_counter() - t0
                        row[f"{run}_kernel_launches"] = ds.launch_count
                        st1 = compile_stats()
                    check_observed(spy.calls, f"{q} adaptive={setting} {run}")
                    assert_equal_results(
                        f"{q} adaptive={setting} {run} cuda vs cpu", out,
                        want[q])
                    assert_equal_results(
                        f"{q} adaptive={setting} {run} cuda vs numpy", out,
                        refs[q])
                    row[f"{run}_captures"] = (st1["graph_captures"]
                                              - st0["graph_captures"])
                    row[f"{run}_replays"] = (st1["graph_replays"]
                                             - st0["graph_replays"])
                    for k, v in repartition_facts(
                            df.physical_plan()).items():
                        row[f"{run}_{k}"] = v
                if row["warm_captures"] or not row["warm_replays"]:
                    raise AssertionError(
                        f"{q} adaptive={setting}: the warm collect captured "
                        f"{row['warm_captures']} and replayed "
                        f"{row['warm_replays']}; it must replay only")
                if q == "q5":
                    if not row["cold_kernel_launches"]:
                        raise AssertionError(
                            f"q5 adaptive={setting}: no dense_grouped_sums "
                            f"launch counted")
                    if setting == "on":
                        q5_launches = row["cold_kernel_launches"]
                plan = df.physical_plan()
                row["rules"] = adaptive_notes(plan)
                if setting == "on":
                    check_adapted_shape(plan, q)
                    for line in plan.pretty().splitlines():
                        log(f"#   {line}")
                else:
                    if row["rules"]:
                        raise AssertionError(f"{q}: rules fired with the "
                                             f"pass off: {row['rules']}")
                    if q != "agg8" and not [
                            j for j in find_nodes(plan, JoinExec)
                            if j.partitioned
                            and isinstance(j.build, RepartitionExec)
                            and isinstance(j.probe, RepartitionExec)]:
                        raise AssertionError(f"{q} with the pass off holds "
                                             f"no co-partitioned JoinExec")
                (row["profiled_wall_s"], row["busy_ms"], _, _,
                 row["dtoh_copies"]) = profile_warm(df)
                if setting == "on" and q != "agg8":
                    row["warm_pipelined_vs_serial_s"] = pipelined_vs_serial(
                        df, q, want[q], {"BALLISTA_TABLE_CACHE_BUDGET_MB":
                                         "8192"})
                row["busy_share"] = row["busy_ms"] / (
                    1e3 * row["profiled_wall_s"])
                rows.append(row)
                log(f"# adaptive={setting} {q}: rules {row['rules']}; cold "
                    f"{row['cold_s']:.4f} s, warm {row['warm_s']:.4f} s "
                    f"({row['warm_replays']} replays, "
                    f"{row['warm_captures']} captures); repartitions "
                    f"{row['warm_repartitions']}: warm "
                    f"{row['warm_materialize_s'] * 1e3:.1f} ms host, "
                    f"{row['warm_count_fetches']} count fetches for "
                    f"{row['warm_input_batches']} batches; kernel launches "
                    f"cold/warm {row['cold_kernel_launches']}/"
                    f"{row['warm_kernel_launches']}; profiled warm "
                    f"{row['profiled_wall_s'] * 1e3:.1f} ms, card busy "
                    f"{row['busy_ms']:.1f} ms "
                    f"({100 * row['busy_share']:.1f}%), "
                    f"{row['dtoh_copies']} device-to-host copies; == port "
                    f"on cpu == numpy")
                del df, ctx
    finally:
        set_ingest_env({})
    residency.reset()
    governor().clear()
    return rows, q5_launches


# -- phase 9 ----------------------------------------------------------------

STREAM_CHUNK = 128 << 20  # lineitem at SF1 is about 760 MB of text


def phase_streaming(data_dir: str, want_q1):
    """q1 at SF1 with lineitem parsed whole and streamed in byte ranges
    of ``STREAM_CHUNK`` (``io.text.STREAM_CHUNK_BYTES`` set, then
    restored), each cold and warm from a cleared table cache and
    governor: both equal the port on the CPU; the streamed file is never
    cached (its warm collect parses again); the kernel's launches are
    counted and every observed call is bit-equal to the plain version."""
    from ballista_tpu_torch.cache import cache_counters, reset_cache_stats
    from ballista_tpu_torch.cache import residency
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.compile import governor
    from ballista_tpu_torch.io import text
    from ballista_tpu_torch.kernels import dense_sums as ds
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    path = os.path.join(data_dir, "lineitem", "partition0.tbl")
    size = os.path.getsize(path)
    if size <= STREAM_CHUNK:
        raise AssertionError(f"lineitem ({size} bytes) would not stream")
    sql = open(os.path.join(QUERY_DIR, "q1.sql")).read()
    saved = text.STREAM_CHUNK_BYTES
    rows, launches = [], None
    try:
        for mode, chunk in (("whole file", saved), ("streamed", STREAM_CHUNK)):
            text.STREAM_CHUNK_BYTES = chunk
            residency.reset()
            governor().clear()
            ctx = BallistaContext.standalone()
            register_tpch(ctx, data_dir, tables=["lineitem"])
            df = ctx.sql(sql)
            for run in ("cold", "warm"):
                reset_cache_stats()
                with KernelCallLog() as spy:
                    torch.cuda.synchronize()
                    ds.launch_count = 0
                    t0 = time.perf_counter()
                    out = df.to_pydict()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    n_launch = ds.launch_count
                check_observed(spy.calls, f"q1 {mode} {run}")
                assert_equal_results(f"q1 {mode} {run} cuda vs cpu", out,
                                     want_q1)
                if n_launch < 2:
                    raise AssertionError(f"q1 {mode} {run}: {n_launch} "
                                         f"dense_grouped_sums launches")
                cc = cache_counters()
                parse, h2d = scan_phase_seconds(df.physical_plan())
                row = {"mode": mode, "run": run, "wall_s": wall,
                       "parse_s": parse, "h2d_s": h2d,
                       "chunks": -(-size // chunk) if chunk < size else 1,
                       "hits": cc["table_cache_hits"],
                       "fills": cc["table_cache_fills"],
                       "kernel_launches": n_launch,
                       "observed_kernel_calls": len(spy.calls)}
                if mode == "streamed":
                    if row["hits"] or row["fills"] or not parse:
                        raise AssertionError(f"the streamed lineitem must "
                                             f"bypass the cache: {row}")
                    if run == "cold":
                        launches = n_launch
                rows.append(row)
                log(f"# streaming {mode} q1 {run}: {wall:.4f} s, "
                    f"{row['chunks']} chunks of {chunk} bytes over "
                    f"{size} bytes; parse {parse:.4f} s, h2d {h2d:.4f} s "
                    f"(host thread-seconds); cache hits {row['hits']}, "
                    f"fills {row['fills']}; kernel launches {n_launch}; "
                    f"== port on cpu")
            del df, ctx
    finally:
        text.STREAM_CHUNK_BYTES = saved
    residency.reset()
    governor().clear()
    return rows, launches


# -- phase 10 ---------------------------------------------------------------

FLOAT_QUERIES = ("q8", "q14", "q17")  # the 22 whose results hold a Float64


def phase_float_sf1(data_dir: str) -> dict:
    """The SF0.05 set's queries with a Float64 result column (computed in
    float32 on the card, its sums by atomics in no fixed order) at SF1,
    on the card and through the port on the CPU: the largest relative
    error of each float column, which must stay within rtol 1e-6; every
    other column exactly."""
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    gpu = BallistaContext.standalone()
    cpu = BallistaContext.standalone(device="cpu")
    register_tpch(gpu, data_dir)
    register_tpch(cpu, data_dir)
    errs = {}
    for q in FLOAT_QUERIES:
        df = gpu.sql(open(os.path.join(QUERY_DIR, f"{q}.sql")).read())
        floats = [f.name for f in df.schema().fields
                  if f.dtype.kind in ("float32", "float64")]
        if not floats:
            raise AssertionError(f"{q} holds no float column")
        got = df.to_pydict()
        want = cpu.sql(open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
                       ).to_pydict()
        if list(got) != list(want):
            raise AssertionError(f"{q}: columns {list(got)} != {list(want)}")
        for c in want:
            g, w = np.asarray(got[c]), np.asarray(want[c])
            if g.shape != w.shape:
                raise AssertionError(f"{q}.{c}: shape {g.shape} != {w.shape}")
            if c in floats:
                rel = float(np.max(np.abs(g - w) / np.maximum(np.abs(w),
                                                              1e-300))
                            if len(w) else 0.0)
                errs[f"{q}.{c}"] = rel
                log(f"# float sf1 {q}.{c}: largest relative error card vs "
                    f"cpu {rel:.3e} over {len(w)} rows")
                if not np.allclose(g, w, rtol=1e-6, atol=0.0):
                    raise AssertionError(f"{q}.{c} at SF1 leaves rtol 1e-6: "
                                         f"{rel:.3e}")
            elif not (list(g) == list(w) if w.dtype.kind == "O"
                      else np.array_equal(g, w)):
                raise AssertionError(f"{q}.{c}: {g[:8]} != {w[:8]}")
    return errs


# -- phase 11 ---------------------------------------------------------------


def phase_hash_ids(data_dir: str) -> None:
    """Partition ids on the card equal the ids on the CPU, bit for bit."""
    from ballista_tpu_torch import expr as ex
    from ballista_tpu_torch.columnar import ColumnBatch, Dictionary
    from ballista_tpu_torch.io import native
    from ballista_tpu_torch.kernels.expr_eval import Evaluator
    from ballista_tpu_torch.kernels.hashing import (hash_partition_ids,
                                                    splitmix64)
    from ballista_tpu_torch.physical.operators import compute_partition_ids
    from ballista_tpu_torch.testing.tpch_schema import TPCH_SCHEMAS

    def same(label, on_card, on_cpu):
        got = on_card.cpu()
        if got.dtype != on_cpu.dtype or not torch.equal(got, on_cpu):
            bad = int((got != on_cpu).sum())
            raise AssertionError(f"{label}: card and CPU differ in {bad} "
                                 f"of {on_cpu.numel()} ids")

    rng = np.random.default_rng(3)
    full = torch.from_numpy(rng.integers(np.iinfo(np.int64).min,
                                         np.iinfo(np.int64).max, 1 << 20,
                                         endpoint=True))
    same("splitmix64, full int64 range", splitmix64(full.cuda()),
         splitmix64(full))
    sch = TPCH_SCHEMAS["lineitem"]
    cols = ["l_orderkey", "l_shipmode"]
    path = os.path.join(data_dir, "lineitem", "partition0.tbl")
    n, a, dicts, _ = native.scan_file(path, sch, cols)
    sub = sch.project(cols)
    d = Dictionary(dicts["l_shipmode"])
    batches = {dev: ColumnBatch.from_numpy(sub, a, {"l_shipmode": d},
                                           device=dev)
               for dev in ("cuda", "cpu")}
    ev = Evaluator(sub)
    for p in (8, 7):
        same(f"hash_partition_ids, full range, P={p}",
             hash_partition_ids(full.cuda(), p), hash_partition_ids(full, p))
        same(f"hash_partition_ids, l_orderkey, P={p}",
             hash_partition_ids(batches["cuda"].column("l_orderkey").values,
                                p),
             hash_partition_ids(batches["cpu"].column("l_orderkey").values,
                                p))
        for keys in (["l_orderkey"], ["l_shipmode"], cols):
            exprs = [ex.col(k) for k in keys]
            ids = {dev: compute_partition_ids(b, exprs, p, 0, ev)
                   for dev, b in batches.items()}
            same(f"compute_partition_ids {keys}, P={p}", ids["cuda"],
                 ids["cpu"])
            live = ids["cpu"][:n]
            counts = torch.bincount(live.to(torch.int64), minlength=p)
            log(f"# hash ids {keys} P={p}: card == cpu over {n} rows, "
                f"rows per partition {counts.tolist()}")


# -- phase 12 ---------------------------------------------------------------


def assert_close_results(name: str, got, want) -> None:
    """Integer, decimal, date and string columns exactly; float columns
    (Float64 computes in float32 on the device) within rtol 1e-6."""
    if list(got) != list(want):
        raise AssertionError(f"{name}: columns {list(got)} != {list(want)}")
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if g.shape != w.shape:
            raise AssertionError(f"{name}.{c}: shape {g.shape} != {w.shape}")
        if w.dtype.kind == "f":
            ok = np.allclose(g, w, rtol=1e-6, atol=1e-6, equal_nan=True)
        elif w.dtype.kind == "M":
            ok = np.array_equal(g.astype(np.int64), w.astype(np.int64))
        elif w.dtype.kind == "O":
            ok = list(g) == list(w)
        else:
            ok = np.array_equal(g, w)
        if not ok:
            raise AssertionError(f"{name}.{c}: {g[:8]} != {w[:8]}")


def phase_all_queries(data_dir: str):
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    gpu = BallistaContext.standalone()
    cpu = BallistaContext.standalone(device="cpu")
    register_tpch(gpu, data_dir)
    register_tpch(cpu, data_dir)
    secs, results = {}, {}
    for q in QUERIES:
        sql = open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
        t0 = time.perf_counter()
        got = results[q] = gpu.sql(sql).to_pydict()
        torch.cuda.synchronize()
        secs[q] = time.perf_counter() - t0
        assert_close_results(f"{q} sf{SMALL_SCALE:g} cuda vs cpu", got,
                             cpu.sql(sql).to_pydict())
        log(f"# {q} sf{SMALL_SCALE:g}: cuda == port on cpu "
            f"({len(next(iter(got.values())))} rows, {secs[q]:.3f} s "
            f"on the card, cold)")
    return secs, results


def profile_query(data_dir: str, q: str) -> None:
    """One more warm collect of ``q`` under ``torch.profiler``
    (``--profile``): the device time by kernel, its share of the wall
    time, and the operators' host-side metrics. Runs after the launch
    counts were read, so it counts towards nothing."""
    from torch.profiler import ProfilerActivity, profile

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    ctx = BallistaContext.standalone()
    register_tpch(ctx, data_dir)
    df = ctx.sql(open(os.path.join(QUERY_DIR, f"{q}.sql")).read())
    df.to_pydict()  # warm: the plan and the libraries exist
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.to_pydict()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): the CPU-side aten ops
    # carry their kernels' device time too and would count it twice
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy = sum(ms for _, _, ms in rows)
    log(f"# profile {q} warm: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of wall)")
    for key, count, ms in rows[:15]:
        log(f"#   {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    for line in df.physical_plan().pretty_metrics().splitlines():
        log(f"#   {line}")


# -- phase 13 ---------------------------------------------------------------

PARQUET_VERSION = "v1"  # bump when testing/parquet_convert.py's output changes
STAGED_QUERIES = ("q1", "q3", "q5")


def setup_parquet(data_dir: str) -> str:
    """The TPC-H tables of ``data_dir`` as Parquet in ``<data_dir>_parquet``
    (``<table>/part-0.parquet``, the JAX package converter's layout and
    column types), written by the port's own scan on the CPU and pyarrow;
    reused while its ``.complete`` marker holds this version and the
    ``.tbl`` data's marker."""
    import shutil

    from ballista_tpu_torch.testing.parquet_convert import convert_tpch

    out = f"{data_dir}_parquet"
    marker = os.path.join(out, ".complete")
    with open(os.path.join(data_dir, ".complete")) as f:
        want = f"{PARQUET_VERSION} from {f.read().strip()}"
    have = open(marker).read().strip() if os.path.exists(marker) else None
    if have != want:
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        convert_tpch(data_dir, out)
        with open(marker, "w") as f:
            f.write(want)
        log(f"# set-up: converted {data_dir} to Parquet in "
            f"{time.perf_counter() - t0:.1f}s")
    else:
        log(f"# set-up: reusing {out} ({want})")
    return out


def tree_bytes(path: str, suffix: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files
               if f.endswith(suffix))


def utf8_read_seconds(pq_dir: str) -> dict:
    """Host seconds of the Parquet scan's utf8 path (``to_pylist`` and
    the dictionary search of ``io/parquet.py``) on lineitem's
    ``l_returnflag`` at SF1, one of the two utf8 columns q1 reads."""
    import pyarrow.parquet as pq

    path = os.path.join(pq_dir, "lineitem", "part-0.parquet")
    out = {}
    for col in ("l_returnflag",):
        t0 = time.perf_counter()
        arr = pq.read_table(path, columns=[col]).column(0).combine_chunks()
        t1 = time.perf_counter()
        vals = np.asarray(["" if v is None else v for v in arr.to_pylist()],
                          dtype=object)
        t2 = time.perf_counter()
        uniq = np.unique(vals)
        np.searchsorted(uniq.astype(str), vals.astype(str))
        t3 = time.perf_counter()
        out[col] = {"rows": len(vals), "read_s": t1 - t0,
                    "to_pylist_s": t2 - t1, "encode_s": t3 - t2}
    return out


def phase_parquet(data_dir: str, pq_dir: str, want_cpu_tbl: dict):
    """q1, q3 and q5 at SF1 from Parquet on the card, each cold and warm
    from a cleared table cache and governor at the 8192 MB budget: the
    warm collect must be served from the table cache (every scan a hit,
    no fill, no parse) and replay only; each result equals the same query
    over ``.tbl`` on the card and over the same Parquet on the CPU,
    exactly; every observed kernel call bit-equal to the plain version."""
    import pyarrow as pa

    from ballista_tpu_torch.cache import cache_counters, reset_cache_stats
    from ballista_tpu_torch.cache import residency
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.compile import compile_stats, governor
    from ballista_tpu_torch.io import ipc
    from ballista_tpu_torch.kernels import dense_sums as ds
    from ballista_tpu_torch.testing.parquet_convert import (
        register_tpch_parquet)
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    t_phase = time.perf_counter()
    ipc._arrow()  # the pool check of the port's first pyarrow use
    pool = pa.default_memory_pool().backend_name
    pq_bytes, tbl_bytes = tree_bytes(pq_dir, ".parquet"), tree_bytes(
        data_dir, ".tbl")
    log(f"# parquet: pyarrow {pa.__version__}, memory pool {pool}; "
        f"{pq_bytes:,} bytes of Parquet against {tbl_bytes:,} bytes of .tbl")
    utf8 = utf8_read_seconds(pq_dir)
    log(f"# parquet utf8 path at SF1: {json.dumps(utf8)}")
    set_ingest_env({"BALLISTA_TABLE_CACHE_BUDGET_MB": "8192"})
    gpu = BallistaContext.standalone()
    register_tpch_parquet(gpu, pq_dir)
    tbl = BallistaContext.standalone()
    register_tpch(tbl, data_dir)
    cpu = BallistaContext.standalone(device="cpu")
    register_tpch_parquet(cpu, pq_dir)
    rows = []
    launches = {}
    try:
        for q in STAGED_QUERIES:
            sql = open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
            residency.reset()
            governor().clear()
            df = gpu.sql(sql)
            parts = None
            for run in ("cold", "warm"):
                reset_cache_stats()
                st0 = compile_stats()
                with KernelCallLog() as spy:
                    torch.cuda.synchronize()
                    ds.launch_count = 0
                    t0 = time.perf_counter()
                    out = df.to_pydict()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    n_launch = ds.launch_count
                st1 = compile_stats()
                check_observed(spy.calls, f"parquet {q} {run}")
                cc = cache_counters()
                parse, h2d = scan_phase_seconds(df.physical_plan())
                parts = scan_partitions(df.physical_plan())
                row = {"query": q, "run": run, "wall_s": wall,
                       "parse_s": parse, "h2d_s": h2d,
                       "hits": cc["table_cache_hits"],
                       "fills": cc["table_cache_fills"],
                       "captures": st1["graph_captures"]
                       - st0["graph_captures"],
                       "replays": st1["graph_replays"] - st0["graph_replays"],
                       "kernel_launches": n_launch,
                       "observed_kernel_calls": len(spy.calls)}
                rows.append(row)
                launches[(q, run)] = n_launch
                log(f"# parquet {q} {run}: {wall:.4f} s, elapsed_parse "
                    f"{parse:.4f} s, elapsed_h2d {h2d:.4f} s, table cache "
                    f"{row['hits']} hits / {row['fills']} fills of {parts} "
                    f"scan partitions, {row['captures']} captures, "
                    f"{row['replays']} replays, dense_grouped_sums "
                    f"launches {n_launch}")
                if q in ("q1", "q5") and n_launch < 2:
                    raise AssertionError(f"parquet {q} {run}: {n_launch} "
                                         f"kernel launches, expected >= 2")
                if run == "cold":
                    cold = out
                elif (row["hits"] != parts or row["fills"] or parse
                        or row["captures"] or not row["replays"]):
                    raise AssertionError(
                        f"parquet {q} warm: {row['hits']} hits, "
                        f"{row['fills']} fills of {parts} partitions, "
                        f"parse {parse} s, {row['captures']} captures: the "
                        f"warm collect must be served from the table cache "
                        f"and replay only")
            assert_equal_results(f"parquet {q} warm vs cold", out, cold)
            assert_equal_results(f"parquet {q} vs .tbl on the card", cold,
                                 tbl.sql(sql).to_pydict())
            assert_equal_results(f"parquet {q} vs .tbl on the cpu", cold,
                                 want_cpu_tbl[q])
            assert_equal_results(f"parquet {q} cuda vs cpu", cold,
                                 cpu.sql(sql).to_pydict())
            log(f"# parquet {q}: cuda == .tbl on the card == parquet on the "
                f"cpu ({len(next(iter(cold.values())))} rows)")
    finally:
        set_ingest_env({})
        residency.reset()
        governor().clear()
    secs = time.perf_counter() - t_phase
    log(f"# phase 13 (parquet) took {secs:.1f} s")
    return {"rows": rows, "utf8": utf8, "pool": pool,
            "parquet_bytes": pq_bytes, "tbl_bytes": tbl_bytes,
            "seconds": secs}, launches


# -- phase 14 ---------------------------------------------------------------


def plan_leaves(plan) -> list:
    if not plan.children():
        return [plan]
    return [leaf for c in plan.children() for leaf in plan_leaves(c)]


def check_plans_on_card(plans, label: str) -> int:
    """Every leaf of every task plan an executor deserialized (scans,
    shuffle readers, empty relations) must live on the card."""
    n = 0
    for plan in plans:
        for leaf in plan_leaves(plan):
            dev = getattr(leaf, "device", None)
            if dev is None and hasattr(leaf, "source"):
                dev = getattr(leaf.source, "device", None)
            if dev is None or torch.device(dev).type != "cuda":
                raise AssertionError(
                    f"{label}: a task plan's leaf {type(leaf).__name__} "
                    f"is on {dev}, not the card")
            n += 1
    return n


class TaskPlanLog:
    """Records every task plan the executors of this process run (as
    deserialized and fused) while it is entered."""

    def __enter__(self):
        from ballista_tpu_torch.distributed.executor import Executor

        self.plans = []
        self._real = real = Executor.execute_partition
        plans = self.plans

        def recording(executor, pid, plan, shuffle=None):
            plans.append(plan)
            return real(executor, pid, plan, shuffle)

        Executor.execute_partition = recording
        return self

    def __exit__(self, *exc):
        from ballista_tpu_torch.distributed.executor import Executor

        Executor.execute_partition = self._real
        return False


def split_lines(src: str, out_dir: str, parts: int) -> None:
    """``src`` cut at line boundaries into ``parts`` files of about equal
    size in ``out_dir`` (kept while its marker names the source's size
    and mtime)."""
    st = os.stat(src)
    want = f"{os.path.basename(src)} {st.st_size} {st.st_mtime_ns} {parts}"
    marker = os.path.join(out_dir, ".complete")
    if os.path.exists(marker) and open(marker).read().strip() == want:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(src, "rb") as f:
        data = f.read()
    start = 0
    for i in range(parts):
        end = len(data) if i == parts - 1 else \
            data.index(b"\n", (len(data) * (i + 1)) // parts) + 1
        with open(os.path.join(out_dir, f"part-{i}.tbl"), "wb") as f:
            f.write(data[start:end])
        start = end
    with open(marker, "w") as f:
        f.write(want)


CLUSTER_SPLIT = ("lineitem", "orders")
CLUSTER_PARTS = 4


def cluster_context(cluster, data_dir: str, split_dir: Optional[str] = None):
    """A remote context of ``cluster`` over the TPC-H tables of
    ``data_dir``, the tables of ``CLUSTER_SPLIT`` read from ``split_dir``
    when given."""
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.testing.tpch_schema import (TPCH_PKS,
                                                        TPCH_SCHEMAS,
                                                        register_tpch)

    ctx = BallistaContext.remote("localhost", cluster.port)
    register_tpch(ctx, data_dir)
    for t in CLUSTER_SPLIT if split_dir else ():
        ctx.register_tbl(t, os.path.join(split_dir, t), TPCH_SCHEMAS[t],
                         primary_key=TPCH_PKS[t])
    return ctx


def tasks_by_stage(cluster, job: str) -> dict:
    """stage id -> {executor id (8 chars): tasks completed there}."""
    out = {}
    for sid in cluster.state.stage_ids(job):
        per = {}
        for t in cluster.state.get_task_statuses(job, sid):
            key = (t.executor_id or "?")[:8]
            per[key] = per.get(key, 0) + 1
        out[sid] = per
    return out


def plan_shape(cluster, job: str) -> list:
    """Per stage in order: tasks, shuffle fan-out, version and reader
    layouts — what a re-planned run (cost feedback, the re-planner)
    changes."""
    shape = []
    for sid in cluster.state.stage_ids(job):
        row = cluster.state.get_stage_plan(job, sid)
        shape.append((row.num_partitions,
                      row.shuffle_spec[1] if row.shuffle_spec else 0,
                      row.version, sorted((row.reader_layouts or {}).items())))
    return shape


def replanner_notes(cluster, job: str) -> list:
    """The replanner's decisions of a job: the stages it rewrote, their
    versions, shuffle specs and reader layouts."""
    notes = []
    for sid in cluster.state.stage_ids(job):
        row = cluster.state.get_stage_plan(job, sid)
        if row.version:
            notes.append({"stage": sid, "version": row.version,
                          "shuffle_spec": row.shuffle_spec is not None,
                          "layouts": {d: len(lay) for d, lay in
                                      (row.reader_layouts or {}).items()}})
    return notes


def shuffle_bytes(ctx) -> tuple:
    """(bytes written by non-final stages' tasks, bytes their readers
    read) of the context's last job, from the scheduler's per-stage
    metrics."""
    qm = ctx.last_query_metrics()
    if qm is None:
        raise AssertionError("the cluster reported no stage metrics")
    last = max(qm.stage_ids())
    written = read = 0
    for op in qm.operators():
        m = op["metrics"]
        if op["operator"] == "ShuffleWrite" or (
                op["operator"] == "PartitionWrite" and op["stage_id"] != last):
            written += int(m.get("bytes_written", 0))
        read += int(m.get("bytes_read", 0))
    return written, read


def check_executors(cluster) -> None:
    """The executors run on the card and serve shuffle files through the
    port's native data-plane server (``start_data_plane`` falls back to
    the Python server when the binary fails)."""
    from ballista_tpu_torch.distributed.dataplane import NativeDataPlane

    servers = {type(e._data_plane).__name__ for e in cluster.executors}
    if servers != {NativeDataPlane.__name__}:
        raise AssertionError(f"the executors' data planes are {servers}")
    devices = {str(e.config.device) for e in cluster.executors}
    if devices != {"cuda"}:
        raise AssertionError(f"the executors run on {devices}")


def cluster_once(cluster, ctx, sql: str, label: str):
    """One cluster collect of ``sql``: (result, wall s, kernel launches,
    graph captures, observed kernel calls, task plans)."""
    from ballista_tpu_torch.compile import compile_stats, governor
    from ballista_tpu_torch.kernels import dense_sums as ds

    st0 = compile_stats()
    built0 = {(r["namespace"], r["signature"]): r["compiles"]
              for r in governor().entry_rows()}
    with KernelCallLog() as spy, TaskPlanLog() as plans:
        torch.cuda.synchronize()
        ds.launch_count = 0
        t0 = time.perf_counter()
        out = ctx.sql(sql).to_pydict()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = ds.launch_count
    st1 = compile_stats()
    check_observed(spy.calls, label)
    grew = [f"{r['namespace']} {r['signature'][:120]}"
            for r in governor().entry_rows()
            if r["compiles"] > built0.get((r["namespace"], r["signature"]),
                                          0)]
    if st1["graph_captures"] > st0["graph_captures"] and grew:
        log(f"# {label}: programs built in entries {grew[:12]}")
    return (out, wall, n_launch,
            st1["graph_captures"] - st0["graph_captures"], len(spy.calls),
            plans.plans)


def phase_cluster_binary(small_dir: str, want_q1) -> dict:
    """``python -m ballista_tpu_torch.distributed.executor_main --local``
    on the card: its embedded scheduler answers q1 at SF0.05, and SIGTERM
    ends it through the drain path with exit code 0."""
    import re
    import signal

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.distributed.executor_main",
         "--local", "--metrics-port", "-1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port = None
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"embedded scheduler on localhost:(\d+)", line)
            if m:
                port = int(m.group(1))
        if port is None:
            raise AssertionError("the executor binary printed no scheduler "
                                 "port:\n" + "".join(lines))
        ctx = BallistaContext.remote("localhost", port)
        register_tpch(ctx, small_dir, tables=["lineitem"])
        q1 = open(os.path.join(QUERY_DIR, "q1.sql")).read()
        t1 = time.perf_counter()
        got = ctx.sql(q1).to_pydict()
        q1_s = time.perf_counter() - t1
        assert_close_results("binary q1 vs standalone", got, want_q1)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(lines)
    if proc.returncode != 0 or "(graceful drain)" not in text:
        raise AssertionError(f"the executor binary did not drain on SIGTERM "
                             f"(exit {proc.returncode}):\n{text[-3000:]}")
    device_line = next((ln for ln in text.splitlines()
                        if "device=" in ln), "")
    if "device=cuda" not in device_line:
        raise AssertionError(f"the executor binary is not on the card: "
                             f"{device_line!r}")
    secs = time.perf_counter() - t0
    log(f"# binary: executor_main --local answered q1 at sf{SMALL_SCALE:g} "
        f"in {q1_s:.4f} s (== standalone) and drained on SIGTERM (exit 0); "
        f"{secs:.1f} s in all")
    return {"q1_s": q1_s, "seconds": secs}


def phase_cluster(data_dir: str, small_dir: str, small_want: dict):
    """The cluster path on the card: a ``LocalCluster(num_executors=2,
    concurrent_tasks=2)`` in this process (executors on "cuda", the
    scheduler on the CPU), queried through ``BallistaContext.remote``.
    q1, q3 and q5 at SF1 (lineitem and orders split into 4 files each)
    twice; q5 with every read through the data-plane socket; one
    profiled cluster q5; all 22 queries at SF0.05; then the executor
    binary."""
    from ballista_tpu_torch.cache import residency
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.compile import governor
    from ballista_tpu_torch.distributed.executor import LocalCluster
    from ballista_tpu_torch.physical.shuffle import ShuffleReaderExec
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    t_phase = time.perf_counter()
    split_dir = os.path.join("bench_data", f"sf{SCALE:g}_split")
    t0 = time.perf_counter()
    for t in CLUSTER_SPLIT:
        split_lines(os.path.join(data_dir, t, "partition0.tbl"),
                    os.path.join(split_dir, t), CLUSTER_PARTS)
    log(f"# cluster set-up: {', '.join(CLUSTER_SPLIT)} split into "
        f"{CLUSTER_PARTS} files each in {time.perf_counter() - t0:.1f} s")
    set_ingest_env({"BALLISTA_TABLE_CACHE_BUDGET_MB": "8192"})
    residency.reset()
    governor().clear()
    standalone = BallistaContext.standalone()
    register_tpch(standalone, data_dir)
    cluster = LocalCluster(num_executors=2, concurrent_tasks=2)
    rows, launches, unfused = [], {}, {}
    try:
        check_executors(cluster)
        ctx = cluster_context(cluster, data_dir, split_dir)
        for q in STAGED_QUERIES:
            sql = open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
            df = standalone.sql(sql)
            df.to_pydict()  # cold: fills the table cache
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = df.to_pydict()
            torch.cuda.synchronize()
            warm_wall = time.perf_counter() - t0
            row = {"query": q, "standalone_warm_s": warm_wall}
            shape = None
            for label in ("first", "second", "third"):
                done0 = [e.tasks_completed for e in cluster.executors]
                out, wall, n_launch, captures, calls, plans = cluster_once(
                    cluster, ctx, sql, f"cluster {q} {label}")
                done = [e.tasks_completed - d
                        for e, d in zip(cluster.executors, done0)]
                leaves = check_plans_on_card(plans, f"cluster {q} {label}")
                assert_close_results(f"cluster {q} {label} vs standalone",
                                     out, want)
                if min(done) == 0:
                    raise AssertionError(f"cluster {q} {label}: tasks per "
                                         f"executor {done}; both must run")
                if q in ("q1", "q5") and n_launch < 2:
                    raise AssertionError(f"cluster {q} {label}: {n_launch} "
                                         f"kernel launches, expected >= 2")
                job = ctx._last_job_id
                # the scheduler's cost feedback may re-plan a repeated
                # query (other partition counts); a run planned as the
                # one before it must capture nothing
                prev, shape = shape, plan_shape(cluster, job)
                same = prev is not None and prev == shape
                if label == "third" and not same:
                    raise AssertionError(
                        f"cluster {q}: the third run's stages {shape} differ "
                        f"from the second's {prev}")
                if same and captures:
                    raise AssertionError(
                        f"cluster {q} {label}: planned as the run before it "
                        f"but captured {captures} new graphs")
                written, read = shuffle_bytes(ctx)
                row[label] = {
                    "wall_s": wall, "captures": captures,
                    "launches": n_launch, "observed_calls": calls,
                    "tasks_per_executor": done, "task_plans": len(plans),
                    "planned_as_before": same,
                    "plan_shape": [s[:3] for s in shape],
                    "leaves_on_card": leaves,
                    "tasks_by_stage": tasks_by_stage(cluster, job),
                    "replanner": replanner_notes(cluster, job),
                    "shuffle_bytes_written": written,
                    "shuffle_bytes_read": read,
                }
                launches[(q, label)] = n_launch
                if label == "first":
                    unfused[q] = out
                log(f"# cluster {q} {label}: {wall:.4f} s against the "
                    f"standalone warm {warm_wall:.4f} s; stages (tasks, "
                    f"fan-out, version) {row[label]['plan_shape']}"
                    f"{'' if same or prev is None else ' (re-planned)'}; "
                    f"tasks by stage and "
                    f"executor {row[label]['tasks_by_stage']}; replanner "
                    f"{row[label]['replanner']}; shuffle wrote {written:,} B, "
                    f"read {read:,} B; {captures} captures, kernel launches "
                    f"{n_launch} ({calls} observed, bit-equal); {leaves} "
                    f"task-plan leaves on the card; == standalone")
            rows.append(row)

        # q5 with every read through the data-plane socket
        sql5 = open(os.path.join(QUERY_DIR, "q5.sql")).read()
        want5 = standalone.sql(sql5).to_pydict()
        ShuffleReaderExec.FORCE_REMOTE = True
        try:
            out, wall, n_launch, _, _, plans = cluster_once(
                cluster, ctx, sql5, "cluster q5 sockets")
        finally:
            ShuffleReaderExec.FORCE_REMOTE = False
        check_plans_on_card(plans, "cluster q5 sockets")
        assert_close_results("cluster q5 sockets vs standalone", out, want5)
        fetches = sum(int(op["metrics"].get("remote_fetches", 0))
                      for op in ctx.last_query_metrics().operators())
        if fetches == 0:
            raise AssertionError("cluster q5 sockets: no remote fetch")
        sockets = {"wall_s": wall, "remote_fetches": fetches,
                   "launches": n_launch}
        log(f"# cluster q5 through the data-plane sockets: {wall:.4f} s, "
            f"{fetches} remote fetches, kernel launches {n_launch}; "
            f"== standalone")

        # one profiled cluster q5 (everything captured already)
        copies = profile_copies(lambda: ctx.sql(sql5).to_pydict(),
                                "cluster-q5")
        copies["busy_share"] = copies["busy_ms"] / 1e3 / copies["wall_s"]
        log(f"# cluster q5 profiled: {json.dumps(copies)}")

        # all 22 at SF0.05 through the cluster, against phase 12
        small = cluster_context(cluster, small_dir)
        t0 = time.perf_counter()
        with TaskPlanLog() as plans:
            for q in QUERIES:
                sql = open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
                assert_close_results(f"cluster {q} sf{SMALL_SCALE:g} vs "
                                     f"standalone", small.sql(sql).to_pydict(),
                                     small_want[q])
        check_plans_on_card(plans.plans, f"cluster sf{SMALL_SCALE:g}")
        small_s = time.perf_counter() - t0
        log(f"# cluster sf{SMALL_SCALE:g}: all {len(QUERIES)} queries == "
            f"standalone on the card, {small_s:.1f} s in all, "
            f"{len(plans.plans)} tasks")
    finally:
        cluster.shutdown()
        set_ingest_env({})
        residency.reset()
        governor().clear()
    binary = phase_cluster_binary(small_dir, small_want["q1"])
    secs = time.perf_counter() - t_phase
    log(f"# phase 14 (cluster) took {secs:.1f} s")
    return {"rows": rows, "sockets_q5": sockets, "q5_copies": copies,
            "small_s": small_s, "binary": binary, "seconds": secs}, \
        launches, unfused


# -- phase 15 ---------------------------------------------------------------


def analyze_operators(text: str) -> list:
    """(operator line without its metrics and ``[cache: ...]`` mark,
    output_rows) for each line of a ``plan_with_metrics`` text: what an
    EXPLAIN ANALYZE must agree on across devices and paths (times,
    compile counts, memory gauges and cache hits are measurements)."""
    import re

    out = []
    for line in text.splitlines():
        head, _, metrics = line.partition(", metrics=[")
        head = re.sub(r" \[cache: [a-z|]+\]", "", head)
        rows = re.search(r"output_rows=(\d+)", metrics)
        out.append((head, int(rows.group(1)) if rows else None))
    return out


def explain_rows(out) -> dict:
    return dict(zip(list(out["plan_type"]), list(out["plan"])))


def ledger_line(label: str, led: dict, lanes: dict) -> dict:
    """Checks that a standalone ledger's phases and unattributed remainder
    sum to its wall within 1 ms, prints it with its lanes, returns both."""
    total = sum(led["phases"].values()) + led["unattributed_seconds"]
    if abs(total - led["wall_seconds"]) > 1e-3:
        raise AssertionError(f"{label}: ledger phases sum to {total:.6f} s, "
                             f"wall {led['wall_seconds']:.6f} s: {led}")
    row = {"wall_s": led["wall_seconds"], "phases": led["phases"],
           "unattributed_s": led["unattributed_seconds"], "lanes": lanes}
    log(f"# {label}: ledger {json.dumps(row)}")
    return row


def first_collect_child(data_dir: str) -> int:
    """Run in a fresh process (``--first-collect``): q1 at SF1 cold, warm,
    then cold again after clearing the table cache and the governor, each
    with its latency ledger and lanes printed as one ``FIRST_COLLECT``
    JSON line. The first cold collect carries every first-time cost of
    the process; the second only the query's own."""
    from ballista_tpu_torch.cache import residency
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.compile import compile_stats, governor
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    sql = open(os.path.join(QUERY_DIR, "q1.sql")).read()
    ctx = BallistaContext.standalone()
    register_tpch(ctx, data_dir, tables=["lineitem"])
    runs = {}
    for label in ("process_first", "warm", "cold_again"):
        if label == "cold_again":
            residency.reset()
            governor().clear()
        st0 = compile_stats()
        t0 = time.perf_counter()
        ctx.sql(sql).to_pydict()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st1 = compile_stats()
        led = ctx.last_query_ledger()
        # the programs whose first calls took longest (a cleared governor
        # before "cold_again" leaves only that collect's entries)
        firsts = sorted(governor().entry_rows(),
                        key=lambda r: -r["compile_seconds"])[:6]
        lanes = ctx.sql("select job_id, lane, seconds from "
                        "system.query_lanes").to_pydict()
        runs[label] = {
            "ledger": led, "host_wall_s": wall,
            "lanes": {ln: s for j, ln, s in zip(lanes["job_id"],
                                                lanes["lane"],
                                                lanes["seconds"])
                      if j == led["job_id"]},
            "captures": st1["graph_captures"] - st0["graph_captures"],
            "capture_s": st1["capture_seconds"] - st0["capture_seconds"],
            "slowest_first_calls": [
                (r["namespace"], r["compile_seconds"]) for r in firsts],
        }
    print("FIRST_COLLECT " + json.dumps(runs), flush=True)
    return 0


def phase_first_collect(data_dir: str) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, __file__, "--first-collect", data_dir],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"first-collect process failed "
                             f"({proc.returncode}):\n{proc.stderr[-3000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("FIRST_COLLECT "))
    runs = json.loads(line[len("FIRST_COLLECT "):])
    rows = {}
    for label, run in runs.items():
        rows[label] = ledger_line(f"q1 {label.replace('_', ' ')}",
                                  run["ledger"], run["lanes"])
        rows[label].update(host_wall_s=run["host_wall_s"],
                           captures=run["captures"],
                           capture_s=run["capture_s"],
                           slowest_first_calls=run["slowest_first_calls"])
    for label in ("process_first", "cold_again"):
        if rows[label]["phases"]["compile"] <= 0.0:
            raise AssertionError(f"q1 {label}: no compile in its ledger")
        if rows[label]["lanes"]["compile_trace_lower"] <= 0.0:
            raise AssertionError(f"q1 {label}: no compile lane")
    if rows["warm"]["phases"]["compile"] != 0.0 or rows["warm"]["captures"]:
        raise AssertionError(f"warm q1 compiled: {rows['warm']}")
    log(f"# first collect: the process's first q1 {rows['process_first']['wall_s']:.4f} s "
        f"(compile {rows['process_first']['phases']['compile']:.4f} s), "
        f"a later cold q1 {rows['cold_again']['wall_s']:.4f} s (compile "
        f"{rows['cold_again']['phases']['compile']:.4f} s), warm "
        f"{rows['warm']['wall_s']:.4f} s; child process "
        f"{time.perf_counter() - t0:.1f} s")
    return rows


def analyze_on_card(ctx, sql: str, label: str):
    """EXPLAIN ANALYZE of ``sql`` on the card: (rows, kernel launches),
    every observed kernel call held against the plain version."""
    from ballista_tpu_torch.kernels import dense_sums as ds

    with KernelCallLog() as spy:
        torch.cuda.synchronize()
        ds.launch_count = 0
        out = ctx.sql("EXPLAIN ANALYZE " + sql).to_pydict()
        torch.cuda.synchronize()
        n_launch = ds.launch_count
    check_observed(spy.calls, label)
    return explain_rows(out), n_launch


def phase_explain(data_dir: str, launches: dict) -> dict:
    """EXPLAIN and EXPLAIN ANALYZE of q1 and q5 at SF1 on the card against
    the port on the CPU: the plain EXPLAIN text equal, ANALYZE's operators
    and output rows equal, the kernel's launches counted."""
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    gpu = BallistaContext.standalone()
    cpu = BallistaContext.standalone(device="cpu")
    register_tpch(gpu, data_dir)
    register_tpch(cpu, data_dir)
    rows = {}
    for q in ("q1", "q5"):
        sql = open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
        for verbose in ("", "VERBOSE "):
            text = f"EXPLAIN {verbose}" + sql
            got = explain_rows(gpu.sql(text).to_pydict())
            if got != explain_rows(cpu.sql(text).to_pydict()):
                raise AssertionError(f"{text[:40]}...: the card's plan text "
                                     f"differs from the CPU's")
        t0 = time.perf_counter()
        analyzed, n_launch = analyze_on_card(gpu, sql, f"ANALYZE {q}")
        secs = time.perf_counter() - t0
        want = explain_rows(cpu.sql("EXPLAIN ANALYZE " + sql).to_pydict())
        mine = analyze_operators(analyzed["plan_with_metrics"])
        if mine != analyze_operators(want["plan_with_metrics"]):
            raise AssertionError(
                f"ANALYZE {q}: operators or rows differ from the CPU's:\n"
                f"{analyzed['plan_with_metrics']}\n--- cpu:\n"
                f"{want['plan_with_metrics']}")
        if n_launch < 2:
            raise AssertionError(f"ANALYZE {q}: {n_launch} kernel launches")
        launches[f"explain_{q}"] = n_launch
        rows[q] = {"wall_s": secs, "launches": n_launch,
                   "total_elapsed": analyzed["total_elapsed"],
                   "memory": analyzed["memory"], "operators": len(mine)}
        log(f"# EXPLAIN ANALYZE {q} on the card: {secs:.4f} s, "
            f"{len(mine)} operator lines == the CPU's (rows), kernel "
            f"launches {n_launch}; memory {analyzed['memory']}")
        if q == "q1":
            log(analyzed["plan_with_metrics"].rstrip())
    rows["gpu_ctx"] = gpu
    return rows


def phase_cluster_explain(data_dir: str, standalone_q1: str,
                          launches: dict) -> dict:
    """EXPLAIN ANALYZE q1 through ``LocalCluster(2, 2)`` on the card: one
    task; its operators and rows equal the standalone ANALYZE's."""
    from ballista_tpu_torch.distributed.executor import LocalCluster
    from ballista_tpu_torch.kernels import dense_sums as ds

    sql = open(os.path.join(QUERY_DIR, "q1.sql")).read()
    cluster = LocalCluster(num_executors=2, concurrent_tasks=2)
    try:
        check_executors(cluster)
        ctx = cluster_context(cluster, data_dir)
        with KernelCallLog() as spy, TaskPlanLog() as plans:
            torch.cuda.synchronize()
            ds.launch_count = 0
            t0 = time.perf_counter()
            out = explain_rows(ctx.sql("EXPLAIN ANALYZE " + sql).collect())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n_launch = ds.launch_count
        check_observed(spy.calls, "cluster ANALYZE q1")
        kinds = [type(p).__name__ for p in plans.plans]
        if kinds != ["ExplainAnalyzeExec"]:
            raise AssertionError(f"cluster ANALYZE q1 ran the tasks {kinds}, "
                                 f"expected one ExplainAnalyzeExec")
        inner = plans.plans[0].inner
        check_plans_on_card([inner], "cluster ANALYZE q1")
        if analyze_operators(out["plan_with_metrics"]) != \
                analyze_operators(standalone_q1):
            raise AssertionError(
                f"cluster ANALYZE q1 differs from the standalone one:\n"
                f"{out['plan_with_metrics']}\n--- standalone:\n"
                f"{standalone_q1}")
        if n_launch < 2:
            raise AssertionError(f"cluster ANALYZE q1: {n_launch} launches")
    finally:
        cluster.shutdown()
    launches["cluster_explain_q1"] = n_launch
    log(f"# EXPLAIN ANALYZE q1 through the cluster: one task, {secs:.4f} s, "
        f"kernel launches {n_launch}; operators and rows == standalone")
    return {"wall_s": secs, "launches": n_launch}


@contextlib.contextmanager
def flight_scheduler(data_dir: str, tables):
    """``scheduler_main --flight-port 0 --device cuda`` in a process of its
    own, two executors of this process on the card, and a stock
    ``pyarrow.flight`` client with ``tables`` of ``data_dir`` registered
    by DDL tickets; yields the client. On the way out the executors stop
    and SIGTERM must drain the scheduler (exit 0)."""
    import re
    import signal
    import tempfile

    import pyarrow.flight as paflight

    from ballista_tpu_torch.distributed.executor import (Executor,
                                                         ExecutorConfig)
    from ballista_tpu_torch.testing.tpch_schema import tpch_ddl

    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.distributed.scheduler_main",
         "--port", "0", "--flight-port", "0", "--metrics-port", "-1",
         "--bind-host", "127.0.0.1", "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, executors, work = [], [], tempfile.mkdtemp(prefix="flight-")
    try:
        port = fport = None
        deadline = time.time() + 120
        while (port is None or fport is None) and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"scheduler listening on [\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else port
            m = re.search(r"Flight SQL endpoint on [\d.]+:(\d+)", line)
            fport = int(m.group(1)) if m else fport
        if port is None or fport is None:
            raise AssertionError("scheduler_main printed no ports:\n"
                                 + "".join(lines))
        for i in range(2):
            ex = Executor(ExecutorConfig(
                scheduler_host="127.0.0.1", scheduler_port=port,
                work_dir=os.path.join(work, f"e{i}"), concurrent_tasks=2,
                metrics_port=-1))
            ex.start()
            executors.append(ex)
        client = paflight.connect(f"grpc://127.0.0.1:{fport}")
        for table in tables:
            client.do_get(paflight.Ticket(
                tpch_ddl(table, data_dir).encode())).read_all()
        yield client
        client.close()
        while executors:  # before the scheduler, which they poll
            executors.pop().stop()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        lines.append(out)
    finally:
        for ex in executors:
            ex.stop()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(lines)
    if proc.returncode != 0 or "draining" not in text:
        raise AssertionError(f"scheduler_main did not drain on SIGTERM "
                             f"(exit {proc.returncode}):\n{text[-3000:]}")


def flight_result(client, sql: str) -> dict:
    import pyarrow.flight as paflight

    table = client.do_get(paflight.Ticket(sql.encode())).read_all()
    return {c: np.asarray(table[c].to_numpy(zero_copy_only=False))
            for c in table.column_names}


def phase_flight(data_dir: str, want_q1: dict, explain_q1: dict,
                 launches: dict) -> dict:
    """``flight_scheduler`` at SF1: q1 and EXPLAIN q1 equal the standalone
    results, q1's kernel launches counted; SIGTERM drains the scheduler.
    (Phase 16 sends it the scalar subqueries.)"""
    import pyarrow.flight as paflight

    from ballista_tpu_torch.kernels import dense_sums as ds

    sql = open(os.path.join(QUERY_DIR, "q1.sql")).read()
    with flight_scheduler(data_dir, ("lineitem",)) as client:
        with KernelCallLog() as spy:
            torch.cuda.synchronize()
            ds.launch_count = 0
            t0 = time.perf_counter()
            got = flight_result(client, sql)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n_launch = ds.launch_count
        check_observed(spy.calls, "Flight q1")
        assert_close_results("Flight q1 vs standalone", got, want_q1)
        if n_launch < 2:
            raise AssertionError(f"Flight q1: {n_launch} kernel launches")
        plan = client.do_get(paflight.Ticket(
            ("EXPLAIN " + sql).encode())).read_all().to_pydict()
        if dict(zip(plan["plan_type"], plan["plan"])) != explain_q1:
            raise AssertionError("Flight EXPLAIN q1 differs from standalone")
    launches["flight_q1"] = n_launch
    log(f"# Flight: q1 in {secs:.4f} s == standalone, kernel launches "
        f"{n_launch}; EXPLAIN q1 == standalone; scheduler drained on "
        f"SIGTERM")
    return {"q1_s": secs, "launches": n_launch}


def phase_progress_capture(data_dir: str) -> dict:
    """Cold q5 at SF1 with ``on_progress`` sampling every 10 ms while the
    collect's thread captures its graphs, against the same cold q5 with
    no sampler: equal results and the same number of captures."""
    from ballista_tpu_torch.cache import residency
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.compile import compile_stats, governor
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    sql = open(os.path.join(QUERY_DIR, "q5.sql")).read()
    os.environ["BALLISTA_PROGRESS_INTERVAL_SECS"] = "0.01"
    runs = {}
    try:
        for label in ("plain", "sampled"):
            residency.reset()
            governor().clear()
            ctx = BallistaContext.standalone()
            register_tpch(ctx, data_dir)
            samples = []
            st0 = compile_stats()
            t0 = time.perf_counter()
            out = ctx.sql(sql).to_pydict(
                on_progress=samples.append if label == "sampled" else None)
            torch.cuda.synchronize()
            runs[label] = {
                "out": out, "wall_s": time.perf_counter() - t0,
                "captures": compile_stats()["graph_captures"]
                - st0["graph_captures"], "samples": samples}
    finally:
        os.environ.pop("BALLISTA_PROGRESS_INTERVAL_SECS", None)
    plain, sampled = runs["plain"], runs["sampled"]
    assert_equal_results("cold q5 with the sampler vs without",
                         sampled["out"], plain["out"])
    if sampled["captures"] != plain["captures"]:
        raise AssertionError(f"cold q5 captured {sampled['captures']} graphs "
                             f"with the sampler, {plain['captures']} without")
    snaps = sampled["samples"]
    if len(snaps) < 2 or snaps[-1]["fraction"] != 1.0:
        raise AssertionError(f"cold q5 progress: {snaps[-3:]}")
    fractions = [s["fraction"] for s in snaps]
    if fractions != sorted(fractions):
        raise AssertionError(f"cold q5 progress fell: {fractions}")
    row = {"captures": plain["captures"], "snapshots": len(snaps),
           "plain_s": plain["wall_s"], "sampled_s": sampled["wall_s"]}
    log(f"# progress during capture: cold q5 {json.dumps(row)}; "
        f"results equal, captures equal, last fraction 1.0")
    return row


def phase_recorder_overhead(ctx, pairs: int = 7) -> dict:
    """Warm q1 at SF1, in turns: the collect with the ledger and the query
    history on (``BALLISTA_LEDGER`` on, ``BALLISTA_QUERY_LOG_DIR`` set),
    with both off, and the collect without the recorder at all (the
    governed collect alone, as before the recorder was wired in);
    ``pairs`` rounds, medians and quartiles; and the recorder's parts,
    timed inside the first two variants (mean ms a collect)."""
    import tempfile

    from ballista_tpu_torch.observability import ledger as obs_ledger
    from ballista_tpu_torch.observability import systables

    sql = open(os.path.join(QUERY_DIR, "q1.sql")).read()
    df = ctx.sql(sql)
    df.to_pydict()  # warm: cached scans, captured programs
    log_dir = tempfile.mkdtemp(prefix="query-log-")

    def knobs(on: bool):
        if on:
            os.environ["BALLISTA_LEDGER"] = "on"
            os.environ["BALLISTA_QUERY_LOG_DIR"] = log_dir
        else:
            os.environ["BALLISTA_LEDGER"] = "off"
            os.environ.pop("BALLISTA_QUERY_LOG_DIR", None)
        obs_ledger.reconfigure()

    def bare():
        _, df._phys = ctx._standalone_collect_inner(df.plan, df._phys)

    variants = {"on": (True, df.to_pydict), "off": (False, df.to_pydict),
                "bare": (False, bare)}
    times = {k: [] for k in variants}
    parts = {}  # (variant, part) -> seconds summed over the rounds
    timed = [(systables.StandaloneQueryRecorder, "__init__", "start"),
             (systables.StandaloneQueryRecorder, "_lanes", "lanes"),
             (systables.StandaloneQueryRecorder, "_build_ledger", "ledger"),
             (systables.StandaloneQueryRecorder, "finish", "finish"),
             (systables.QueryHistoryLog, "append", "history_append")]
    current = ["on"]

    def timing(fn, part):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                key = (current[0], part)
                parts[key] = parts.get(key, 0.0) + time.perf_counter() - t
        return wrapper

    saved = [(cls, name, getattr(cls, name)) for cls, name, _ in timed]
    for cls, name, part in timed:
        setattr(cls, name, timing(getattr(cls, name), part))
    try:
        for _ in range(pairs):
            for name, (on, fn) in variants.items():
                knobs(on)
                current[0] = name
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)
        os.environ.pop("BALLISTA_LEDGER", None)
        os.environ.pop("BALLISTA_QUERY_LOG_DIR", None)
        obs_ledger.reconfigure()
    row = {}
    for name, ts in times.items():
        q = np.percentile(ts, [25, 50, 75])
        row[name] = {"median_s": float(q[1]), "p25_s": float(q[0]),
                     "p75_s": float(q[2])}
    row["on_vs_off"] = row["on"]["median_s"] / row["off"]["median_s"] - 1
    row["on_vs_bare"] = row["on"]["median_s"] / row["bare"]["median_s"] - 1
    row["parts_ms"] = {f"{v}.{part}": secs / pairs * 1e3
                       for (v, part), secs in sorted(parts.items())}
    log(f"# recorder overhead, warm q1 ({pairs} rounds in turns): "
        f"{json.dumps(row)}")
    return row


def phase_observability(card: str, data_dir: str, want_q1: dict) -> tuple:
    """Phase 15: the first-collect ledger of a fresh process, EXPLAIN and
    EXPLAIN ANALYZE standalone and through the cluster, Arrow Flight, the
    progress sampler during captures, and the recorder's overhead."""
    t0 = time.perf_counter()
    launches = {}
    row = {"first_collect": phase_first_collect(data_dir)}
    explain = phase_explain(data_dir, launches)
    gpu = explain.pop("gpu_ctx")
    row["explain"] = explain
    sql1 = open(os.path.join(QUERY_DIR, "q1.sql")).read()
    standalone_q1 = explain_rows(gpu.sql("EXPLAIN ANALYZE " + sql1)
                                 .to_pydict())["plan_with_metrics"]
    row["cluster_explain"] = phase_cluster_explain(data_dir, standalone_q1,
                                                   launches)
    explain_q1 = explain_rows(gpu.sql("EXPLAIN " + sql1).to_pydict())
    row["flight"] = phase_flight(data_dir, want_q1, explain_q1, launches)
    row["progress"] = phase_progress_capture(data_dir)
    row["recorder"] = phase_recorder_overhead(gpu)
    row["seconds"] = time.perf_counter() - t0
    log(f"# phase 15 (observability, EXPLAIN and Flight) took "
        f"{row['seconds']:.1f} s on {card}")
    return row, launches


# -- phase 16 ---------------------------------------------------------------

SUBQUERY_QUERIES = ("q11", "q15", "q22")  # one scalar subquery each
SUBQUERY_TABLES = ("lineitem", "nation", "supplier", "partsupp",
                   "customer", "orders")


def assert_same_literal(label: str, got: dict, want: dict) -> None:
    """Decimal, date and integer results exactly; float results within
    rtol 1e-6."""
    (v, kind), = got["literals"]
    (w, wkind), = want["literals"]
    if kind != wkind or got["kinds"] != want["kinds"]:
        raise AssertionError(f"{label}: {got} vs {want}")
    if v is None or w is None:  # an empty or NULL scalar result
        ok = v is None and w is None
    elif got["kinds"][0] in ("float32", "float64"):
        ok = abs(v - w) <= 1e-6 * abs(w)
    else:
        ok = v == w
    if not ok:
        raise AssertionError(f"{label}: literal {v!r} != {w!r}")


def phase_server_subqueries(data_dir: str, launches: dict) -> dict:
    """(a) q11, q15 and q22 at SF1 server-planned (``plan.server=on``)
    through ``LocalCluster(device="cuda")``: the scheduler runs each
    scalar subquery on the card. Results equal the standalone collect on
    the card and the port on the CPU; each subquery's literal is logged
    on the card (scheduler and standalone) and the CPU and must agree;
    the kernel's launches counted per query and inside its subquery."""
    from ballista_tpu_torch import execution
    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.distributed import scheduler
    from ballista_tpu_torch.distributed.executor import LocalCluster
    from ballista_tpu_torch.kernels import dense_sums as ds
    from ballista_tpu_torch.testing.subqueries import SubqueryRecorder
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    gpu = BallistaContext.standalone()
    cpu = BallistaContext.standalone(device="cpu")
    register_tpch(gpu, data_dir, tables=list(SUBQUERY_TABLES))
    register_tpch(cpu, data_dir, tables=list(SUBQUERY_TABLES))
    rows = {}
    cluster = LocalCluster(num_executors=2, concurrent_tasks=2,
                           device="cuda")
    try:
        ctx = BallistaContext.remote("localhost", cluster.port,
                                     **{"plan.server": "on"})
        register_tpch(ctx, data_dir, tables=list(SUBQUERY_TABLES))
        for q in SUBQUERY_QUERIES:
            sql = open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
            with SubqueryRecorder(execution) as card_std:
                want_card = gpu.sql(sql).to_pydict()
            with SubqueryRecorder(execution) as cpu_std:
                want_cpu = cpu.sql(sql).to_pydict()
            with SubqueryRecorder(scheduler) as server, KernelCallLog() as spy:
                torch.cuda.synchronize()
                ds.launch_count = 0
                t0 = time.perf_counter()
                got = ctx.sql(sql).to_pydict()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                n_launch = ds.launch_count
            check_observed(spy.calls, f"server-planned {q}")
            assert_close_results(f"server-planned {q} vs standalone card",
                                 got, want_card)
            assert_close_results(f"server-planned {q} vs cpu", got,
                                 want_cpu)
            srv = server.only(f"{q} scheduler")
            std = card_std.only(f"{q} standalone card")
            ref = cpu_std.only(f"{q} cpu")
            assert_same_literal(f"{q} scheduler vs cpu", srv, ref)
            assert_same_literal(f"{q} standalone card vs cpu", std, ref)
            rows[q] = {"s": secs, "launches": n_launch,
                       "subquery_launches": srv["launches"],
                       "kind": srv["kinds"][0],
                       "literal_card": repr(srv["literals"][0][0]),
                       "literal_standalone_card": repr(std["literals"][0][0]),
                       "literal_cpu": repr(ref["literals"][0][0])}
            log(f"# server-planned {q} (sf{SCALE:g}): == standalone card "
                f"== cpu, {secs:.4f} s, kernel launches {n_launch} "
                f"({srv['launches']} in the subquery on the scheduler); "
                f"subquery ({srv['kinds'][0]}) literal: scheduler "
                f"{rows[q]['literal_card']}, standalone card "
                f"{rows[q]['literal_standalone_card']}, cpu "
                f"{rows[q]['literal_cpu']}")
    finally:
        cluster.shutdown()
    launches["server_subquery"] = {q: r["subquery_launches"]
                                   for q, r in rows.items()}
    return rows


def phase_flight_subqueries(small_dir: str, small_want: dict) -> dict:
    """(b) q11, q15 and q22 at SF0.05 over ``flight_scheduler``: the
    scheduler's loopback context resolves each subquery on its
    ``--device cuda``; each result equals phase 12's standalone collect
    on the card."""
    rows = {}
    with flight_scheduler(small_dir, SUBQUERY_TABLES) as client:
        for q in SUBQUERY_QUERIES:
            sql = open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
            with KernelCallLog() as spy:
                t0 = time.perf_counter()
                got = flight_result(client, sql)
                rows[q] = time.perf_counter() - t0
            # the tasks run in this process's executors
            check_observed(spy.calls, f"Flight {q}")
            assert_close_results(f"Flight {q} vs standalone card", got,
                                 small_want[q])
    log(f"# Flight subqueries (sf{SMALL_SCALE:g}, --device cuda): "
        f"{', '.join(f'{q} {s:.4f} s' for q, s in rows.items())}, each == "
        f"standalone card; scheduler drained on SIGTERM")
    return rows


def prewarm_child(data_dir: str) -> int:
    """Run in a fresh process (``--prewarm-child``): the process's first
    q1, then its first q6, at SF1, with ``BALLISTA_PREWARM`` as the
    parent set it. Prints one ``PREWARM_CHILD`` JSON line: per query the
    wall, the ledger's compile phase, the prewarm pass's programs and
    failures, the real call's captures, the foreground's wait on the
    capture lock, the kernel's launches (the prewarm warm-up's included)
    and the result. Every kernel call of the collect, the warm-up's
    included, is held against the plain version after it."""
    import threading as _threading

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.compile import compile_stats, prewarm_enabled
    from ballista_tpu_torch.kernels import dense_sums as ds
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    ctx = BallistaContext.standalone()
    register_tpch(ctx, data_dir, tables=["lineitem"])
    out = {"prewarm": prewarm_enabled()}
    for q in ("q1", "q6"):
        sql = open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
        st0 = compile_stats()
        with KernelCallLog() as spy:
            torch.cuda.synchronize()
            ds.launch_count = 0
            t0 = time.perf_counter()
            res = ctx.sql(sql).to_pydict()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for t in _threading.enumerate():
                if t.name == "ballista-prewarm":
                    t.join()
        st1 = compile_stats()
        check_observed(spy.calls, f"prewarm child first {q}")
        observed = len(spy.calls)
        del spy  # its copies of the kernel's inputs
        led = ctx.last_query_ledger()
        lanes = ctx.sql("select job_id, lane, seconds from "
                        "system.query_lanes").to_pydict()
        out[q] = {
            "wall_s": led["wall_seconds"], "host_wall_s": wall,
            "lanes": {ln: sec for j, ln, sec in zip(
                lanes["job_id"], lanes["lane"], lanes["seconds"])
                if j == led["job_id"]},
            "compile_s": led["phases"]["compile"],
            "phases": led["phases"],
            "launches": ds.launch_count,
            "observed_calls": observed,
            # what the process holds on the card after the collect (and
            # the prewarm pass): kept programs' buffers, cached tables
            "allocated_mb": torch.cuda.memory_allocated() / 2**20,
            "result": {k: np.asarray(v).tolist() for k, v in res.items()},
        }
        for k in ("prewarm_compiles", "prewarm_seconds", "prewarm_failures",
                  "graph_captures", "capture_lock_wait_seconds"):
            out[q][k] = st1[k] - st0[k]
    print("PREWARM_CHILD " + json.dumps(out), flush=True)
    return 0


def phase_prewarm(data_dir: str, want_q1: dict, launches: dict,
                  rounds: int = 3) -> dict:
    """(c) ``prewarm_child`` in fresh processes: with
    ``BALLISTA_PREWARM=1`` and without it in turns (``rounds`` each), then
    once without it under ``CUDA_MODULE_LOADING=EAGER`` (every kernel
    loaded when the context comes up: what is left of a first call is not
    lazy module loading; once, to keep the script near 600 s). No warm-up
    may fail, every kernel call of a child is bit-equal to the plain
    version (checked in the child), and every run's q1 and q6 equal the
    first run's (q1 also the port on the CPU)."""
    runs = {"on": [], "off": [], "eager_loading": []}
    for mode in ["on", "off"] * rounds + ["eager_loading"]:
        env = dict(os.environ)
        env.pop("BALLISTA_PREWARM", None)
        if mode == "on":
            env["BALLISTA_PREWARM"] = "1"
        if mode == "eager_loading":
            env["CUDA_MODULE_LOADING"] = "EAGER"
        proc = subprocess.run(
            [sys.executable, __file__, "--prewarm-child", data_dir],
            capture_output=True, text=True, timeout=300, env=env)
        if proc.returncode != 0:
            raise AssertionError(f"prewarm child ({mode}) failed "
                                 f"({proc.returncode}):\n"
                                 f"{proc.stderr[-3000:]}")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("PREWARM_CHILD "))
        run = json.loads(line[len("PREWARM_CHILD "):])
        if run["prewarm"] != (mode == "on"):
            raise AssertionError(f"prewarm child ran with {run}")
        runs[mode].append(run)
    first = {q: runs["on"][0][q]["result"] for q in ("q1", "q6")}
    got_q1 = {k: np.asarray(v) for k, v in first["q1"].items()}
    assert_close_results("prewarm q1 vs cpu", got_q1, want_q1)
    rows = {}
    for mode, rs in runs.items():
        for i, run in enumerate(rs):
            for q in ("q1", "q6"):
                r = run[q]
                if r["result"] != first[q]:
                    raise AssertionError(f"prewarm {mode} run {i} {q}: "
                                         f"result differs from the first")
                if r["prewarm_failures"]:
                    raise AssertionError(f"prewarm {mode} run {i} {q}: "
                                         f"{r['prewarm_failures']} failures")
                if (mode == "on") != (r["prewarm_compiles"] > 0):
                    raise AssertionError(f"prewarm {mode} run {i} {q}: "
                                         f"{r['prewarm_compiles']} programs")
                r.pop("result")
                rows.setdefault(f"{q}_{mode}", []).append(r)
                log(f"# prewarm {mode} run {i} first {q}: {json.dumps(r)}")
    for q in ("q1", "q6"):
        for key in ("wall_s", "compile_s", "allocated_mb"):
            med = {m: float(np.median([r[key] for r in rows[f"{q}_{m}"]]))
                   for m in runs}
            log(f"# prewarm first {q} {key} median: on {med['on']:.4f}, "
                f"off {med['off']:.4f}, off with eager module loading "
                f"{med['eager_loading']:.4f}")
    launches["prewarm_q1"] = {m: [r["launches"] for r in rows[f"q1_{m}"]]
                              for m in ("on", "off")}
    return rows


def phase_aot(data_dir: str, want_q1: dict) -> dict:
    """(d) q1 with ``BALLISTA_FUSION_AOT_DIR`` naming an empty directory,
    from a cleared governor: the directory stays empty, ``aot_loads`` and
    ``aot_exports`` stay 0 (``compile_stats()`` and ``system.compile``),
    and the result equals the port on the CPU."""
    import shutil
    import tempfile

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.compile import compile_stats, governor
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    aot_dir = tempfile.mkdtemp(prefix="aot-")
    os.environ["BALLISTA_FUSION_AOT_DIR"] = aot_dir
    try:
        governor().clear()
        ctx = BallistaContext.standalone()
        register_tpch(ctx, data_dir, tables=["lineitem"])
        sql = open(os.path.join(QUERY_DIR, "q1.sql")).read()
        got = ctx.sql(sql).to_pydict()
        assert_close_results("q1 with BALLISTA_FUSION_AOT_DIR", got, want_q1)
        st = compile_stats()
        rows = ctx.sql("select aot_loads from system.compile").to_pydict()
        left = os.listdir(aot_dir)
        if left or st["aot_loads"] or st["aot_exports"] or \
                any(int(v) for v in rows["aot_loads"]):
            raise AssertionError(f"AOT directory {left}, stats "
                                 f"{st['aot_loads']}/{st['aot_exports']}, "
                                 f"system.compile {rows['aot_loads']}")
    finally:
        os.environ.pop("BALLISTA_FUSION_AOT_DIR", None)
        shutil.rmtree(aot_dir, ignore_errors=True)
    log(f"# AOT: q1 with BALLISTA_FUSION_AOT_DIR == cpu; the directory "
        f"stayed empty, aot_loads 0, aot_exports 0 "
        f"({len(rows['aot_loads'])} system.compile rows)")
    return {"entries": len(rows["aot_loads"])}


def phase_subqueries_prewarm_aot(card: str, data_dir: str, small_dir: str,
                                 small_want: dict, want_q1: dict) -> tuple:
    """Phase 16: server-planned and Flight scalar subqueries on the card,
    the prewarm pass in fresh processes, the AOT knob."""
    t0 = time.perf_counter()
    launches = {}
    row = {"server": phase_server_subqueries(data_dir, launches),
           "flight": phase_flight_subqueries(small_dir, small_want),
           "prewarm": phase_prewarm(data_dir, want_q1, launches),
           "aot": phase_aot(data_dir, want_q1)}
    row["seconds"] = time.perf_counter() - t0
    log(f"# phase 16 (subqueries, prewarm, AOT) took {row['seconds']:.1f} s "
        f"on {card}")
    return row, launches


# -- phase 17 ---------------------------------------------------------------

MESH_SLOTS = 4


def stacked_rows(batches) -> np.ndarray:
    """The live rows of ``batches`` as one int64 matrix (a column per
    field, NULL as int64's minimum), sorted row-wise: a join's result in
    a form two implementations can be compared in exactly."""
    cols = None
    for b in batches:
        sel = b.selection.cpu().numpy()
        part = []
        for c in b.columns:
            v = c.values.cpu().numpy().astype(np.int64)
            if c.validity is not None:
                v = np.where(c.validity.cpu().numpy(), v,
                             np.iinfo(np.int64).min)
            part.append(v[sel])
        cols = part if cols is None else [np.concatenate([a, p])
                                          for a, p in zip(cols, part)]
    mat = np.stack(cols, axis=1)
    return mat[np.lexsort(mat.T[::-1])]


def mesh_join_pair(with_nulls: bool):
    """A seeded build/probe pair on the card: 250,000 build rows (keys in
    [0, 400,000): duplicates and misses; every 97th key NULL when asked)
    in 2 partitions, 1,000,000 probe rows (keys in [100,000, 600,000)) in
    4 partitions."""
    from ballista_tpu_torch import datatypes as dt
    from ballista_tpu_torch.columnar import Column, ColumnBatch
    from ballista_tpu_torch.io.memory import MemTableSource
    from ballista_tpu_torch.physical.operators import ScanExec

    rng = np.random.default_rng(17)
    bs = dt.Schema([dt.Field("bk", dt.Int64), dt.Field("bv", dt.Int64)])
    ps = dt.Schema([dt.Field("pk_", dt.Int64), dt.Field("pv", dt.Int64)])
    bk = rng.integers(0, 400_000, 250_000)
    pk = rng.integers(100_000, 600_000, 1_000_000)
    build_parts = []
    for c in np.array_split(np.arange(len(bk)), 2):
        b = ColumnBatch.from_numpy(bs, {"bk": bk[c], "bv": c}, device="cuda")
        if with_nulls:
            valid = np.zeros(b.capacity, bool)
            valid[: len(c)] = (c % 97) != 0
            col = b.columns[0]
            b = b.with_columns(bs, (Column(
                col.values, col.dtype, torch.from_numpy(valid).cuda(),
                None), b.columns[1]))
        build_parts.append([b])
    probe_parts = [[ColumnBatch.from_numpy(ps, {"pk_": pk[c], "pv": c},
                                           device="cuda")]
                   for c in np.array_split(np.arange(len(pk)), 4)]
    return (ScanExec("b", MemTableSource(bs, build_parts)),
            ScanExec("p", MemTableSource(ps, probe_parts)))


def phase_mesh_join_types() -> dict:
    """Every join type of ``MeshJoinExec`` over ``MESH_SLOTS`` slots on
    the card against the host ``JoinExec`` on the card, on the seeded
    pair above, row for row (sorted), exactly."""
    from ballista_tpu_torch.physical.join import JoinExec
    from ballista_tpu_torch.physical.mesh_agg import MeshJoinExec

    out = {}
    cases = [(h, False, False) for h in
             ("inner", "left", "semi", "anti", "full")]
    cases += [("left", True, False), ("anti", True, True)]
    for how, nulls, null_aware in cases:
        build, probe = mesh_join_pair(nulls)
        label = how + (" null keys" if nulls else "") + \
            (" null-aware" if null_aware else "")
        host = JoinExec(build, probe, [("bk", "pk_")], how,
                        null_aware=null_aware, device="cuda")
        mesh = MeshJoinExec(build, probe, [("bk", "pk_")], how, MESH_SLOTS,
                            null_aware=null_aware, device="cuda")
        t0 = time.perf_counter()
        got = stacked_rows(list(mesh.execute(0)))
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        want = stacked_rows([b for p in range(
            host.output_partitioning().num_partitions)
            for b in host.execute(p)])
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"mesh {label} join: {got.shape} rows != "
                                 f"host JoinExec's {want.shape}")
        out[label] = {"rows": int(got.shape[0]), "mesh_s": mesh_s}
    log(f"# mesh joins on the card, {MESH_SLOTS} slots, 1,000,000 probe "
        f"rows: every type == JoinExec on the card: {json.dumps(out)}")
    return out


def mesh_binary(small_dir: str, want_q1) -> dict:
    """``executor_main --local --num-devices 4`` on the card: q1 at
    SF0.05 with a shuffled aggregate fuses (the embedded scheduler logs
    the mesh fusion), the executor reports 4 slots, the result equals
    the standalone one, and SIGTERM drains (exit 0)."""
    import re
    import signal

    from ballista_tpu_torch.client import BallistaContext
    from ballista_tpu_torch.testing.tpch_schema import register_tpch

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.distributed.executor_main",
         "--local", "--num-devices", str(MESH_SLOTS), "--device", "cuda",
         "--metrics-port", "-1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port = None
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"embedded scheduler on localhost:(\d+)", line)
            if m:
                port = int(m.group(1))
        if port is None:
            raise AssertionError("the executor binary printed no scheduler "
                                 "port:\n" + "".join(lines))
        ctx = BallistaContext.remote(
            "localhost", port, **{"agg.partitions": str(MESH_SLOTS),
                                  "mesh.devices": str(MESH_SLOTS)})
        register_tpch(ctx, small_dir, tables=["lineitem"])
        q1 = open(os.path.join(QUERY_DIR, "q1.sql")).read()
        t1 = time.perf_counter()
        got = ctx.sql(q1).to_pydict()
        q1_s = time.perf_counter() - t1
        assert_close_results("mesh binary q1 vs standalone", got, want_q1)
        slots = ctx.sql("select num_devices from system.executors"
                        ).to_pydict()["num_devices"]
        if list(slots) != [MESH_SLOTS]:
            raise AssertionError(f"the mesh binary reports {list(slots)}")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(lines)
    if proc.returncode != 0 or "(graceful drain)" not in text:
        raise AssertionError(f"the mesh binary did not drain on SIGTERM "
                             f"(exit {proc.returncode}):\n{text[-3000:]}")
    if f"into a {MESH_SLOTS}-device mesh shuffle-agg" not in text:
        raise AssertionError("the mesh binary's scheduler fused nothing:\n"
                             + text[-3000:])
    secs = time.perf_counter() - t0
    log(f"# mesh binary: executor_main --local --num-devices {MESH_SLOTS} "
        f"fused q1 at sf{SMALL_SCALE:g} into a mesh stage, answered in "
        f"{q1_s:.4f} s (== standalone), reported {MESH_SLOTS} slots, "
        f"drained on SIGTERM (exit 0); {secs:.1f} s in all")
    return {"q1_s": q1_s, "seconds": secs}


def phase_mesh(card: str, data_dir: str, small_dir: str, unfused: dict,
               want_small_q1: dict) -> tuple:
    """Phase 17: the mesh on the card. A ``LocalCluster(2, 2,
    num_devices=MESH_SLOTS)`` on cuda runs q1, q3 and q5 at SF1 (lineitem
    and orders in 4 files) three times through mesh-fused stages: the
    task plans hold ``MeshAggExec`` (q1) or ``MeshJoinExec`` (q3, q5);
    results equal phase 14's unfused cluster and numpy; every kernel call
    of the mesh q1 bit-equal to the plain version. Then the join types
    against ``JoinExec``, and the executor binary with
    ``--num-devices``."""
    from ballista_tpu_torch.cache import residency
    from ballista_tpu_torch.compile import compile_stats, governor
    from ballista_tpu_torch.distributed.executor import LocalCluster
    from ballista_tpu_torch.kernels import dense_sums as ds
    from ballista_tpu_torch.physical.mesh_agg import MeshAggExec, MeshJoinExec

    t_phase = time.perf_counter()
    log(f"# phase 17 (mesh): {MESH_SLOTS} slots on one card; the "
        f"cross-process path (NCCL between cards) is not run: this machine "
        f"has one card, and NCCL refuses two ranks on one card")
    split_dir = os.path.join("bench_data", f"sf{SCALE:g}_split")
    for t in CLUSTER_SPLIT:  # phase 14's split files (kept while valid)
        split_lines(os.path.join(data_dir, t, "partition0.tbl"),
                    os.path.join(split_dir, t), CLUSTER_PARTS)
    refs = {"q1": numpy_reference(data_dir)["q1"], "q3": numpy_q3(data_dir),
            "q5": numpy_q5(data_dir)}
    set_ingest_env({"BALLISTA_TABLE_CACHE_BUDGET_MB": "8192"})
    residency.reset()
    governor().clear()
    cluster = LocalCluster(num_executors=2, concurrent_tasks=2,
                           num_devices=MESH_SLOTS)
    rows, launches = {}, {}
    try:
        ctx = cluster_context(cluster, data_dir, split_dir)
        # explicit settings: the scheduler's cost feedback leaves them
        # alone. A fused stage writes no shuffle bytes, which the
        # feedback reads as a small shuffle and answers by raising the
        # join threshold: a repeated q3/q5 would be re-planned onto
        # merged (unfused) joins
        ctx.settings.update({"agg.partitions": str(MESH_SLOTS),
                             "join.partitioned.threshold": "1000000",
                             "join.partitions": "8",
                             "mesh.devices": str(MESH_SLOTS)})
        for q in STAGED_QUERIES:
            sql = open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
            row = {}
            for label in ("first", "second", "third"):
                st0 = compile_stats()
                torch.cuda.reset_peak_memory_stats()
                with KernelCallLog() as spy, TaskPlanLog() as plans:
                    torch.cuda.synchronize()
                    ds.launch_count = 0
                    t0 = time.perf_counter()
                    out = ctx.sql(sql).to_pydict()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    n_launch = ds.launch_count
                st1 = compile_stats()
                check_observed(spy.calls, f"mesh {q} {label}")
                want_cls = MeshAggExec if q == "q1" else MeshJoinExec
                fused = [n for p in plans.plans
                         for n in find_nodes(p, want_cls)]
                if not fused or any(n.n_devices != MESH_SLOTS
                                    for n in fused):
                    raise AssertionError(f"mesh {q} {label}: no "
                                         f"{want_cls.__name__} over "
                                         f"{MESH_SLOTS} slots in the tasks")
                check_plans_on_card(plans.plans, f"mesh {q} {label}")
                assert_close_results(f"mesh {q} {label} vs phase 14's "
                                     f"unfused cluster", out, unfused[q])
                assert_close_results(f"mesh {q} {label} vs numpy", out,
                                     refs[q])
                shapes = {}
                for c in spy.calls:
                    key = f"N={c[0].shape[0]},K={len(c[2])},G={c[3]}"
                    shapes[key] = shapes.get(key, 0) + 1
                if q == "q1":
                    # the final aggregate: one call per slot, at the
                    # exchange's capacity (n slots x the slot capacity)
                    finals = [c for c in spy.calls if c[0].shape[0]
                              % MESH_SLOTS == 0 and c[0].shape[0]
                              <= MESH_SLOTS * 4096]
                    if len(finals) != MESH_SLOTS:
                        raise AssertionError(
                            f"mesh q1 {label}: {len(finals)} final-aggregate "
                            f"kernel calls, expected one per slot ({shapes})")
                    launches[label] = n_launch
                row[label] = {
                    "wall_s": wall, "launches": n_launch,
                    "observed_calls": len(spy.calls), "call_shapes": shapes,
                    "captures": st1["graph_captures"] - st0["graph_captures"],
                    "replays": st1["graph_replays"] - st0["graph_replays"],
                    "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
                    "tasks": len(plans.plans), "mesh_nodes": len(fused)}
                log(f"# mesh {q} {label}: {json.dumps(row[label])}; "
                    f"== phase 14's unfused cluster == numpy")
            rows[q] = row
        sql5 = open(os.path.join(QUERY_DIR, "q5.sql")).read()
        copies = profile_copies(lambda: ctx.sql(sql5).to_pydict(),
                                "mesh-q5")
        copies["busy_share"] = copies["busy_ms"] / 1e3 / copies["wall_s"]
        log(f"# mesh q5 repeated, profiled: {json.dumps(copies)}")
    finally:
        cluster.shutdown()
        set_ingest_env({})
        residency.reset()
        governor().clear()
    joins = phase_mesh_join_types()
    binary = mesh_binary(small_dir, want_small_q1)
    secs = time.perf_counter() - t_phase
    log(f"# phase 17 (mesh) took {secs:.1f} s on {card}")
    return {"rows": rows, "q5_profile": copies, "joins": joins,
            "binary": binary, "seconds": secs}, launches


# -- phase 18 ---------------------------------------------------------------


class KernelCallCheck:
    """Holds each executed call of ``dense_grouped_sums`` against the
    plain version on that call's inputs while it is entered, as the call
    happens (``dense_sums.observe``; graph replays included), keeping no
    copies: a whole bench run makes hundreds of calls."""

    def __init__(self):
        self.calls = 0
        self.failures = []
        self._lock = threading.Lock()

    def __call__(self, gids, live, values, num_groups, sums, counts, first):
        from ballista_tpu_torch.kernels import dense_sums as ds

        ref_sums, ref_counts, ref_first = ds.dense_grouped_sums_reference(
            gids, live, values, num_groups)
        got = torch.stack(list(sums) + [counts, first])
        want = torch.stack(list(ref_sums) + [ref_counts, ref_first])
        same = torch.equal(got, want)
        with self._lock:
            self.calls += 1
            if not same:
                self.failures.append((int(gids.shape[0]), len(values),
                                      num_groups))

    def __enter__(self):
        from ballista_tpu_torch.kernels import dense_sums as ds

        self._observing = ds.observe(self)
        self._observing.__enter__()
        return self

    def __exit__(self, *exc):
        return self._observing.__exit__(*exc)

    def check(self, label: str) -> None:
        if self.failures:
            raise AssertionError(
                f"{label}: {len(self.failures)} of {self.calls} kernel calls "
                f"differ from the plain version (N, K, G: "
                f"{self.failures[:4]})")
        if self.calls == 0:
            raise AssertionError(f"{label}: no kernel call was observed")
        log(f"# {label}: all {self.calls} observed kernel calls bit-equal "
            f"to the plain version")


# the bench line's fields that phase 18 requires
BENCH_FIELDS = (
    "metric", "value", "unit", "vs_baseline", "device", "power_limit_w",
    "parse_seconds", "h2d_seconds", "execute_seconds", "lineitem_rows",
    "cold_seconds", "cold_rows_per_sec", "first_run_seconds",
    "warm_seconds", "q5_first_seconds", "q5_warm_seconds",
    "compile_count", "compile_seconds", "persistent_cache_hit",
    "jit_programs", "aot_loads", "peak_device_bytes", "spill_bytes",
    "shuffle_peak_inflight_mb", "table_cache_hits", "result_cache_hits",
    "donated_buffers", "cache_q1_identical", "result_cache_identical",
    "cache_budget_identical", "spill_q5_seconds",
    "kernel_launches_per_warm_q1", "stages",
)
STAGE_FIELDS = ("parse_s", "parse_mb_per_s", "h2d_s", "rows", "kernel_s",
                "kernel_rows_per_s", "kernel_aot_compile_s",
                "kernel_bytes_accessed", "kernel_gb_per_s",
                "kernel_hbm_share", "peak_hbm_bytes_per_s_assumed")
SERVING_SESSIONS, SERVING_QUERIES = 4, 6
# bench_serving's QUERY_MIX (its module is imported where it runs)
SERVING_MIX = ("q1", "q3", "q5", "q12", "q16", "q18")


def bench_in_process(data_dir: str, numpy_q1) -> tuple:
    """(a): the bench at SF1 in this process, under ``KernelCallCheck``;
    returns (its line, launches during the run)."""
    from ballista_tpu_torch import bench
    from ballista_tpu_torch.compile import governor
    from ballista_tpu_torch.kernels import dense_sums as ds

    governor().clear()  # every program captured anew, observed
    result = {}
    t0 = time.perf_counter()
    with KernelCallCheck() as check:
        torch.cuda.synchronize()
        ds.launch_count = 0
        q1 = bench.run_bench(data_dir, 3, torch.device("cuda"), result,
                             scale=SCALE, trace=False)
        torch.cuda.synchronize()
        launches = ds.launch_count
    secs = time.perf_counter() - t0
    check.check("bench (in process)")
    assert_equal_results("bench q1 vs numpy", q1, numpy_q1)
    missing = [k for k in BENCH_FIELDS if k not in result]
    missing += [f"stages.{k}" for k in STAGE_FIELDS
                if k not in result.get("stages", {})]
    if missing or "partial" in result:
        raise AssertionError(f"bench line lacks {missing}: {result}")
    if not result["value"] > 0 or result["device"] != \
            torch.cuda.get_device_name(0):
        raise AssertionError(f"bench line: value {result['value']}, "
                             f"device {result['device']}")
    if result["kernel_launches_per_warm_q1"] < 2 or launches < 2:
        raise AssertionError(
            f"bench: {result['kernel_launches_per_warm_q1']} launches in a "
            f"warm q1, {launches} in the run")
    log(f"# bench line (SF1, 3 runs, {secs:.1f} s, {launches} kernel "
        f"launches): {json.dumps(result)}")
    return result, launches


def q1_trace_child(data_dir: str) -> int:
    """Run in a fresh process (``--q1-trace``): the bench's q1 partial
    program with nothing watching its kernel calls, its replay timed and
    one replay under ``torch.profiler`` split into the dense kernel, the
    other kernels, memcpy and memset (``bench.replay_trace``), printed
    as one ``Q1_TRACE`` JSON line."""
    from ballista_tpu_torch import bench

    stages = bench.instrument_q1(data_dir, 3, torch.device("cuda"),
                                 trace=True)
    print("Q1_TRACE " + json.dumps(stages), flush=True)
    return 0


def q1_replay_trace(data_dir: str) -> dict:
    """``q1_trace_child`` in a process of its own: in this long process,
    after the earlier phases' profiler windows, the profiler recorded
    only part of a replay's kernels (0.24 of 1.11 busy ms)."""
    proc = subprocess.run([sys.executable, __file__, "--q1-trace", data_dir],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"q1 trace child failed ({proc.returncode}):"
                             f"\n{proc.stderr[-2000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("Q1_TRACE "))
    stages = json.loads(line[len("Q1_TRACE "):])
    tr = stages["kernel_trace"]
    if not tr["dense_grouped_sums_ms"] > 0:
        raise AssertionError(f"q1 replay trace shows no dense_grouped_sums "
                             f"kernel: {tr}")
    log(f"# q1 partial program, one replay traced (SF1, own process): "
        f"kernel_s {stages['kernel_s']}, {json.dumps(tr)}")
    return {"kernel_s": stages["kernel_s"],
            "kernel_bytes_accessed": stages["kernel_bytes_accessed"],
            **{k: v for k, v in tr.items() if k != "top_other_kernels"}}


def bench_cli() -> dict:
    """(b): ``python -m ballista_tpu_torch.bench --scale 0.05 --runs 1``
    as a child process; its last line must parse and name the card."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ballista_tpu_torch.bench", "--scale",
         f"{SMALL_SCALE:g}", "--runs", "1", "--data",
         os.path.join("bench_data", "bench_cli")],
        capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench CLI exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if line.get("device") != torch.cuda.get_device_name(0) or \
            "partial" in line or not line.get("value", 0) > 0:
        raise AssertionError(f"bench CLI line: {line}")
    log(f"# bench CLI (SF{SMALL_SCALE:g}, 1 run, {secs:.1f} s with the "
        f"process): {json.dumps(line)}")
    return {"seconds": secs, "value": line["value"],
            "warm_seconds": line["warm_seconds"]}


def tpch_cli(data_dir: str, small_dir: str, numpy_q1, cpu_q5,
             small_q1) -> dict:
    """(c): the TPC-H CLI's ``benchmark``: q1 and q5 at SF1 standalone,
    q1 at SF0.05 through ``--host``/``--port``, under ``KernelCallCheck``
    (the cluster's executors run in this process). Returns (the walls,
    kernel launches in the leg)."""
    from ballista_tpu_torch.benchmarks import tpch
    from ballista_tpu_torch.distributed.executor import LocalCluster
    from ballista_tpu_torch.kernels import dense_sums as ds

    out = {}
    with KernelCallCheck() as check:
        torch.cuda.synchronize()
        ds.launch_count = 0
        for q, want in (("1", numpy_q1), ("5", cpu_q5)):
            args = tpch.build_parser().parse_args(
                ["benchmark", "--path", data_dir, "--query", q,
                 "--iterations", "2"])
            ms, got = tpch.run_benchmark(args)
            assert_equal_results(f"tpch CLI q{q}", got, want)
            out[f"q{q}_ms"] = ms
        cluster = LocalCluster(num_executors=2, concurrent_tasks=2)
        try:
            args = tpch.build_parser().parse_args(
                ["benchmark", "--path", small_dir, "--query", "1",
                 "--iterations", "2", "--host", "localhost", "--port",
                 str(cluster.port)])
            ms, got = tpch.run_benchmark(args)
        finally:
            cluster.shutdown()
        torch.cuda.synchronize()
        launches = ds.launch_count
    check.check("tpch CLI")
    assert_close_results("tpch CLI q1 remote", got, small_q1)
    out["remote_q1_ms"] = ms
    out["launches"] = launches
    log(f"# tpch CLI: {json.dumps(out)} (ms a run)")
    return out, launches


def serving_phases(small_dir: str, small_want) -> tuple:
    """(d): ``bench_serving``'s three phases on the card, under
    ``KernelCallCheck`` (the clusters' executors run in this process);
    every query result of the serving and autoscale phases is held
    against phase 12's standalone result of that query at SF0.05.
    Returns (the row, kernel launches in the leg)."""
    from ballista_tpu_torch import bench_serving
    from ballista_tpu_torch.kernels import dense_sums as ds

    out, results = {}, []
    lock = threading.Lock()

    def keep(q, rows):
        with lock:
            results.append((q, rows))

    with KernelCallCheck() as check:
        torch.cuda.synchronize()
        ds.launch_count = 0
        for phase in ("serving", "restart", "autoscale"):
            t0 = time.perf_counter()
            line = bench_serving.run_phase(
                phase, small_dir, torch.device("cuda"),
                sessions=SERVING_SESSIONS,
                queries_per_session=SERVING_QUERIES, on_result=keep)
            secs = time.perf_counter() - t0
            log(f"# bench_serving {phase} ({secs:.1f} s): "
                f"{json.dumps(line)}")
            out[phase] = line
        torch.cuda.synchronize()
        launches = ds.launch_count
    check.check("bench_serving")
    for i, (q, rows) in enumerate(results):
        assert_close_results(f"bench_serving result {i} ({q}) vs phase "
                             f"12", rows, small_want[q])
    s, r, a = out["serving"], out["restart"], out["autoscale"]
    # the storm's and the burst's queries and both warm passes
    expect = (s["serving_completed"] + a["autoscale_completed"]
              + 2 * len(bench_serving.QUERY_MIX))
    if len(results) != expect:
        raise AssertionError(f"bench_serving: {len(results)} results "
                             f"compared, {expect} queries completed")
    log(f"# bench_serving: all {len(results)} query results == phase 12's "
        f"standalone results; {launches} kernel launches")
    if s["serving_errors"] != 0 or s["serving_completed"] == 0:
        raise AssertionError(f"serving: {s.get('serving_error_sample')}")
    if r["recovered_jobs"] < 1 or r["recovery_errors"] != 0:
        raise AssertionError(f"restart recovered no job: {r}")
    if a["autoscale_events"] < 1 or a["autoscale_errors"] != 0:
        raise AssertionError(f"autoscale: {a}")
    return {"serving_qps": s["value"],
            "serving_p50_seconds": s["serving_p50_seconds"],
            "serving_p99_seconds": s["serving_p99_seconds"],
            "serving_completed": s["serving_completed"],
            "recovery_seconds": r["recovery_seconds"],
            "recovered_jobs": r["recovered_jobs"],
            "autoscale_events": a["autoscale_events"],
            "autoscale_p99_seconds": a["autoscale_p99_seconds"],
            "results_compared": len(results),
            "launches": launches}, launches


def scaling_curves() -> tuple:
    """(e): the slot curves over 1/2/4 slots under ``KernelCallCheck``
    (``mesh_agg_dict``'s partial and final sums are the kernel; every
    point is held against numpy in ``run_curves``). Returns (the curves'
    walls, kernel launches in the leg)."""
    from ballista_tpu_torch.benchmarks import scaling
    from ballista_tpu_torch.kernels import dense_sums as ds

    t0 = time.perf_counter()
    with KernelCallCheck() as check:
        torch.cuda.synchronize()
        ds.launch_count = 0
        curves = scaling.run_curves([1, 2, 4], 262_144, 1_048_576, 3,
                                    torch.device("cuda"))
        torch.cuda.synchronize()
        launches = ds.launch_count
    check.check("scaling")
    log(f"# scaling on the card ({time.perf_counter() - t0:.1f} s, "
        f"{launches} kernel launches; every point == numpy): "
        f"{json.dumps(curves)}")
    return {k: [(p["n_devices"], p["warm_s"], p["efficiency"]) for p in v]
            for k, v in curves["curves"].items()}, launches


def phase_entry_points(data_dir: str, small_dir: str, numpy_q1, cpu_q5,
                       small_q1, small_want) -> tuple:
    """Phase 18: the port's measurement entry points on the card. Each
    leg that runs queries in this process runs under ``KernelCallCheck``
    with the launch count set to 0 just before it; ``small_want`` holds
    phase 12's standalone SF0.05 results of the serving mix."""
    from ballista_tpu_torch.cache import residency
    from ballista_tpu_torch.compile import governor

    t_phase = time.perf_counter()
    line, launches = bench_in_process(data_dir, numpy_q1)
    row = {"bench": line, "q1_replay_trace": q1_replay_trace(data_dir),
           "bench_cli": bench_cli()}
    row["tpch_cli"], tpch_launches = tpch_cli(data_dir, small_dir,
                                              numpy_q1, cpu_q5, small_q1)
    row["serving"], serving_launches = serving_phases(small_dir, small_want)
    residency.reset()
    governor().clear()
    row["scaling"], scaling_launches = scaling_curves()
    row["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 18 (entry points) took {row['seconds']:.1f} s")
    return row, {"bench": launches,
                 "bench_q1": line["kernel_launches_per_warm_q1"],
                 "tpch_cli": tpch_launches, "serving": serving_launches,
                 "scaling": scaling_launches}


# -- main -------------------------------------------------------------------


def capture_failure_check() -> None:
    """A governed program that reads a device value back to the host
    cannot be captured: the governor must raise ``CaptureError`` and not
    run the program eagerly instead."""
    from ballista_tpu_torch.compile import governed
    from ballista_tpu_torch.compile.governor import CaptureError

    fn = governed(("sort.run", "chip_smoke.capture_failure"),
                  lambda: (lambda x: x[: int(x.sum())]))
    try:
        fn(torch.arange(4, device="cuda"))
    except CaptureError as e:
        log(f"# capture failure raised CaptureError: {str(e)[:160]}")
        return
    raise AssertionError("a program that cannot be captured ran eagerly")


def phase_capture_failure() -> None:
    """``capture_failure_check`` in a process of its own, so that the
    failed capture leaves nothing behind in this one."""
    proc = subprocess.run([sys.executable, __file__,
                           "--capture-failure-check"],
                          capture_output=True, text=True, timeout=300)
    for line in proc.stdout.splitlines():
        log(line)
    if proc.returncode != 0:
        raise AssertionError(f"capture-failure check failed "
                             f"({proc.returncode}):\n{proc.stderr[-2000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm collect of q1, q3 and q5")
    ap.add_argument("--capture-failure-check", action="store_true",
                    help="only check that a capture failure raises")
    ap.add_argument("--first-collect", metavar="DATA_DIR",
                    help="only run phase 15's first collects of q1 (in the "
                         "fresh process phase 15 starts)")
    ap.add_argument("--prewarm-child", metavar="DATA_DIR",
                    help="only run phase 16's first q1 and q6 (in the "
                         "fresh processes phase 16 starts)")
    ap.add_argument("--q1-trace", metavar="DATA_DIR",
                    help="only trace one replay of the bench's q1 program "
                         "(in the fresh process phase 18 starts)")
    args = ap.parse_args()
    card_id = use_one_card()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.capture_failure_check:
        capture_failure_check()
        return 0
    if args.first_collect:
        return first_collect_child(args.first_collect)
    if args.prewarm_child:
        return prewarm_child(args.prewarm_child)
    if args.q1_trace:
        return q1_trace_child(args.q1_trace)
    t_start = time.perf_counter()
    card = phase_card(card_id)
    phase_build()
    data_dir = setup_data()
    small_dir = setup_data(SMALL_SCALE, num_parts=2)
    q1_shape = phase_kernel_check(lineitem_rows(data_dir))
    timings, launches, shapes, main_path, numpy_q1 = phase_queries(data_dir)
    if main_path["n"] != q1_shape["n"]:
        raise AssertionError(f"phase 3 timed N={q1_shape['n']} but q1's "
                             f"partial aggregate ran at N={main_path['n']}")
    log(f"# main-path kernel shapes (N, K, G): {shapes}")
    join_timings, q5_launches, q5_main, q5_shapes = phase_joins(data_dir)
    timings.update(join_timings)
    log(f"# q5 kernel shapes (N, K, G): {q5_shapes}")
    fusion_rows, cpu_results = phase_fusion(data_dir)
    ingest_rows, capture_check = phase_ingest(data_dir, cpu_results)
    adaptive_rows, adaptive_q5_launches = phase_adaptive(data_dir,
                                                         cpu_results)
    streaming_rows, streamed_q1_launches = phase_streaming(
        data_dir, cpu_results["q1"])
    float_errs = phase_float_sf1(data_dir)
    phase_hash_ids(data_dir)
    small_secs, small_results = phase_all_queries(small_dir)
    parquet_row, parquet_launches = phase_parquet(
        data_dir, setup_parquet(data_dir), cpu_results)
    cluster_row, cluster_launches, unfused = phase_cluster(
        data_dir, small_dir, small_results)
    small_want = {q: small_results[q] for q in SUBQUERY_QUERIES}
    small_q1 = small_results["q1"]
    serving_want = {q: small_results[q] for q in SERVING_MIX}
    del small_results
    observability_row, observability_launches = phase_observability(
        card, data_dir, cpu_results["q1"])
    subquery_row, subquery_launches = phase_subqueries_prewarm_aot(
        card, data_dir, small_dir, small_want, cpu_results["q1"])
    mesh_row, mesh_launches = phase_mesh(card, data_dir, small_dir, unfused,
                                         small_q1)
    entry_row, entry_launches = phase_entry_points(
        data_dir, small_dir, numpy_q1, cpu_results["q5"], small_q1,
        serving_want)
    phase_capture_failure()
    if args.profile:
        for q in ("q1", "q3", "q5"):
            profile_query(data_dir, q)
    log(f"# timings: {json.dumps(timings)}")
    log(f"# fusion: {json.dumps(fusion_rows)}")
    log(f"# ingest: {json.dumps(ingest_rows)}")
    log(f"# upload under capture: {json.dumps(capture_check)}")
    log(f"# adaptive: {json.dumps(adaptive_rows)}")
    log(f"# streaming: {json.dumps(streaming_rows)}")
    log(f"# float sf1 largest relative errors: {json.dumps(float_errs)}")
    log(f"# sf{SMALL_SCALE:g} seconds on the card: {json.dumps(small_secs)}")
    log(f"# parquet: {json.dumps(parquet_row)}")
    log(f"# cluster: {json.dumps(cluster_row)}")
    log(f"# observability: {json.dumps(observability_row)}")
    log(f"# subqueries, prewarm, AOT: {json.dumps(subquery_row)}")
    log(f"# mesh: {json.dumps(mesh_row)}")
    log(f"# entry points: {json.dumps(entry_row)}")
    kernels = [{
        "name": "dense_grouped_sums",
        "route": "cuda",
        "source": "ballista_tpu_torch/csrc/dense_grouped_sums.cu",
        "replaces": "ballista_tpu/kernels/pallas_agg.py:78",
        "launches": launches[0],
        "matched": True,
        "max_abs_err": main_path["max_abs_err"],
        "ms": main_path["ms"],
        "call_ms": main_path["call_ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": main_path["library_ms"],
        "first_row_ms": main_path["first_row_ms"],
        "replicas": main_path["replicas"],
        "vec": main_path["vec"],
        "shape": {"n": main_path["n"], "k": main_path["k"],
                  "g": main_path["g"]},
        "even_groups_ms": q1_shape["ms"],
        "vec1_ms": main_path["vec1_ms"],
        "graph_ms": main_path["graph_ms"],
        "graph_call_ms": main_path["graph_call_ms"],
        "q5_launches": q5_launches[0],
        "adaptive_q5_launches": adaptive_q5_launches,
        "streamed_q1_launches": streamed_q1_launches,
        "parquet_q1_launches": parquet_launches[("q1", "cold")],
        "parquet_q5_launches": parquet_launches[("q5", "cold")],
        "cluster_q1_launches": cluster_launches[("q1", "first")],
        "cluster_q5_launches": cluster_launches[("q5", "first")],
        "explain_analyze_q1_launches": observability_launches["explain_q1"],
        "explain_analyze_q5_launches": observability_launches["explain_q5"],
        "cluster_explain_analyze_q1_launches":
            observability_launches["cluster_explain_q1"],
        "flight_q1_launches": observability_launches["flight_q1"],
        "prewarm_q1_launches": subquery_launches["prewarm_q1"],
        "server_subquery_launches": subquery_launches["server_subquery"],
        "mesh_q1_launches": mesh_launches["first"],
        "mesh_q1_final_launches": MESH_SLOTS,
        "bench_launches": entry_launches["bench"],
        "bench_q1_launches": entry_launches["bench_q1"],
        "tpch_cli_launches": entry_launches["tpch_cli"],
        "serving_launches": entry_launches["serving"],
        "scaling_launches": entry_launches["scaling"],
        "q5_ms": q5_main["ms"],
        "q5_call_ms": q5_main["call_ms"],
        "q5_plain_ms": q5_main["plain_ms"],
        "q5_bound_ms": q5_main["bound_ms"],
        "q5_library_ms": q5_main["library_ms"],
        "q5_shape": {"n": q5_main["n"], "k": q5_main["k"],
                     "g": q5_main["g"]},
    }]
    log(f"# card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
