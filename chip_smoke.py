"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA card, ``nvcc`` and ``g++``; it imports torch, numpy and the port
(``ballista_tpu_torch``), never jax or the JAX package, and needs no
pandas. Phases, in order (any failure is an uncaught exception and a
non-zero exit):

1. card: the name and power limit as nvidia-smi reports them;
2. build: the CUDA kernel (nvcc, sm_90a) and the native scanner (g++)
   from the checkout's sources, both compilers started together;
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
   physical plan is printed; q3's must hold a co-partitioned
   ``JoinExec`` over two ``RepartitionExec``s; the kernel's launch count
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
7. hash partition ids on the card: ``hash_partition_ids`` on full-range
   int64 keys and on SF1 ``l_orderkey``, and ``compute_partition_ids`` on
   ``l_orderkey``, on the utf8 ``l_shipmode`` and on both, for P = 8 and
   P = 7, each equal to the ids the CPU computes, bit for bit;
8. all 22 TPC-H queries at SF0.05 (two files a table, in
   ``bench_data/sf0.05``), fused, on the card and through the port on
   the CPU: integer, decimal, date and string columns equal exactly,
   float columns within rtol 1e-6;
9. in a process of its own, a governed program that cannot be captured
   (it reads a device value on the host) must raise ``CaptureError``
   rather than run eagerly;
10. the kernel list, as one JSON line; its times, replicas and VEC are
    those on q1's main-path inputs, with q5's launches and times beside
    them.

It uses one card: the first that ``CUDA_VISIBLE_DEVICES`` lists, else
card 0. The last line of standard output is ``{"ok": true, "device":
{...}}``. Option: ``--profile`` (one more warm collect each of q1, q3 and
q5 under ``torch.profiler``: device time by kernel, the share of the wall
time the card was busy, and the operators' metrics).
"""

from __future__ import annotations

import argparse
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
                                                  native.build))]
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
    return timings, launches, sorted(set(spy_shapes)), main_path


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
    from ballista_tpu_torch.kernels import dense_sums as ds
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
            copart = [j for j in find_nodes(plan, JoinExec)
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
    device-busy ms, kernels the card ran, host-side launches by kind)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.to_pydict()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, kernels, host = 0.0, 0, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.self_device_time_total > 0:
                busy += e.self_device_time_total / 1e3
                if not e.key.startswith(("Memcpy", "Memset")):
                    kernels += e.count
        elif e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cudaGraphLaunch",
                       "cudaMemcpyAsync", "cudaMemsetAsync"):
            host[e.key] = host.get(e.key, 0) + e.count
    return wall, busy, kernels, host


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
                 row["device_kernels"], row["host_launches"]) = \
                    profile_warm(df)
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
    return rows


# -- phase 7 ----------------------------------------------------------------


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


# -- phase 8 ----------------------------------------------------------------


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
    secs = {}
    for q in QUERIES:
        sql = open(os.path.join(QUERY_DIR, f"{q}.sql")).read()
        t0 = time.perf_counter()
        got = gpu.sql(sql).to_pydict()
        torch.cuda.synchronize()
        secs[q] = time.perf_counter() - t0
        assert_close_results(f"{q} sf{SMALL_SCALE:g} cuda vs cpu", got,
                             cpu.sql(sql).to_pydict())
        log(f"# {q} sf{SMALL_SCALE:g}: cuda == port on cpu "
            f"({len(next(iter(got.values())))} rows, {secs[q]:.3f} s "
            f"on the card, cold)")
    return secs


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
    args = ap.parse_args()
    card_id = use_one_card()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.capture_failure_check:
        capture_failure_check()
        return 0
    t_start = time.perf_counter()
    card = phase_card(card_id)
    phase_build()
    data_dir = setup_data()
    small_dir = setup_data(SMALL_SCALE, num_parts=2)
    q1_shape = phase_kernel_check(lineitem_rows(data_dir))
    timings, launches, shapes, main_path = phase_queries(data_dir)
    if main_path["n"] != q1_shape["n"]:
        raise AssertionError(f"phase 3 timed N={q1_shape['n']} but q1's "
                             f"partial aggregate ran at N={main_path['n']}")
    log(f"# main-path kernel shapes (N, K, G): {shapes}")
    join_timings, q5_launches, q5_main, q5_shapes = phase_joins(data_dir)
    timings.update(join_timings)
    log(f"# q5 kernel shapes (N, K, G): {q5_shapes}")
    fusion_rows = phase_fusion(data_dir)
    phase_hash_ids(data_dir)
    small_secs = phase_all_queries(small_dir)
    phase_capture_failure()
    if args.profile:
        for q in ("q1", "q3", "q5"):
            profile_query(data_dir, q)
    log(f"# timings: {json.dumps(timings)}")
    log(f"# fusion: {json.dumps(fusion_rows)}")
    log(f"# sf{SMALL_SCALE:g} seconds on the card: {json.dumps(small_secs)}")
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
