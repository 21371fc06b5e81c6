"""One run of one benchmark cell, driven by data.

``BENCHMARK.json`` names the cell's configuration and traffic mix; the
harness reads ``configs/<config>.json`` and ``traffic/<traffic>.json``,
the queries of the mix from ``queries/<q>.sql`` and their reference from
``reference/<q>.py``, and each metric the cell reports from
``metrics/<metric>.py``. Adding a configuration, a mix, a query or a
metric adds files and edits none.

A run: generate the data from the seed; start the deployment; warm the
mix's queries; run the closed-loop sessions for the window; read the
counters, the ledgers, the memory peak and (traced) the profile; stop
the deployment; hold every answer of the window to the reference; read
the metrics.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from . import check, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORK_DIR = ".qbench"  # the checkout's generated data and program caches


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    metrics: List[dict]


def cell(name: str, traced: bool, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with the metrics it
    reports in a run with or without the trace."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if not matches:
        raise SystemExit(f"qbench: no workload {name!r} in BENCHMARK.json")
    w = matches[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    listed = bench["per_layer"] if traced else bench["end_to_end"]
    metrics = [m for m in listed if name in m.get("workloads", [name])]
    return Cell(w, config, traffic, metrics)


def environment(c: Cell, work: str) -> Dict[str, str]:
    """The process environment a cell runs under: the program's build
    and kernel caches at fixed paths inside the checkout, a ledger log
    that holds every query of a window, and the knobs the configuration
    states."""
    env = {
        "TORCH_EXTENSIONS_DIR": os.path.join(work, "torch_extensions"),
        "TRITON_CACHE_DIR": os.path.join(work, "triton"),
        "CUDA_CACHE_PATH": os.path.join(work, "nv_compute_cache"),
        "BALLISTA_LEDGER_LOG": "1000000",
    }
    env.update(c.config.get("env", {}))
    return env


@dataclass
class Query:
    name: str
    session: int
    start: float
    end: float
    answer: Optional[dict] = None
    error: Optional[str] = None


@dataclass
class Run:
    """What a run leaves for the metric readers (``metrics/<name>.py``)."""

    cell: Cell
    device_kind: str
    setup_s: float
    window_start: float
    window_end: float
    queries: List[Query]
    counters_before: dict
    counters_after: dict
    ledgers: List[dict]
    table_rows: Dict[str, int]
    spans: List[trace.Span] = field(default_factory=list)
    profile: Optional[trace.Profile] = None

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start

    def completed(self) -> List[Query]:
        return [q for q in self.queries if q.error is None]

    def delta(self, key: str) -> float:
        return float(self.counters_after[key]) - float(
            self.counters_before[key])


def counters() -> dict:
    """The port's process counters the per-layer metrics read."""
    from ballista_tpu_torch.cache import cache_counters
    from ballista_tpu_torch.compile.governor import compile_stats
    from ballista_tpu_torch.ingest.phases import phase_totals

    out = {}
    st = compile_stats()
    out["graph_captures"] = st["graph_captures"]
    out["graph_replays"] = st["graph_replays"]
    out.update(cache_counters())
    for k, v in phase_totals().items():
        out[f"ingest_{k}_s"] = v
    from ballista_tpu_torch.observability.progress import (
        process_session_meter)

    out["shuffle_bytes"] = sum(int(r.get("bytes_shuffled", 0))
                               for r in process_session_meter().rows())
    return out


def card_line() -> str:
    """The card as ``nvidia-smi`` names it, with its power limit (a card
    may be set below its 700 W, and then runs slower under load)."""
    import subprocess

    import torch

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = visible.split(",")[0].strip() if visible else "0"
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def default_collect(ctx, text: str, span: Callable) -> dict:
    """The entry the window drives: the query's text to rows on the host."""
    with span("sql"):
        df = ctx.sql(text)
    with span("to_pydict"):
        return df.to_pydict()


def query_texts(mix) -> Dict[str, str]:
    out = {}
    for q in mix:
        with open(os.path.join(HERE, "queries", f"{q}.sql")) as f:
            out[q] = f.read()
    return out


def session_rounds(seed: int, session: int, mix):
    """A session's queries: rounds of the whole mix, each in an order
    drawn from the seed, so every seed sends the same work."""
    rng = np.random.default_rng([seed % 2**63, session])
    while True:
        yield [mix[i] for i in rng.permutation(len(mix))]


def load_metric(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"qbench.metrics.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", scale: Optional[float] = None,
             collect: Callable = default_collect, root: str = ROOT,
             t0: Optional[float] = None, log: Callable = None) -> dict:
    """One run of cell ``name``; returns the result line as a dict.

    ``scale`` replaces the configuration's scale factor (the CPU
    rehearsal); ``collect(ctx, text, span)`` is the entry the window
    drives (the tests break it underneath)."""
    t0 = time.perf_counter() if t0 is None else t0
    c = cell(name, traced, root)
    work = os.path.join(root, WORK_DIR)
    os.environ.update(environment(c, work))
    import torch

    from .data import generate
    from .reference import Num, load as load_reference

    scale = c.config["scale_factor"] if scale is None else scale
    mix = list(c.traffic["mix"])
    texts = query_texts(mix)
    diag: dict = {}

    # -- set-up: data, deployment, warm-up ----------------------------------
    t = time.perf_counter()
    data_dir = os.path.join(work, "data", f"sf{scale:g}")
    # NumPy seeds are non-negative; a whole number of any sign maps onto one
    tables, wrote = generate.ensure_data(data_dir, scale, seed % 2**64,
                                         c.config["tables"])
    diag["data_s"] = time.perf_counter() - t
    diag["data_written"] = wrote
    table_rows = {k: len(next(iter(v.values()))) for k, v in tables.items()}

    from . import deploy

    t = time.perf_counter()
    dep = deploy.start(c.config, device, data_dir)
    diag["start_s"] = time.perf_counter() - t
    spans = trace.Spans()

    def one(ctx, q: str, session: int) -> Query:
        def span(part):
            return spans.span(f"{q}.{part}", session)

        start = time.perf_counter()
        try:
            with spans.span(q, session):
                answer = collect(ctx, texts[q], span)
                dep.sync()
        except Exception as e:  # noqa: BLE001 - counted as failed
            return Query(q, session, start, time.perf_counter(),
                         error=f"{type(e).__name__}: {e}")
        return Query(q, session, start, time.perf_counter(), answer=answer)

    t = time.perf_counter()
    warm_ctx = dep.session(-1)
    for _ in range(int(c.traffic.get("warm_rounds", 1))):
        for q in sorted(mix):
            got = one(warm_ctx, q, -1)
            if got.error is not None:
                raise RuntimeError(f"warm-up {q}: {got.error}")
    n_sessions = int(c.traffic["sessions"])
    ctxs = [dep.session(i) for i in range(n_sessions)]
    dep.sync()
    # the set-up's objects live through the window: kept out of the
    # collector's full passes, which otherwise stop a query for ~150 ms
    gc.collect()
    gc.freeze()
    diag["warm_s"] = time.perf_counter() - t

    # -- the window -----------------------------------------------------------
    profiler = trace.Profiler() if traced else None
    if profiler is not None:
        profiler.start()
    before = counters()
    stop_at_round = c.traffic.get("stop", "query") == "round"
    records: List[List[Query]] = [[] for _ in range(n_sessions)]
    go = threading.Barrier(n_sessions + 1)

    def session_loop(i: int):
        go.wait()
        for order in session_rounds(seed, i, mix):
            for k, q in enumerate(order):
                if time.perf_counter() >= deadline and (
                        not stop_at_round or k == 0):
                    return
                records[i].append(one(ctxs[i], q, i))

    threads = [threading.Thread(target=session_loop, args=(i,),
                                name=f"qbench-session-{i}")
               for i in range(n_sessions)]
    for th in threads:
        th.start()
    window_start = time.perf_counter()
    window_epoch = time.time()
    cpu_start = time.process_time()
    deadline = window_start + seconds
    setup_s = window_start - t0
    if profiler is not None:
        profiler.mark_start()
    go.wait()
    if profiler is not None:
        slice_end = window_start + float(c.traffic.get("trace_seconds", 5))
        for th in threads:
            th.join(max(0.0, slice_end - time.perf_counter()))
        profiler.stop()
    for th in threads:
        th.join()
    queries = sorted((q for r in records for q in r), key=lambda q: q.start)
    window_end = max([q.end for q in queries] + [window_start])
    diag["window_cpu_s"] = time.process_time() - cpu_start
    after = counters()
    diag["window_shuffle_bytes"] = (after["shuffle_bytes"]
                                    - before["shuffle_bytes"])
    from ballista_tpu_torch.observability.ledger import process_ledger_log

    ledgers = [e for e in process_ledger_log().entries(since=window_epoch)
               if e.get("origin") == dep.origin
               and e.get("status") == "completed"]
    if device == "cuda":
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
        diag["card"] = card_line()
    else:
        peak, kind = 0, "cpu"
    profile = profiler.read() if profiler is not None else None
    diag["table_cache_resident_bytes"] = after.get(
        "table_cache_resident_bytes")

    # -- the program's state goes; the reference holds every answer --------
    dep.close()
    del dep, ctxs, warm_ctx
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    wrong, gap, reasons = 0, 0.0, []
    expected = {}
    for q in mix:
        mod = load_reference(q)
        expected[q] = check.Expected(mod, mod.compute(tables, Num(True)))
    for rec in queries:
        if rec.error is not None:
            continue
        why, g = expected[rec.name].hold(rec.answer)
        gap = max(gap, g)
        if why is not None:
            wrong += 1
            if len(reasons) < 3:
                reasons.append(f"{rec.name}: {why}")
    diag["reference_s"] = time.perf_counter() - t
    failed = [q for q in queries if q.error is not None]
    limits = c.config["limits"]
    checks = {
        "answers_wrong": {"value": wrong, "limit": limits["answers_wrong"]},
        "answers_failed": {"value": len(failed),
                           "limit": limits["answers_failed"]},
        "decimal_gap_ulp": {"value": gap,
                            "limit": limits["decimal_gap_ulp"]},
    }
    correct = bool(queries) and all(v["value"] <= v["limit"]
                                    for v in checks.values())
    diag["queries"] = {q: sum(1 for r in queries if r.name == q) for q in mix}
    diag["median_s"] = {q: float(np.median([r.end - r.start for r in queries
                                            if r.name == q] or [0.0]))
                        for q in mix}
    diag["reasons"] = reasons + [f"{q.name}: {q.error}" for q in failed[:3]]

    # -- metrics --------------------------------------------------------------
    run = Run(c, kind, setup_s, window_start, window_end, queries, before,
              after, ledgers, table_rows, spans.items, profile)
    metrics = {}
    for m in c.metrics:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(queries),
           "failed": len(failed), "metrics": metrics,
           "device": {"platform": "gpu" if device == "cuda" else "cpu",
                      "kind": kind, "count": int(c.workload["chips"]),
                      "memory_peak_bytes": peak}}
    if profile is not None and profile.device:
        out["device"]["busy_s"] = trace.covered_ns(
            profile.device_intervals(), profile.start_ns,
            profile.end_ns) / 1e9
        out["device"]["window_s"] = profile.seconds
    if profile is not None:
        out["breakdown"] = {
            "device_ops": trace.top_device_ops(profile),
            "idle_gaps": trace.idle_gaps(profile, spans.items)}
    out["checks"] = checks
    if log is not None:
        log(json.dumps({"qbench_diagnostics": diag}, default=str))
    return out
