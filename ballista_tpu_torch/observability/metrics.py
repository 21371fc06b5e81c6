"""Lock-cheap per-operator metrics: the port of the JAX package's
``observability/metrics.py``.

Design constraints (why this doesn't look like a classic metrics
registry):

- **No device syncs on the hot path.** ``batch.num_rows`` is a device
  scalar; blocking on it per batch would serialize host against device
  (the engine spends real effort avoiding exactly that — see
  physical/base.py's deferred-sync compaction). ``record_output_batch``
  therefore only APPENDS the scalar (with a ``torch.cuda.Event``
  recorded behind it on a card); ``values()`` resolves all pending
  scalars in one stacked device-to-host copy at read time, when the
  query is done and the transfer is effectively free.
- **The live sampler never syncs.** ``snapshot_rows`` runs on the
  executor's poll thread while task threads replay or capture CUDA
  graphs. It counts only scalars whose event reports done, reads them
  through an asynchronous copy into pinned host memory that a later
  sample picks up once its own event reports done, and never calls
  ``.cpu()`` or ``.item()`` on a card tensor (``_PendingCount``).
- **No locks.** Counters are plain Python ints mutated under the GIL.
  Partitions of one operator instance may run on different executor
  worker threads; a lost increment under that interleaving skews a
  heuristic display value, never correctness — same benign-race policy
  as the adaptive compaction counters in physical/base.py.
- **Zero per-operator boilerplate.** ``PhysicalPlan.__init_subclass__``
  wraps every ``execute`` override with :func:`instrument_execute`, so
  every operator (including future ones) records ``output_rows``,
  ``output_batches`` and ``elapsed_compute`` without touching its code.

``elapsed_compute`` is CUMULATIVE wall time spent inside the operator's
generator, children included (fused pipeline chains attribute the whole
chain to the outermost op). Self-time is derived at display time as
``own - sum(children)`` — see :func:`collect_plan_metrics`.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Dict, Iterable, List, Optional

import torch

# -- global enablement -------------------------------------------------------

# metrics default ON: the per-batch cost is two perf_counter() calls and
# a list append (gated < 5% on q1 by tests/test_observability.py).
# BALLISTA_METRICS=0 turns collection off; EXPLAIN ANALYZE forces it back
# on dynamically for the plans it executes.
_DISABLED = os.environ.get("BALLISTA_METRICS", "1").lower() in (
    "0", "off", "false")
_FORCED = 0  # EXPLAIN ANALYZE nesting depth (benign race across threads)


def metrics_enabled() -> bool:
    return _FORCED > 0 or not _DISABLED


def reconfigure() -> None:
    """Re-read BALLISTA_METRICS (tests flip the env mid-process)."""
    global _DISABLED
    _DISABLED = os.environ.get("BALLISTA_METRICS", "1").lower() in (
        "0", "off", "false")


class force_metrics:
    """Context manager: collect metrics even when globally disabled
    (EXPLAIN ANALYZE must always measure the plan it executes)."""

    def __enter__(self):
        global _FORCED
        _FORCED += 1
        return self

    def __exit__(self, *exc):
        global _FORCED
        _FORCED -= 1
        return False


# -- MetricsSet ---------------------------------------------------------------


class MetricsSet:
    """Per-operator metric store: counters (ints), timers (seconds),
    gauges (last/max value), plus a pending list of device row-count
    scalars resolved lazily at read time."""

    __slots__ = ("_counters", "_timers", "_gauges", "_pending_rows",
                 "_rows_floor")

    def __init__(self):
        self._counters: Dict[str, int] = {}
        self._timers: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._pending_rows: List = []
        self._rows_floor = 0

    # recording (hot path) --------------------------------------------------

    def add_counter(self, name: str, value: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + value

    def add_time(self, name: str, secs: float) -> None:
        self._timers[name] = self._timers.get(name, 0.0) + secs

    def set_gauge(self, name: str, value: float) -> None:
        # always float: Python type is the kind discriminator downstream
        # (serde encodes float -> gauge oneof, int -> counter; merge
        # max-es floats and sums ints) — an integral gauge must not
        # silently turn into a summed counter on the wire
        self._gauges[name] = float(value)

    def reset(self) -> None:
        self._counters.clear()
        self._timers.clear()
        self._gauges.clear()
        self._pending_rows.clear()
        self._rows_floor = 0

    def record_output_batch(self, batch) -> None:
        """Append the batch's (device-scalar) live row count without
        syncing; bump the batch counter."""
        self._counters["output_batches"] = \
            self._counters.get("output_batches", 0) + 1
        self._pending_rows.append(_PendingCount(batch.num_rows))

    # reading ---------------------------------------------------------------

    def _resolve_rows(self) -> None:
        if not self._pending_rows:
            return
        # NOTE: a snapshot_rows() racing this window (pending swapped
        # out, sum not yet committed) computes a transiently LOW total;
        # the _rows_floor clamp there keeps the sampled value monotone
        pending, self._pending_rows = self._pending_rows, []
        self._counters["output_rows"] = (
            self._counters.get("output_rows", 0)
            + sum(_fetch_counts([p.count for p in pending]))
        )

    def snapshot_rows(self) -> int:
        """Non-destructive, non-blocking row count for the live
        progress sampler: the committed counter plus the pending
        scalars whose value is ALREADY on the host. Never waits on the
        card (``_PendingCount.peek``) and never clears the pending
        list, so ``values()`` keeps the authoritative accounting.
        Monotone by clamp: a read racing ``_resolve_rows`` (pending
        swapped out, counter not yet bumped) would compute a
        transiently low total, so the last returned value is a floor."""
        total = int(self._counters.get("output_rows", 0))
        for p in list(self._pending_rows):
            try:
                n = p.peek()
            except Exception:  # noqa: BLE001 - advisory only
                continue
            if n is not None:
                total += n
        total = max(total, self._rows_floor)
        self._rows_floor = total
        return total

    def values(self) -> Dict[str, float]:
        """Resolved snapshot: counters as ints, timers/gauges as floats.
        Timer names keep their ``elapsed_`` prefix so aggregation can
        tell the kinds apart without a side table."""
        self._resolve_rows()
        out: Dict[str, float] = dict(self._counters)
        out.update(self._timers)
        out.update(self._gauges)
        return out

    def value(self, name: str, default=None):
        return self.values().get(name, default)

    def is_empty(self) -> bool:
        return not (self._counters or self._timers or self._gauges
                    or self._pending_rows)

    def summary(self) -> str:
        """Compact ``k=v`` rendering for plan annotation (EXPLAIN
        ANALYZE), stable order: rows, batches, timers, the rest."""
        vals = self.values()
        parts = []
        for key in ("output_rows", "output_batches"):
            if key in vals:
                parts.append(f"{key}={int(vals.pop(key))}")
        for key in sorted(k for k in vals if k.startswith("elapsed_")):
            parts.append(f"{key}={_fmt_secs(vals.pop(key))}")
        for key in sorted(vals):
            v = vals[key]
            parts.append(f"{key}={int(v) if float(v).is_integer() else v}")
        return ", ".join(parts)


def _fmt_secs(secs: float) -> str:
    if secs >= 1.0:
        return f"{secs:.3f}s"
    if secs >= 0.001:
        return f"{secs * 1e3:.3f}ms"
    return f"{secs * 1e6:.1f}µs"


# -- execute() instrumentation ------------------------------------------------


def instrument_execute(fn):
    """Wrap a PhysicalPlan.execute generator so each call records
    output rows/batches and cumulative wall time on the operator's
    MetricsSet. Applied automatically by PhysicalPlan.__init_subclass__;
    idempotent via the ``_obs_wrapped`` marker."""
    if getattr(fn, "_obs_wrapped", False):
        return fn

    @functools.wraps(fn)
    def execute(self, partition: int):
        if not metrics_enabled():
            yield from fn(self, partition)
            return
        from . import memory as obs_memory

        m = self.metrics()
        it = fn(self, partition)
        perf = time.perf_counter
        host_peak = obs_memory.current_host_bytes
        dev_peak = obs_memory.device_bytes
        acc = 0.0
        try:
            while True:
                t0 = perf()
                try:
                    batch = next(it)
                except StopIteration:
                    acc += perf() - t0
                    return
                acc += perf() - t0
                m.record_output_batch(batch)
                # monotone per-operator memory high-water marks: cheap
                # reads of the process trackers (device sampling is
                # rate-limited inside device_bytes)
                g = m._gauges
                hb = host_peak()
                if hb > g.get("peak_host_bytes", 0.0):
                    g["peak_host_bytes"] = float(hb)
                db = dev_peak()
                if db > g.get("peak_device_bytes", 0.0):
                    g["peak_device_bytes"] = float(db)
                yield batch
        finally:
            # finally (not loop exit): a consumer abandoning the stream
            # early (LimitExec) must still flush accrued time
            m.add_time("elapsed_compute", acc)

    execute._obs_wrapped = True
    return execute


# -- harvesting / aggregation -------------------------------------------------


class _PendingCount:
    """One batch's live-row count, pending until read.

    ``count`` is an int, a CPU tensor or a card tensor. For a card
    tensor ``ready`` is an event recorded on the current stream right
    after the batch was produced: once it reports done the value exists
    and a copy of it waits on nothing else. ``peek`` (the sampler's
    read) then starts one asynchronous copy into pinned host memory and
    returns the value on a later call, once that copy's own event
    reports done; until then it returns None."""

    __slots__ = ("count", "ready", "host", "copied")

    def __init__(self, count):
        self.count = count
        self.ready = None
        self.host = None
        self.copied = None
        if isinstance(count, torch.Tensor) and count.is_cuda:
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(count.device))

    def peek(self) -> Optional[int]:
        """The count if it can be read without waiting on the card,
        else None."""
        if self.copied is not None:
            return int(self.host) if self.copied.query() else None
        if self.ready is not None and not self.ready.query():
            return None
        if not (isinstance(self.count, torch.Tensor) and self.count.is_cuda):
            return int(self.count)  # host memory: no copy, no sync
        host = torch.empty((), dtype=self.count.dtype, pin_memory=True)
        host.copy_(self.count, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        self.host, self.copied = host, copied
        return None


def _fetch_counts(counts: List) -> List[int]:
    """Host ints of ``counts`` (ints and 0-d tensors, on any device):
    the tensors stacked and moved to the host in ONE copy — per-scalar
    reads would pay a transfer (and a sync) each."""
    tensors = [c for c in counts if isinstance(c, torch.Tensor)]
    if not tensors:
        return [int(c) for c in counts]
    from .tracing import trace_span

    with trace_span("device.block", site="metrics.rows", n=len(tensors)):
        host = iter(torch.stack([t.reshape(()).to(torch.int64)
                                 for t in tensors]).cpu().tolist())
    return [next(host) if isinstance(c, torch.Tensor) else int(c)
            for c in counts]


def resolve_all_pending(metrics_sets: Iterable[MetricsSet]) -> None:
    """Resolve every set's pending device row counts in ONE stacked
    copy — per-set resolution pays a separate transfer (and sync) per
    operator, which is what the < 5% overhead gate would otherwise
    spend its budget on."""
    sets = [m for m in metrics_sets if m._pending_rows]
    if not sets:
        return
    pending: List = []
    spans: List[int] = []
    for m in sets:
        spans.append(len(m._pending_rows))
        pending.extend(p.count for p in m._pending_rows)
        m._pending_rows = []
    counts = _fetch_counts(pending)
    i = 0
    for m, n in zip(sets, spans):
        m._counters["output_rows"] = (
            m._counters.get("output_rows", 0) + sum(counts[i:i + n]))
        i += n


def _plan_nodes(plan) -> List:
    nodes: List = []

    def gather(node):
        nodes.append(node)
        for c in node.children():
            gather(c)

    gather(plan)
    return nodes


def resolve_plan_pending(plan) -> None:
    """Resolve every operator's pending device row counts in one
    batched transfer. Call before rendering (``pretty_metrics``), else
    each operator's ``values()`` pays its own copy."""
    resolve_all_pending(n.metrics() for n in _plan_nodes(plan))


def reset_plan_metrics(plan) -> None:
    """Zero every operator's MetricsSet. EXPLAIN ANALYZE re-runs a
    possibly cached plan and must report THIS run, not the lifetime
    accumulation. The root's metrics EPOCH is bumped so deferred
    harvesters (system.operators' lazy snapshot of a past query) can
    tell that their values were clobbered by a newer run."""
    for n in _plan_nodes(plan):
        n.metrics().reset()
    try:
        plan._metrics_epoch = getattr(plan, "_metrics_epoch", 0) + 1
    except AttributeError:
        pass  # slotted plan node: epoch tracking degrades gracefully


def _fused_members(node) -> list:
    """Operators a fused stage absorbed (physical/fusion.py): the
    aggregate/distinct stage's pipeline chain, or a join's fused probe
    chain. Outermost first, matching plan-render order."""
    chain = list(getattr(node, "chain", ()) or ())
    chain += list(getattr(node, "probe_chain", ()) or ())
    return list(reversed(chain))


def collect_plan_metrics(plan) -> List[dict]:
    """Pre-order walk of a physical plan -> one row per operator:
    ``{"operator", "depth", "metrics"}``. ``elapsed_compute`` is
    cumulative (subtree); a derived ``elapsed_self`` (own minus direct
    children) is added when timers are present so hot operators stand
    out without double counting."""
    resolve_plan_pending(plan)

    rows: List[dict] = []

    def walk(node, depth: int) -> float:
        vals = node.metrics().values()
        row = {"operator": node.display(), "depth": depth, "metrics": vals}
        rows.append(row)
        # whole-stage fusion: operators absorbed into this node's traced
        # program still get a row (marked), so metric consumers see the
        # full logical plan; their work is attributed to the host row,
        # same convention as pipeline-chain members
        for member in _fused_members(node):
            rows.append({"operator": member.display() + " [fused]",
                         "depth": depth + 1, "metrics": {}})
        child_time = 0.0
        for c in node.children():
            child_time += walk(c, depth + 1)
        own = vals.get("elapsed_compute", 0.0)
        if own:
            vals["elapsed_self"] = max(own - child_time, 0.0)
        # an operator fused into a pipeline chain records no time of its
        # own; its subtree's cumulative time is still its children's —
        # returning 0 here would misattribute grandchild time to the
        # chain head's elapsed_self
        return max(own, child_time)

    walk(plan, 0)
    return rows


def merge_operator_metrics(per_task: Iterable[List[dict]]) -> List[dict]:
    """Merge several tasks' collect_plan_metrics outputs (tasks of one
    stage share an identical plan shape, so rows align positionally;
    a shape mismatch falls back to merging the common prefix).
    Counters and ``elapsed_*`` timers sum; other gauges keep the max."""
    merged: List[dict] = []
    for rows in per_task:
        for i, row in enumerate(rows):
            if i >= len(merged):
                merged.append({"operator": row["operator"],
                               "depth": row["depth"],
                               "metrics": dict(row["metrics"])})
                continue
            tgt = merged[i]["metrics"]
            for k, v in row["metrics"].items():
                if k.startswith("elapsed_") or not isinstance(v, float):
                    tgt[k] = tgt.get(k, 0) + v
                else:
                    tgt[k] = max(tgt.get(k, v), v)
    return merged


def snapshot_plan_metrics(phys) -> "QueryMetrics":
    """Standalone-mode QueryMetrics off an executed physical plan: one
    synthetic stage 0 (there is no stage decomposition in-process).
    Standalone DataFrames cache their physical plan across ``collect()``
    calls, but the collect path resets the plan's MetricsSets before
    each run, so the snapshot covers the most recent collect only."""
    ops = collect_plan_metrics(phys)
    total = ops[0]["metrics"].get("elapsed_compute", 0.0) if ops else 0.0
    return QueryMetrics({0: {"num_tasks": 1, "elapsed_total": total,
                             "operators": ops}})


class QueryMetrics:
    """Per-query stage/operator metric breakdown returned by
    ``BallistaContext.last_query_metrics()``.

    ``stages`` maps stage_id -> {"num_tasks": int, "elapsed_total":
    float, "operators": [{"operator", "depth", "metrics"}, ...]}.
    Standalone queries report a single stage 0.
    """

    def __init__(self, stages: Dict[int, dict]):
        self.stages = dict(stages)

    def stage_ids(self) -> List[int]:
        return sorted(self.stages)

    def operators(self) -> List[dict]:
        """All operator rows across stages, tagged with their stage."""
        out = []
        for sid in self.stage_ids():
            for row in self.stages[sid].get("operators", []):
                out.append({**row, "stage_id": sid})
        return out

    def total_output_rows(self) -> int:
        """Output rows of the final stage's root operator. The last
        stage (highest id — DistributedPlanner appends the root stage
        last) produces the query result; earlier stages feed shuffles,
        so summing every stage's root would count intermediates."""
        for sid in reversed(self.stage_ids()):
            ops = self.stages[sid].get("operators")
            if ops:
                return int(ops[0]["metrics"].get("output_rows", 0))
        return 0

    def pretty(self) -> str:
        lines = []
        for sid in self.stage_ids():
            st = self.stages[sid]
            head = f"Stage {sid} [tasks={st.get('num_tasks', 1)}"
            if st.get("elapsed_total"):
                head += f", elapsed={_fmt_secs(st['elapsed_total'])}"
            lines.append(head + "]")
            for row in st.get("operators", []):
                ms = MetricsSet()
                for k, v in row["metrics"].items():
                    if k.startswith("elapsed_"):
                        ms.add_time(k, v)
                    elif isinstance(v, float):  # type is the kind
                        ms.set_gauge(k, v)
                    else:
                        ms.add_counter(k, int(v))
                ann = ms.summary()
                lines.append("  " * (row["depth"] + 1) + row["operator"]
                             + (f"  [{ann}]" if ann else ""))
        return "\n".join(lines) + "\n"

    def __repr__(self) -> str:
        n_ops = sum(len(s.get("operators", []))
                    for s in self.stages.values())
        return (f"QueryMetrics(stages={self.stage_ids()}, "
                f"operators={n_ops})")


# -- SLO latency histograms with exemplars ------------------------------------
# Fed once per terminal query from the latency ledger
# (observability/ledger.py): a fixed-bucket end-to-end histogram plus a
# per-phase family, where every (family, labels, bucket) cell retains
# the job id + full ledger of its MOST RECENT observation — so the top
# occupied bucket (the p99 tail) always carries a concrete exemplar
# query instead of an anonymous count. Surfaced as system.exemplars.

SLO_LATENCY_FAMILY = "ballista_latency_seconds"
SLO_PHASE_FAMILY = "ballista_latency_phase_seconds"

import threading as _threading  # noqa: E402 - section-local dependency

_exemplar_lock = _threading.Lock()
# (family, labels-key tuple, bucket index) -> exemplar dict. Bucket
# index is the first HISTOGRAM_BUCKETS edge >= value; len(buckets) is
# the +Inf overflow bucket.
_exemplars: Dict[tuple, dict] = {}


def _bucket_index(value: float) -> int:
    from .registry import HISTOGRAM_BUCKETS

    for i, le in enumerate(HISTOGRAM_BUCKETS):
        if value <= le:
            return i
    return len(HISTOGRAM_BUCKETS)


def _bucket_le(index: int) -> float:
    from .registry import HISTOGRAM_BUCKETS

    if index >= len(HISTOGRAM_BUCKETS):
        return float("inf")
    return HISTOGRAM_BUCKETS[index]


def _note_exemplar(family: str, labels: Dict[str, str], value: float,
                   ledger: dict) -> None:
    key = (family,
           tuple(sorted((str(k), str(v)) for k, v in labels.items())),
           _bucket_index(value))
    with _exemplar_lock:
        _exemplars[key] = {
            "job_id": ledger.get("job_id"),
            "seconds": round(float(value), 6),
            "wall_seconds": float(ledger.get("wall_seconds", 0.0)),
            "ledger": ledger,
        }


def observe_query_ledger(ledger: dict) -> None:
    """Observe one query's ledger into the SLO families: end-to-end
    wall + every phase (zeros included, so ``_count`` is queries per
    cell and phase fractions divide cleanly)."""
    from .registry import observe_histogram

    wall = float(ledger.get("wall_seconds", 0.0))
    observe_histogram(SLO_LATENCY_FAMILY, {}, wall)
    _note_exemplar(SLO_LATENCY_FAMILY, {}, wall, ledger)
    for phase, secs in (ledger.get("phases") or {}).items():
        labels = {"phase": phase}
        observe_histogram(SLO_PHASE_FAMILY, labels, float(secs))
        _note_exemplar(SLO_PHASE_FAMILY, labels, float(secs), ledger)


def exemplar_rows() -> List[dict]:
    """``system.exemplars``: one row per retained (family, labels,
    bucket) exemplar, widest buckets last. ``ledger_json`` carries the
    exemplar query's FULL ledger."""
    import json

    with _exemplar_lock:
        snap = dict(_exemplars)
    rows = []
    for (family, labels_key, idx), ex in sorted(
            snap.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2])):
        rows.append({
            "family": family,
            "phase": dict(labels_key).get("phase", ""),
            "bucket_le": _bucket_le(idx),
            "job_id": ex.get("job_id"),
            "seconds": ex.get("seconds"),
            "wall_seconds": ex.get("wall_seconds"),
            "ledger_json": json.dumps(ex.get("ledger") or {},
                                      sort_keys=True),
        })
    return rows


def reset_latency_exemplars() -> None:
    """Test hook: drop retained exemplars (histogram cells are cleared
    separately via registry.reset_histograms)."""
    with _exemplar_lock:
        _exemplars.clear()
