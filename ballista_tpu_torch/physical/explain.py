"""EXPLAIN execution: a leaf operator that yields pre-rendered plan text.

The port of the JAX package's ``physical/explain.py``. The scheduler or
client renders the plan during physical planning and the result rows
travel like any other single-partition result, so a distributed EXPLAIN
needs no result channel of its own. Both operators make their rows on
their ``device`` (the wire carries none: ``serde.physical_from_proto``
passes the executor's).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

from ..columnar import ColumnBatch
from ..datatypes import Schema
from ..logical import EXPLAIN_SCHEMA
from .base import Partitioning, PhysicalPlan


def _rows_batches(rows: List[Tuple[str, str]], device) -> Iterator[ColumnBatch]:
    from ..io.memory import MemTableSource

    src = MemTableSource.from_pydict(
        EXPLAIN_SCHEMA,
        {"plan_type": [t for t, _ in rows], "plan": [p for _, p in rows]},
        device=device,
    )
    yield from src.scan(0)


class ExplainExec(PhysicalPlan):
    """Leaf node holding rendered ``(plan_type, plan)`` rows."""

    def __init__(self, rows: List[Tuple[str, str]], device):
        self.rows = [(str(t), str(p)) for t, p in rows]
        self.device = torch.device(device)

    def output_schema(self) -> Schema:
        return EXPLAIN_SCHEMA

    def output_partitioning(self) -> Partitioning:
        return Partitioning("unknown", 1)

    def children(self) -> List[PhysicalPlan]:
        return []

    def with_new_children(self, children) -> "ExplainExec":
        return self

    def estimated_rows(self):
        return len(self.rows)

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        yield from _rows_batches(self.rows, self.device)

    def display(self) -> str:
        return f"ExplainExec rows={len(self.rows)}"


class ExplainAnalyzeExec(PhysicalPlan):
    """EXPLAIN ANALYZE: execute the inner plan, drain its output, and
    yield the plan text annotated with live operator metrics.

    Presents as a LEAF (``children() == []``) on purpose: the
    distributed planner then never splits the inner plan into stages, so
    the whole analyzed query runs as ONE task on one executor and the
    annotated rows ride the existing single-partition result channel —
    the same trick ExplainExec uses for plain EXPLAIN. Metrics are
    force-enabled around the run, so ANALYZE measures even under
    BALLISTA_METRICS=0. Row counts stay pending device scalars until
    ``resolve_plan_pending`` reads them all in one stacked copy.
    """

    def __init__(self, inner: PhysicalPlan, device, verbose: bool = False,
                 logical_text: str | None = None, adaptive_conf=None):
        self.inner = inner
        self.device = torch.device(device)
        self.verbose = verbose
        self.logical_text = logical_text
        # standalone adaptive execution config (AdaptiveConfig | None):
        # ANALYZE applies the same rules a plain collect would, so the
        # annotated plan shows the [adaptive: ...] decisions. None (the
        # deserialized cluster-task case) analyzes the static plan.
        self.adaptive_conf = adaptive_conf
        self._adapted = False

    def output_schema(self) -> Schema:
        return EXPLAIN_SCHEMA

    def output_partitioning(self) -> Partitioning:
        return Partitioning("unknown", 1)

    def children(self) -> List[PhysicalPlan]:
        return []  # leaf by design (see docstring)

    def with_new_children(self, children) -> "ExplainAnalyzeExec":
        return self

    def estimated_rows(self):
        return 2

    def release(self) -> None:
        """Drop the analyzed tree's join builds and repartitioned
        batches, as a plain collect does for the tree it ran."""
        stack = [self.inner]
        while stack:
            node = stack.pop()
            node.release()
            stack.extend(node.children())

    def execute(self, partition: int) -> Iterator[ColumnBatch]:
        import time as _time

        from ..observability.metrics import (force_metrics,
                                             reset_plan_metrics,
                                             resolve_plan_pending)

        # whole-stage fusion: ANALYZE measures (and renders) the same
        # fused stages a plain collect would run. Applied here rather
        # than at planning so the cluster path — which ships the inner
        # plan over the wire unfused — fuses executor-side too.
        from .fusion import maybe_fuse

        self.inner = maybe_fuse(self.inner)
        # the inner plan may be kept (standalone DataFrames reuse their
        # physical plan across collects): report THIS run only
        reset_plan_metrics(self.inner)
        t0 = _time.perf_counter()
        with force_metrics():
            # parallel ingest: ANALYZE measures the same pipelined
            # execution a plain collect would run (scan instances
            # survive the adaptive rewrite below)
            from ..ingest import cancel_plan, prime_plan

            prime_plan(self.inner)
            try:
                if self.adaptive_conf is not None and \
                        self.adaptive_conf.enabled and not self._adapted:
                    # inside force_metrics: the rewrite materializes
                    # repartition inputs, and those executions must be
                    # measured like the rest of the run
                    from ..adaptive.standalone import apply_adaptive_rules
                    from .fusion import fuse_plan, fusion_enabled

                    self.inner = apply_adaptive_rules(self.inner,
                                                      self.adaptive_conf)
                    if fusion_enabled():
                        # re-fuse what the rewrite restructured (same
                        # policy as the plain collect path); mark it so
                        # a re-executed ANALYZE doesn't re-run the full
                        # pass over the demoted shape
                        self.inner = fuse_plan(self.inner,
                                               fuse_joins=False)
                        self.inner._fusion_applied = True
                    self._adapted = True
                for p in range(
                        self.inner.output_partitioning().num_partitions):
                    for _ in self.inner.execute(p):
                        pass  # drain: ANALYZE reports metrics, not rows
            finally:
                cancel_plan(self.inner)
        total = _time.perf_counter() - t0
        # one stacked device-to-host copy of every operator's pending row
        # counts (pretty_metrics would otherwise pay one per operator)
        resolve_plan_pending(self.inner)
        rows: List[Tuple[str, str]] = []
        if self.verbose and self.logical_text is not None:
            rows.append(("logical_plan", self.logical_text))
        rows.append(("plan_with_metrics", self.inner.pretty_metrics()))
        rows.append(("total_elapsed", f"{total:.6f}s"))
        # memory plane summary: process peaks + host bytes by category
        # (operator-level peak_host_bytes/peak_device_bytes gauges ride
        # the plan annotation above); the device peak is the card's
        from ..observability import memory as obs_memory

        snap = obs_memory.memory_snapshot()
        cats = ", ".join(f"{k}={v}" for k, v in
                         sorted(snap["by_category"].items()) if v)
        rows.append(("memory",
                     f"peak_host_bytes={snap['peak_bytes']}, "
                     f"peak_device_bytes={snap['peak_device_bytes']}, "
                     f"rss_bytes={snap['rss_bytes']}"
                     + (f", host[{cats}]" if cats else "")))
        yield from _rows_batches(rows, self.device)

    def display(self) -> str:
        return "ExplainAnalyzeExec"


def make_explain_analyze(inner: PhysicalPlan, verbose: bool,
                         logical_text: "str | None",
                         settings: "dict | None",
                         device) -> ExplainAnalyzeExec:
    """The one place an analyzed plan resolves its AdaptiveConfig —
    the SQL (execution.plan_logical) and direct (physical.planner)
    EXPLAIN ANALYZE paths must not drift apart."""
    from ..adaptive import AdaptiveConfig

    return ExplainAnalyzeExec(
        inner, device, verbose, logical_text=logical_text,
        adaptive_conf=AdaptiveConfig.from_settings(settings),
    )


def render_explain(logical_input, physical_input: PhysicalPlan,
                   verbose: bool, device,
                   unoptimized_text: str | None = None,
                   cost_notes: "tuple | None" = None) -> ExplainExec:
    """Build the EXPLAIN result rows from planned inputs.

    Non-verbose mirrors the two-row (logical_plan, physical_plan) surface;
    verbose additionally shows the pre-optimization logical plan when the
    caller captured one. ``cost_notes`` (the control plane's
    cost-feedback decisions for this plan shape) render as one extra
    ``cost_feedback`` row so planning history stays explainable.
    """
    from .fusion import maybe_fuse

    rows: List[Tuple[str, str]] = []
    if verbose and unoptimized_text is not None:
        rows.append(("initial_logical_plan", unoptimized_text))
    rows.append(("logical_plan", logical_input.pretty()))
    # render the FUSED plan — EXPLAIN must show the fusion groups the
    # standalone collect path will actually execute (text-only: the
    # fused operators never serialize)
    rows.append(("physical_plan", maybe_fuse(physical_input).pretty()))
    if cost_notes:
        rows.append(("cost_feedback", "\n".join(cost_notes)))
    return ExplainExec(rows, device)
