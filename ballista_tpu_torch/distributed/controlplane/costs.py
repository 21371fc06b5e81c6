"""Cost feedback: observed stage costs steer the NEXT initial plan.

Flare's lesson (PAPERS.md) is that work a serving system repeats must
amortize to ~0. Adaptive re-planning already fixes partition counts
and join strategy MID-flight from observed stage metrics — but every
fresh submission of the same query shape starts from the same static
defaults and pays the same first-stage mistake again. This store
closes the loop: at each job's terminal transition the scheduler folds
the observed per-stage costs (``StageMetrics``) into one durable
record keyed by the plan's stable digest (the same
``compile_signature``-style identity the profiler stamps on slow-query
summaries), and the planner consults it BEFORE ``plan_logical``:

- **shuffle partition counts** — ``join.partitions`` (and a
  configured ``agg.partitions``) are sized so each shuffled partition
  carries about ``controlplane.cost_target_partition_bytes`` of the
  query's OBSERVED shuffle volume, instead of the static default 8;
- **broadcast-vs-shuffle join choice** — a query whose observed
  shuffle volume is tiny relative to the target raises
  ``join.partition_threshold`` (prefer the merged-build/broadcast
  form); one whose volume dwarfs it lowers the threshold (prefer
  co-partitioned buckets).

Explicit client settings ALWAYS win — advice only fills knobs the
submission left at their defaults — and AQE still corrects mid-flight,
so a stale record degrades performance, never correctness. Decisions
annotate EXPLAIN (a ``cost_feedback`` row) and trace as
``controlplane.costs``.

Records live under ``costs/{digest}`` in the scheduler's KvBackend
(EWMA over runs, so drift follows the data); the same degrade-loudly
posture as the journal applies.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import pickle
import time
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("ballista.controlplane")

COST_PREFIX = "costs"
# EWMA weight of the newest run
ALPHA = 0.5
# partition-count advice stays inside sane bounds
MIN_PARTITIONS = 1
MAX_PARTITIONS = 64
# threshold nudges: multiply/divide by this factor
THRESHOLD_STEP = 4

DEFAULT_TARGET_PARTITION_BYTES = 64 * 1024 * 1024


def _setting(settings: Optional[Dict[str, str]], key: str):
    """settings > env BALLISTA_CONTROLPLANE_* > None (same resolution
    order as the admission.* family)."""
    s = settings or {}
    if key in s:
        return s[key]
    return os.environ.get("BALLISTA_" + key.upper().replace(".", "_"))


def cost_feedback_enabled(settings: Optional[Dict[str, str]] = None) -> bool:
    raw = _setting(settings, "controlplane.cost_feedback")
    if raw is None:
        return True
    from ...adaptive.config import _as_bool

    return _as_bool(raw, "controlplane.cost_feedback", True)


def target_partition_bytes(settings: Optional[Dict[str, str]] = None) -> int:
    raw = _setting(settings, "controlplane.cost_target_partition_bytes")
    if raw is None:
        return DEFAULT_TARGET_PARTITION_BYTES
    try:
        n = int(str(raw).strip())
    except ValueError:
        raise ValueError(
            "config key 'controlplane.cost_target_partition_bytes': "
            f"expected an integer, got {raw!r}") from None
    return max(n, 1)


def _stage_costs(stage_metrics: dict) -> Tuple[float, int]:
    """(task_seconds, shuffle_bytes) observed for one completed job.
    ``shuffle_bytes`` counts what NON-FINAL stages materialized into
    the data plane (ShuffleWrite/PartitionWrite bytes_written — the
    same metering unit system.sessions uses)."""
    task_seconds = 0.0
    shuffle_bytes = 0
    final_sid = max(stage_metrics) if stage_metrics else None
    for sid, st in stage_metrics.items():
        task_seconds += float(st.get("elapsed_total", 0.0))
        if sid == final_sid:
            continue
        for op in st.get("operators") or []:
            if op.get("operator") in ("ShuffleWrite", "PartitionWrite"):
                shuffle_bytes += int(
                    (op.get("metrics") or {}).get("bytes_written", 0))
    return task_seconds, shuffle_bytes


class CostFeedbackStore:
    """Per-plan-digest observed costs over the scheduler's KvBackend."""

    def __init__(self, state):
        self._state = state
        self._degraded = False

    def _guard(self, op: str, fn, default=None):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - degrade, never refuse
            if not self._degraded:
                self._degraded = True
                log.error("cost-feedback store degraded to no-op: "
                          "backend %s failed (%s: %s)", op,
                          type(e).__name__, e)
            return default

    # -- observe -------------------------------------------------------------

    def observe(self, digest: str, stage_metrics: dict,
                wall_seconds: float = 0.0) -> Optional[dict]:
        """Fold one completed job's stage costs into the digest's
        record (EWMA). Advisory: never raises."""
        if not digest or not stage_metrics:
            return None
        task_seconds, shuffle_bytes = _stage_costs(stage_metrics)
        st = self._state
        key = st._k(COST_PREFIX, digest)
        prev = None
        raw = self._guard("get", lambda: st.kv.get(key))
        if raw is not None:
            try:
                prev = pickle.loads(raw)
            except Exception:  # noqa: BLE001 - torn record: restart
                prev = None

        def ewma(old, new):
            return new if old is None else \
                (1.0 - ALPHA) * float(old) + ALPHA * float(new)

        rec = {
            "digest": digest,
            "runs": int((prev or {}).get("runs", 0)) + 1,
            "wall_seconds": ewma((prev or {}).get("wall_seconds"),
                                 wall_seconds),
            "task_seconds": ewma((prev or {}).get("task_seconds"),
                                 task_seconds),
            "shuffle_bytes": ewma((prev or {}).get("shuffle_bytes"),
                                  shuffle_bytes),
            "num_stages": len(stage_metrics),
            "updated_at": time.time(),
        }
        self._guard("put", lambda: st.kv.put(key, pickle.dumps(rec)))
        return rec

    def lookup(self, digest: str) -> Optional[dict]:
        if not digest:
            return None
        st = self._state
        raw = self._guard("get", lambda: st.kv.get(
            st._k(COST_PREFIX, digest)))
        if raw is None:
            return None
        try:
            return pickle.loads(raw)
        except Exception:  # noqa: BLE001 - torn record
            return None

    # -- advise --------------------------------------------------------------

    def advise(self, digest: Optional[str], opts,
               settings: Optional[Dict[str, str]] = None):
        """Return ``(opts, notes)``: a PlannerOptions copy with
        history-informed defaults filled in, plus human-readable notes
        (EXPLAIN's ``cost_feedback`` row + trace events). Explicitly
        configured knobs are never overridden; no history or disabled
        feedback returns ``opts`` unchanged."""
        notes: List[str] = []
        if digest is None or not cost_feedback_enabled(settings):
            return opts, notes
        rec = self.lookup(digest)
        if rec is None:
            return opts, notes
        s = settings or {}
        target = target_partition_bytes(settings)
        shuffle_bytes = float(rec.get("shuffle_bytes") or 0.0)
        changes = {}
        if shuffle_bytes > 0 and "join.partitions" not in s:
            n = min(max(math.ceil(shuffle_bytes / target),
                        MIN_PARTITIONS), MAX_PARTITIONS)
            if n != opts.join_partitions:
                changes["join_partitions"] = n
                notes.append(
                    f"join.partitions {opts.join_partitions} -> {n} "
                    f"(observed ~{int(shuffle_bytes)}B shuffled over "
                    f"{rec['runs']} run(s), target {target}B/partition)")
        if shuffle_bytes > 0 and opts.agg_partitions and \
                "agg.partitions" not in s:
            n = min(max(math.ceil(shuffle_bytes / target),
                        MIN_PARTITIONS), MAX_PARTITIONS)
            if n != opts.agg_partitions:
                changes["agg_partitions"] = n
                notes.append(
                    f"agg.partitions {opts.agg_partitions} -> {n}")
        thr = opts.join_partition_threshold
        if thr is not None and "join.partitioned.threshold" not in s:
            if shuffle_bytes and shuffle_bytes < target:
                changes["join_partition_threshold"] = thr * THRESHOLD_STEP
                notes.append(
                    f"join threshold {thr} -> {thr * THRESHOLD_STEP}: "
                    "observed shuffle volume is small — prefer the "
                    "merged-build (broadcast) join")
            elif shuffle_bytes > 8 * target:
                lowered = max(thr // THRESHOLD_STEP, 1)
                changes["join_partition_threshold"] = lowered
                notes.append(
                    f"join threshold {thr} -> {lowered}: observed "
                    "shuffle volume is large — prefer the "
                    "co-partitioned (shuffled) join")
        if not changes:
            return opts, notes
        # EXPLAIN annotation rides the options into the planner: the
        # Explain branch renders a cost_feedback row from these notes
        changes["cost_notes"] = tuple(notes)
        opts = dataclasses.replace(opts, **changes)
        try:
            from ...observability.tracing import trace_event

            trace_event("controlplane.costs", digest=digest[:16],
                        runs=rec.get("runs"), notes="; ".join(notes))
        except Exception:  # noqa: BLE001 - observability only
            pass
        return opts, notes
