"""Cluster-side adaptive re-planning: the port of the JAX package's
``adaptive/replanner.py``. It only inspects and re-serializes plans and
builds no batch, so it deserializes them on the CPU, as the scheduler
that runs it does.

Installed by the scheduler service as ``SchedulerState.replan_hook`` and
invoked (under the state lock) whenever a stage completes — the moment
real metrics for that stage exist and its dependents' plans are still
just rows in the state store. Two entry windows:

- a dependent whose inputs are now ALL complete (``ready``): coalesce
  its shuffle reads to ``target_partition_bytes`` and/or split skewed
  partitions, shrinking or reshaping its task list before the first
  task is enqueued;
- a dependent still waiting on other inputs (``blocked``): if the
  completed input is the build side of a planned co-partitioned join
  and it came in under ``broadcast_threshold_bytes``, demote the join
  to a broadcast build and strip the probe side's (not yet started)
  shuffle repartition.

Every rewrite goes through ``SchedulerState.update_stage_plan``, which
bumps the stage version; task definitions carry the version and status
reports echo it, so an executor that raced a re-plan reports into a
dropped bucket instead of corrupting the new plan's bookkeeping.

All decisions are best-effort: any structural condition not recognized
(multi-stage readers, mesh-fused stages, already-started tasks, a stage
already rewritten) leaves the static plan untouched, which is always
correct.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from ..observability import trace_event
from .config import AdaptiveConfig
from .rules import describe_layout, plan_shuffle_reads, should_broadcast

log = logging.getLogger("ballista.adaptive")


def replan_on_stage_complete(state, job_id: str, completed_sid: int,
                             ready_sids: List[int],
                             blocked_sids: List[int]) -> None:
    """SchedulerState.replan_hook entry point."""
    conf = AdaptiveConfig.from_settings(state.get_job_settings(job_id))
    if not conf.enabled:
        return
    for sid in ready_sids:
        try:
            _replan_ready_stage(state, job_id, sid, conf)
        except Exception:  # noqa: BLE001 - static plan is the fallback
            log.exception("adaptive coalesce/skew re-plan failed for "
                          "%s/%d; keeping static plan", job_id, sid)
    if conf.broadcast_enabled:
        for sid in blocked_sids:
            try:
                _maybe_demote_join(state, job_id, sid, completed_sid, conf)
            except Exception:  # noqa: BLE001 - static plan is the fallback
                log.exception("adaptive join demotion failed for %s/%d; "
                              "keeping static plan", job_id, sid)


# -- plan (de)serialization helpers ------------------------------------------


def _load_plan(plan_bytes: bytes):
    from ..proto import ballista_pb2 as pb
    from .. import serde

    node = pb.PhysicalPlanNode()
    node.ParseFromString(plan_bytes)
    return serde.physical_from_proto(node, device="cpu")


def _dump_plan(plan) -> bytes:
    from .. import serde

    return serde.physical_to_proto(plan).SerializeToString()


def _walk(plan):
    yield plan
    for c in plan.children():
        yield from _walk(c)


def _replace_node(plan, old, new):
    if plan is old:
        return new
    kids = plan.children()
    if not kids:
        return plan
    new_kids = [_replace_node(c, old, new) for c in kids]
    if all(a is b for a, b in zip(kids, new_kids)):
        return plan
    return plan.with_new_children(new_kids)


# -- rule 1 + 3: partition coalescing and skew splitting ---------------------


def _replan_ready_stage(state, job_id: str, sid: int,
                        conf: AdaptiveConfig) -> None:
    """Rewrite an about-to-be-enqueued stage's shuffle reads from the
    observed per-partition byte histogram of its (now complete)
    producers."""
    from ..physical.join import JoinExec
    from ..physical.shuffle import UnresolvedShuffleExec

    if not (conf.coalesce_enabled or conf.skew_enabled):
        return
    row = state.get_stage_plan(job_id, sid)
    if row.mesh_devices or row.version > 0:
        return
    if state.stage_started(job_id, sid):
        return
    plan = _load_plan(row.plan_bytes)
    hash_nodes = []  # (UnresolvedShuffleExec, dep_sid, dep StagePlan)
    for nd in (n for n in _walk(plan)
               if isinstance(n, UnresolvedShuffleExec)):
        if len(nd.query_stage_ids) != 1:
            return  # multi-stage reader: shape not understood, bail
        dep = nd.query_stage_ids[0]
        dep_row = state.get_stage_plan(job_id, dep)
        if dep_row.shuffle_spec is not None:
            hash_nodes.append((nd, dep, dep_row))
    if not hash_nodes:
        return
    outs = {r.shuffle_spec[1] for _, _, r in hash_nodes}
    if len(outs) != 1:
        return  # mixed fan-outs cannot share one grouping
    n_out = outs.pop()

    # placement: skew splitting is only sound where sub-reads of one
    # bucket are row-wise unionable — the probe side of a single
    # co-partitioned join whose two inputs are exactly our hash deps.
    # Everything else gets coalescing only (whole buckets preserved).
    joins = [n for n in _walk(plan)
             if isinstance(n, JoinExec) and n.partitioned]
    probe_dep: Optional[int] = None
    if len(joins) > 1:
        return
    if joins:
        j = joins[0]
        b, p = j.build, j.probe
        if not (isinstance(b, UnresolvedShuffleExec)
                and isinstance(p, UnresolvedShuffleExec)):
            return
        if len(hash_nodes) != 2 or {b.query_stage_ids[0],
                                    p.query_stage_ids[0]} != \
                {dep for _, dep, _ in hash_nodes}:
            return
        probe_dep = p.query_stage_ids[0]
    elif any(isinstance(n, JoinExec) for n in _walk(plan)):
        # a merged (or already-demoted) join over a hash shuffle: its
        # build reader spans every bucket anyway — nothing to gain
        return

    hists = {}
    for _, dep, _ in hash_nodes:
        h = state.shuffle_partition_histogram(job_id, dep)
        if h is None:
            return  # producers predate the histogram field, or racing
        hists[dep] = h
    combined = [sum(hists[dep][0][q] for dep in hists)
                for q in range(n_out)]
    layout = plan_shuffle_reads(
        combined, conf,
        producer_bytes=hists[probe_dep][1] if probe_dep is not None
        else None,
        allow_skew=probe_dep is not None,
        # skew must be detected on PROBE mass only: each split sub-task
        # re-reads the whole build bucket, so build-heavy buckets gain
        # nothing from splitting and would pay the build N times over
        skew_bytes=hists[probe_dep][0] if probe_dep is not None else None,
    )
    if layout is None:
        return
    # non-probe inputs mirror the grouping with ALL producers per range:
    # a skew-split probe bucket is joined against its WHOLE build bucket
    # in every sub-task
    broadcast_ranges = [[(olo, ohi, 0, 0) for (olo, ohi, _, _) in ranges]
                        for ranges in layout]
    layouts = {}
    for nd, dep, _ in hash_nodes:
        layouts[dep] = layout if dep == probe_dep else broadcast_ranges
        nd.partition_count = len(layout)
    new_nparts = plan.output_partitioning().num_partitions
    note = describe_layout(n_out, layout)
    version = state.update_stage_plan(
        job_id, sid, plan_bytes=_dump_plan(plan),
        num_partitions=new_nparts, reader_layouts=layouts,
    )
    trace_event("adaptive.replan", job=job_id, stage=sid,
                rule="coalesce" if probe_dep is None else "coalesce+skew",
                decision=note, reads_before=n_out, reads_after=len(layout),
                tasks_before=row.num_partitions, tasks_after=new_nparts,
                version=version)
    log.info("adaptive: job %s stage %d: %s (%d -> %d tasks, v%d)",
             job_id, sid, note, row.num_partitions, new_nparts, version)


# -- rule 2: join strategy demotion ------------------------------------------


def _maybe_demote_join(state, job_id: str, consumer_sid: int,
                       completed_sid: int, conf: AdaptiveConfig) -> None:
    """The completed stage turned out to be a small build side of a
    planned shuffle-hash join: broadcast it and drop the probe side's
    (not yet started) shuffle repartition."""
    from ..physical.join import JoinExec
    from ..physical.shuffle import UnresolvedShuffleExec

    crow = state.get_stage_plan(job_id, consumer_sid)
    if crow.mesh_devices or state.stage_started(job_id, consumer_sid):
        return
    if crow.version > 0:
        # already rewritten: a downstream demotion stripped this stage's
        # shuffle and laid its probe reads out one task of this stage
        # each, so this stage's task count must not change any more.
        # (The JAX package's re-planner lacks this check: when the
        # downstream build completes first, it shrinks this stage's
        # tasks under that layout and the downstream tasks past the new
        # count fail reading.)
        return
    # cheap row-level pre-check before deserializing the plan (this
    # runs under the state lock for EVERY blocked dependent of every
    # completing stage): a demotable join needs the completed stage
    # shuffled AND at least two shuffled deps (build + probe)
    if state.get_stage_plan(job_id, completed_sid).shuffle_spec is None:
        return
    shuffled_deps = sum(
        1 for d in crow.deps
        if state.get_stage_plan(job_id, d).shuffle_spec is not None)
    if shuffled_deps < 2:
        return
    plan = _load_plan(crow.plan_bytes)
    target = next(
        (n for n in _walk(plan)
         if isinstance(n, JoinExec) and n.partitioned
         and isinstance(n.build, UnresolvedShuffleExec)
         and isinstance(n.probe, UnresolvedShuffleExec)
         and n.build.query_stage_ids == [completed_sid]
         and len(n.probe.query_stage_ids) == 1),
        None,
    )
    if target is None:
        return
    probe_sid = target.probe.query_stage_ids[0]
    prow = state.get_stage_plan(job_id, probe_sid)
    if prow.shuffle_spec is None or prow.mesh_devices:
        return
    if state.stage_started(job_id, probe_sid):
        return  # its hash-split output format is already in flight
    if state.stage_consumers(job_id, probe_sid) != [consumer_sid]:
        return  # someone else reads the shuffled layout
    total = state.stage_output_bytes(job_id, completed_sid)
    if total is None or not should_broadcast(total, conf):
        return

    note = (f"broadcast build ({total / 1e6:.2f} MB < "
            f"{conf.broadcast_threshold_bytes / 1e6:.0f} MB threshold)")
    demoted = JoinExec(
        target.build,
        UnresolvedShuffleExec([probe_sid],
                              target.probe.output_schema(),
                              prow.num_partitions),
        target.on, target.how, null_aware=target.null_aware,
        partitioned=False, adaptive_note=note,
    )
    new_plan = _replace_node(plan, target, demoted)
    new_nparts = new_plan.output_partitioning().num_partitions
    # The two stage rewrites below cannot be transactional (two kv
    # writes), so the consumer is made correct under EITHER probe
    # format first: its probe-side reader layout maps task p to ALL
    # n_out hash outputs of producer p — the union of a producer's
    # hash slices IS its full output. If the spec strip lands, the
    # probe writes plain per-task files and the (shuffled-only) layout
    # is simply ignored; if it doesn't (crash between the writes), the
    # probe still hash-splits and the layout reassembles each
    # producer's rows — only the split work is wasted, never rows.
    n_out = prow.shuffle_spec[1]
    probe_layout = [[(0, n_out, p, p + 1)]
                    for p in range(prow.num_partitions)]
    version = state.update_stage_plan(
        job_id, consumer_sid, plan_bytes=_dump_plan(new_plan),
        num_partitions=new_nparts,
        reader_layouts={probe_sid: probe_layout},
    )
    # probe producer stops hash-splitting: its tasks now write ONE
    # partition file each, which the demoted join streams 1:1
    state.update_stage_plan(job_id, probe_sid, shuffle_spec=None)
    trace_event("adaptive.replan", job=job_id, stage=consumer_sid,
                rule="broadcast", decision=note, build_stage=completed_sid,
                probe_stage=probe_sid, build_bytes=total,
                tasks_before=crow.num_partitions, tasks_after=new_nparts,
                version=version)
    log.info("adaptive: job %s stage %d: %s (probe stage %d unshuffled; "
             "%d -> %d tasks, v%d)", job_id, consumer_sid, note,
             probe_sid, crow.num_partitions, new_nparts, version)
