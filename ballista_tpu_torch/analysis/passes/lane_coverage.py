"""lane-coverage: every span name must be known to an attribution map.

The profiler's lane decomposition (``export.compute_lanes`` via
``export.LANE_SPANS``) and the latency ledger's span-derived phases
(``ledger.LEDGER_SPANS``) both attribute query wall time by SPAN NAME.
A new ``trace_span("foo.bar", ...)`` that neither map knows about
silently lands in whatever residual lane encloses it ("other" for the
profiler, ``device_execute``/``unattributed`` for the ledger) — the
attribution drifts without any test failing. This pass closes the
loop: every constant span/event name emitted anywhere in the package
must be either

- mapped by ``export.LANE_SPANS``, ``ledger.LEDGER_SPANS`` or
  ``operators.OPERATOR_SPANS``,
- covered by a mapped PREFIX (``ingest.*`` — compute_lanes folds the
  whole ingest family into the parse/h2d lanes by prefix), or
- on the explicit :data:`UNMAPPED_ALLOWLIST` with a justification.

Dynamic names (f-strings, concatenation — e.g. the admission plane's
``admission.{action}`` events) are structurally invisible to an AST
constant scan and are exercised by the runtime tests instead.

The registries import lazily inside ``run`` (live-package rule, same
as metric-names) so the pure-AST rules stay usable standalone.
"""

from __future__ import annotations

import ast
from typing import List

from ..engine import Finding, Package, Rule, make_finding

# span names that are DELIBERATELY unmapped: control-plane envelopes
# and markers that never represent attributable query wall time. Every
# entry carries its justification — an unexplained span name belongs in
# a map, not here.
UNMAPPED_ALLOWLIST = {
    # structural task envelope: compute_lanes keys per-process tracks
    # and flow arrows off it, and capture_task_profile bounds task
    # windows with it — its children are the attributed spans
    "executor.task",
    # scheduler-side planning envelope; planning wall time reaches the
    # ledger through the scheduler's explicit planning STAMP, and the
    # span exists for the merged artifact's scheduler track
    "scheduler.plan_job",
    # scheduler dispatch bookkeeping: control-plane time, not part of
    # any single query's attributable wall
    "scheduler.task_dispatch",
    # cancellation marker event (dur=0): lifecycle, not latency
    "lifecycle.cancel",
    # adaptive re-planning markers: they fire INSIDE windows that are
    # already attributed (standalone collect / executor task)
    "adaptive.standalone",
    "adaptive.replan",
    # whole-stage fusion runs inside the planning phase, which both
    # paths stamp wholesale (client ledger_phase / scheduler stamp)
    "compile.fuse",
    # control-plane events: restart recovery, degraded-mode entry,
    # cost-feedback persistence, autoscaler decisions — scheduler
    # lifetime, no per-query wall time to attribute
    "controlplane.recover",
    "controlplane.degraded",
    "controlplane.costs",
    "controlplane.autoscale",
}

# name prefixes an attribution surface handles wholesale:
# compute_lanes folds every ``ingest.*`` span into parse/h2d by prefix
MAPPED_PREFIXES = ("ingest.",)


class LaneCoverageRule(Rule):
    id = "lane-coverage"
    description = ("span names every attribution map ignores (lane/"
                   "ledger coverage drift)")

    def run(self, package: Package) -> List[Finding]:
        from ballista_tpu_torch.observability.export import LANE_SPANS
        from ballista_tpu_torch.observability.ledger import LEDGER_SPANS
        from ballista_tpu_torch.observability.operators import (
            OPERATOR_SPANS)

        mapped = set(LANE_SPANS) | set(LEDGER_SPANS) | set(OPERATOR_SPANS)
        findings: List[Finding] = []
        for sf in package.files:
            for node in ast.walk(sf.tree):
                name = _span_name(node)
                if name is None or name in mapped or \
                        name in UNMAPPED_ALLOWLIST or \
                        name.startswith(MAPPED_PREFIXES):
                    continue
                findings.append(make_finding(
                    self.id, sf, node.lineno,
                    f"span {name!r} is unknown to export.LANE_SPANS, "
                    "ledger.LEDGER_SPANS and the unmapped allowlist — "
                    "its wall time silently lands in a residual lane "
                    "(map it, or allowlist it with a justification)"))
        return findings


def _span_name(node: ast.AST):
    """The constant first argument of a trace_span/trace_event/
    record_span call, else None."""
    if not isinstance(node, ast.Call) or not node.args:
        return None
    f = node.func
    fname = (f.id if isinstance(f, ast.Name)
             else f.attr if isinstance(f, ast.Attribute) else "")
    if fname not in ("trace_span", "trace_event", "record_span"):
        return None
    first = node.args[0]
    if isinstance(first, ast.Constant) and isinstance(first.value, str):
        return first.value
    return None
