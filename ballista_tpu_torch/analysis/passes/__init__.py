"""Pass registry: every rule the engine runs, in catalogue order.

The JAX package's ten rules, over the port. Adding a pass = subclass
:class:`ballista_tpu_torch.analysis.engine.Rule`, implement
``run(package) -> list[Finding]`` and append an instance factory here.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from ..engine import Rule
from .cancel_coverage import CancelCoverageRule
from .h2d_discipline import H2dDisciplineRule
from .lane_coverage import LaneCoverageRule
from .lock_discipline import LockDisciplineRule
from .shape import (
    DictSitesRule,
    FaultPointsRule,
    JitSitesRule,
    KnobDocsRule,
    MetricNamesRule,
)
from .sync_span import SyncSpanRule

# rule id -> zero-arg factory (instances are cheap; a fresh one per run
# keeps rules stateless across packages)
RULE_FACTORIES: Dict[str, Callable[[], Rule]] = {
    CancelCoverageRule.id: CancelCoverageRule,
    SyncSpanRule.id: SyncSpanRule,
    LaneCoverageRule.id: LaneCoverageRule,
    H2dDisciplineRule.id: H2dDisciplineRule,
    LockDisciplineRule.id: LockDisciplineRule,
    JitSitesRule.id: JitSitesRule,
    DictSitesRule.id: DictSitesRule,
    MetricNamesRule.id: MetricNamesRule,
    FaultPointsRule.id: FaultPointsRule,
    KnobDocsRule.id: KnobDocsRule,
}


def all_rules() -> List[Rule]:
    return [factory() for factory in RULE_FACTORIES.values()]


def rules_for(ids) -> List[Rule]:
    out = []
    for rid in ids:
        if rid not in RULE_FACTORIES:
            raise KeyError(
                f"unknown rule {rid!r} (known: "
                f"{', '.join(sorted(RULE_FACTORIES))})")
        out.append(RULE_FACTORIES[rid]())
    return out
