"""Plan visualization utilities (copied from the JAX package's
``utils.py``, which renders the stage DAG of a distributed job).

The port has no query stages yet, so the stage classes are matched by
their attributes instead of imported: a stage has ``stage_id`` and
``child``; a shuffle reader lists ``query_stage_ids``.
"""

from __future__ import annotations

from typing import List

from .physical.base import PhysicalPlan


def produce_diagram(stages: List) -> str:
    """GraphViz dot of a job's stage DAG: one cluster per stage, edges from
    producing stages into the shuffle readers that consume them."""
    out = ["digraph G {", '  rankdir="BT";']
    node_ids = {}
    counter = [0]

    def emit(plan: PhysicalPlan, stage_idx: int) -> str:
        nid = f"s{stage_idx}_n{counter[0]}"
        counter[0] += 1
        label = plan.display().replace('"', "'")
        out.append(f'    {nid} [shape=box, label="{label}"];')
        for child in plan.children():
            cid = emit(child, stage_idx)
            out.append(f"    {cid} -> {nid};")
        for sid in getattr(plan, "query_stage_ids", ()):
            node_ids.setdefault(("shuffle_in", sid), []).append(nid)
        return nid

    for stage in stages:
        out.append(f"  subgraph cluster_{stage.stage_id} {{")
        out.append(f'    label = "Stage {stage.stage_id}";')
        root = emit(stage.child, stage.stage_id)
        node_ids[("stage_root", stage.stage_id)] = root
        out.append("  }")

    # cross-stage edges: producing stage root -> consuming shuffle node
    for (kind, sid), nids in list(node_ids.items()):
        if kind != "shuffle_in":
            continue
        root = node_ids.get(("stage_root", sid))
        if root:
            for nid in nids:
                out.append(f"  {root} -> {nid} [style=dashed];")
    out.append("}")
    return "\n".join(out)
