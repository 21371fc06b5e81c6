"""Operator seconds of a standalone collect, beside the latency ledger's
phases.

The ledger's ``phases`` keep the JAX package's fixed schema
(``ledger.LEDGER_PHASES``). A standalone ledger also carries an
``operators`` key: the seconds of the collect's semi, anti, outer and
decorrelated joins (their ``join.build`` and ``join.probe`` spans,
``physical/join.py``) and of its scalar subqueries (``subquery.scalar``,
``execution.py``), summed out of the same flight-recorder window as the
phases and keyed ``<span>.<kind>``. These seconds also lie inside the
phases' ``device_execute``.
"""

from __future__ import annotations

from typing import Dict, Iterable

OPERATOR_SPANS = ("join.build", "join.probe", "subquery.scalar")


def operator_sums(records: Iterable[dict]) -> Dict[str, float]:
    """Sum OPERATOR_SPANS durations out of a flight-recorder window, by
    ``<span>.<kind>`` (``join.probe.semi``), or by the span's name where
    it names no kind."""
    out: Dict[str, float] = {}
    for r in records:
        name = r.get("name")
        if name in OPERATOR_SPANS:
            kind = r.get("kind")
            key = f"{name}.{kind}" if kind else name
            out[key] = out.get(key, 0.0) + float(r.get("dur", 0.0))
    return {k: round(v, 6) for k, v in out.items()}
