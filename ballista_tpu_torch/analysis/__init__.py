"""The JAX package's AST static analysis (``ballista_tpu/analysis/``),
over the port.

One framework (``engine.py``: parse-once package model, structured
findings, ``# ballista: ignore[rule]`` suppressions, committed
baseline; ``callgraph.py``: shared scope/import-resolving index) and ten
passes (``passes/``): cancel-coverage, sync-span, lane-coverage,
h2d-discipline and lock-discipline, plus the code-shape lints
jit-sites, dict-sites, metric-names, fault-points and knob-docs. The
rules that name JAX idioms (h2d-discipline, sync-span, jit-sites) look
for their torch counterparts.

Run by ``__main__.py`` (``python -m ballista_tpu_torch.analysis
--baseline ballista_tpu_torch/analysis/baseline.json``), which analyzes
``ballista_tpu_torch/`` only.

Import discipline: this package is stdlib-only at import time and uses
only intra-package relative imports, so ``__main__.py`` can load it WITHOUT
executing ``ballista_tpu_torch/__init__`` (which imports torch) — the
pure-AST rules then run without torch; only the registry-backed rules
(lane-coverage, metric-names, fault-points, knob-docs) import live
modules of the port, lazily, inside ``run``.
"""

from .engine import (  # noqa: F401
    AnalysisResult,
    Baseline,
    Finding,
    Package,
    Rule,
    analyze,
    make_finding,
)
from .passes import RULE_FACTORIES, all_rules, rules_for  # noqa: F401
