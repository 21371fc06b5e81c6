"""Compile management for the port (see the JAX package's
``compile/__init__.py``):

- :mod:`buckets`  — shape canonicalization: batch capacities quantize
  onto a geometric row-count ladder (``BALLISTA_SHAPE_BUCKETS*`` knobs),
  copied from the JAX package;
- :mod:`governor` — the process-wide cache of governed programs: eager on
  the CPU, one captured CUDA graph per call signature on a card, with
  first-call counts and seconds on the operators' metrics;
- :mod:`keys`     — value fingerprints of plan configuration for keys;
- :mod:`prewarm`  — optional first calls of scan-side programs on
  placeholder batches, concurrent with parse/upload
  (``BALLISTA_PREWARM=1``);
- :mod:`aot`      — ``BALLISTA_FUSION_AOT_DIR``: the port exports and
  loads nothing (a CUDA graph does not outlive its process).
"""

from .aot import note_knob as _note_aot_knob
from .buckets import (  # noqa: F401
    bucket_capacity,
    bucket_ladder,
    buckets_enabled,
    reconfigure,
)
from .governor import (  # noqa: F401
    MESH_NS_CAP,
    CompileGovernor,
    GovernedFunction,
    compile_stats,
    governed,
    governor,
    reset_compile_stats,
)
from .keys import fingerprint  # noqa: F401
from .prewarm import maybe_prewarm, prewarm_enabled  # noqa: F401

_note_aot_knob()
