"""Adaptive query execution (AQE): re-plan from observed runtime sizes
instead of static estimates.

The port of the JAX package's ``adaptive`` package, standalone half.
The rules (``rules.py``) and knobs (``config.py``) are host-only copies;
``standalone.py`` applies them between pipeline breakers of one
collect (``BallistaContext._apply_adaptive``). Three rules, each
independently gateable (see :class:`AdaptiveConfig`):

- **shuffle partition coalescing** — merge adjacent small hash
  partitions so each reader task sees ~``target_partition_bytes``;
- **join strategy demotion** — when the build side of a planned
  co-partitioned join lands under ``broadcast_threshold_bytes``,
  broadcast it and drop the probe side's repartition;
- **skew splitting** — split a partition whose bytes exceed
  ``skew_factor`` x the median into source-fragment subranges.

The cluster replanner comes with the cluster path.
"""

from .config import AdaptiveConfig  # noqa: F401
from .rules import (  # noqa: F401
    describe_layout,
    layout_is_identity,
    plan_shuffle_reads,
    should_broadcast,
)
