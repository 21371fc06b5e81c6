"""Pipelined parallel ingest: overlap parse, H2D and compute.

The port of the JAX package's ``ingest`` package. Without it a scan is
a serial pull loop: the card idles while the host parses, and the host
idles while the card computes. Two overlap axes:

- **cross-table** — :func:`prime_plan` starts every leaf scan's
  parse+H2D on a shared bounded thread pool
  (``BALLISTA_INGEST_THREADS``) before any consumer pulls, so
  independent tables (q5 joins six) parse concurrently;
- **intra-query** — each scan streams through a bounded
  :class:`PrefetchHandle` queue (``BALLISTA_PREFETCH_BATCHES``,
  double-buffered by default): chunk N+1 parses on the host while chunk
  N transfers or computes on the card. A scan's producer stages each
  column in pinned host memory and copies it asynchronously on its own
  upload stream; the consumer's stream waits on the batch's upload event
  before its first use (``ColumnBatch.wait_upload``).

Default ON; ``BALLISTA_INGEST_THREADS=1`` plus
``BALLISTA_PREFETCH_BATCHES=0`` restore the serial pull loop exactly.
Results are byte-identical either way — the pipeline reorders *timing*,
never rows (pinned by tests/test_torch_ingest.py).

Observability: the io layer brackets its work in :func:`phases.phase`
timers, which land on the owning scan's ``MetricsSet`` as
``elapsed_parse``/``elapsed_h2d``, emit ``ingest.parse``/``ingest.h2d``
spans under ``BALLISTA_TRACE=1`` (the producer-thread tids make the
overlap visible), and accumulate into process totals ``phase_totals()``.
"""

from .config import (  # noqa: F401
    ingest_threads,
    prefetch_batches,
    reconfigure,
)
from .phases import (  # noqa: F401
    PhaseRecorder,
    bound_iter,
    count,
    phase,
    phase_totals,
    reset_phase_totals,
    reset_scan_counters,
    scan_counters,
)
from .pipeline import (  # noqa: F401
    KeyedLocks,
    PrefetchHandle,
    cancel_plan,
    ingest_pool,
    iter_partitions,
    parallel_map,
    pool_queue_depth,
    prime_plan,
)
