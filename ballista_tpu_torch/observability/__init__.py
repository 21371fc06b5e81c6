"""Observability: operator metrics, EXPLAIN ANALYZE plumbing, tracing,
query profiler artifacts, memory accounting and the live health plane.

The measurement substrate the reference engine never grew (its
PartitionStats proto is declared but unpopulated, and DataFusion-side
operator metrics never cross the Ballista wire): every PhysicalPlan
carries a lock-cheap ``MetricsSet``; executors ship per-task metrics back
with task completion; the scheduler aggregates them per stage; a
span-style tracer (``BALLISTA_TRACE=1``) writes JSON-lines trace files
with structural span/parent ids and flow correlation; the profiler
(``df.profile()`` / ``BALLISTA_PROFILE=<dir>``) merges spans, ingest
phases, compile attribution and operator metrics into one
Chrome-trace/Perfetto artifact per query; ``memory.py`` tracks host
bytes by category plus device bytes; and ``health.py`` serves
``/healthz`` + Prometheus ``/metrics`` + ``/debug/queries`` on the
scheduler and every executor.
"""

from .metrics import (  # noqa: F401
    MetricsSet,
    QueryMetrics,
    collect_plan_metrics,
    force_metrics,
    instrument_execute,
    merge_operator_metrics,
    metrics_enabled,
    snapshot_plan_metrics,
)
from .tracing import (  # noqa: F401
    current_flow,
    flight_recorder_enabled,
    flow,
    ring_records,
    set_process_identity,
    trace_enabled,
    trace_event,
    trace_span,
)
from .health import (  # noqa: F401
    HealthServer,
    QueryLog,
    maybe_start_health_server,
    metrics_port_from_env,
    render_prometheus,
)
from .profiler import Profiler, profile_call, profile_dir  # noqa: F401
from .systables import (  # noqa: F401
    SYSTEM_TABLES,
    SystemSnapshot,
    SystemTableSource,
    build_query_record,
    is_system_table,
    record_query,
)
