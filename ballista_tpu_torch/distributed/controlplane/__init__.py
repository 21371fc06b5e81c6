"""Durable elastic control plane (ROADMAP item 4).

The reference Ballista's HA story is a sled/etcd ``ConfigBackendClient``
holding ALL scheduler state so a standby can take over (reference:
rust/scheduler/src/state/etcd.rs), and its k8s deployment scales
executors independently of the scheduler. This package closes the same
gap for this engine with three coordinated legs:

- :mod:`.journal` — every control-plane transition that only lived in
  one process's memory (admission-queue entries, the planned marker)
  is journaled through the configured :class:`KvBackend`, so a
  scheduler restart against the same sqlite file / etcd namespace
  loses NOTHING a client is still waiting on.
- :mod:`.recovery` — one explicit :func:`recover` pass a restarted
  scheduler runs before serving: re-pumps queued-but-unadmitted
  submissions in priority/deadline order, re-queues live tasks of
  in-flight jobs whose producers' shuffle outputs are still routable,
  fails orphans loudly, and emits a ``controlplane.recover`` trace
  event with counters.
- :mod:`.autoscaler` — a demand-driven loop over queue depth, the
  rate-based ETA plane and the admission saturation signals that
  spawns executors (LocalCluster hook or a subprocess launcher for
  the real binary) and drains idle ones, bounded by
  ``autoscale.min/max_executors``; every decision lands in
  ``system.autoscaler`` and Prometheus gauges.
- :mod:`.costs` — observed per-stage costs keyed by plan digest feed
  the NEXT submission's initial plan (shuffle partition counts,
  broadcast-vs-shuffle join choice); AQE still corrects mid-flight.

Failure posture (shared by every leg): a backend that errors degrades
the control plane to in-memory with ONE loud structured warning —
queries are never refused because durability is unavailable.
"""

from .autoscaler import (Autoscaler, AutoscalerConfig,
                         SubprocessExecutorLauncher)
from .costs import CostFeedbackStore
from .journal import ControlPlaneJournal
from .recovery import RecoveryReport, recover

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "ControlPlaneJournal",
    "CostFeedbackStore",
    "RecoveryReport",
    "SubprocessExecutorLauncher",
    "recover",
]
