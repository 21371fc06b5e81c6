"""Control-plane journal: restart-safe submission records.

Job statuses, stage plans and task rows already flow through the
configured :class:`KvBackend` (``SchedulerState`` persists them), so a
durable backend survives most of a restart for free. What does NOT
survive is everything the admission plane and the planning pipeline
keep in process memory:

- a queued-but-unadmitted submission's planning payload (the raw SQL +
  catalog, or the logical-plan proto bytes) lives only in the
  in-memory admission queue;
- whether an admitted job's planning pass FINISHED — a crash mid-plan
  leaves a partial stage set that would hang forever.

The journal closes both holes with two key families under the state's
namespace:

- ``cpq/{job_id}`` — one serializable record per accepted (admitted OR
  queued) submission, written at decision time in ``ExecuteQuery`` and
  deleted at the job's terminal transition. The record holds exactly
  what a restarted scheduler needs to re-run the launch:
  settings/sql/catalog bytes or plan bytes, priority, deadline,
  enqueue time and the gate's reason.
- ``cpplanned/{job_id}`` — a marker written AFTER ``enqueue_job``
  lands: its presence means the stage set is complete and task-level
  recovery applies; its absence means planning must be replayed from
  the ``cpq`` record (any partial stage/task rows are wiped first).

Failure posture: journal writes are advisory durability, not
correctness — a backend error degrades to in-memory with one loud
structured warning (``controlplane.degraded``) and queries keep
flowing. A scheduler that cannot journal serves exactly like the
pre-durability engine.
"""

from __future__ import annotations

import logging
import pickle
import time
from typing import List, Optional

log = logging.getLogger("ballista.controlplane")

QUEUE_PREFIX = "cpq"
PLANNED_PREFIX = "cpplanned"


class ControlPlaneJournal:
    """Journal of accepted submissions over the scheduler's KvBackend."""

    def __init__(self, state):
        self._state = state
        self._degraded = False

    # -- degradation ---------------------------------------------------------

    def _guard(self, op: str, fn, default=None):
        """Run one backend operation; on failure degrade loudly ONCE
        (per journal) and keep serving from memory."""
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - degrade, never refuse
            if not self._degraded:
                self._degraded = True
                log.error(
                    "control-plane journal degraded to in-memory: "
                    "backend %s failed (%s: %s) — queued submissions "
                    "will NOT survive a scheduler restart",
                    op, type(e).__name__, e)
                try:
                    from ...observability.tracing import trace_event

                    trace_event("controlplane.degraded", op=op,
                                error=str(e)[:200])
                except Exception:  # noqa: BLE001 - observability only
                    pass
            else:
                log.debug("journal %s failed (degraded)", op,
                          exc_info=True)
            return default

    @property
    def degraded(self) -> bool:
        return self._degraded

    # -- submission records --------------------------------------------------

    def record_submission(self, job_id: str, session_id: str,
                          settings: dict, sql: Optional[str] = None,
                          catalog: Optional[List[bytes]] = None,
                          plan_bytes: Optional[bytes] = None,
                          action: str = "admit", reason: str = "",
                          priority: float = 0.0,
                          deadline_ts: Optional[float] = None,
                          enqueued_at: Optional[float] = None) -> None:
        entry = {
            "job_id": job_id,
            "session_id": session_id,
            "settings": dict(settings or {}),
            "sql": sql,
            "catalog": list(catalog or []),
            "plan_bytes": plan_bytes,
            "action": action,
            "reason": reason,
            "priority": float(priority),
            "deadline_ts": deadline_ts,
            "enqueued_at": (enqueued_at if enqueued_at
                            else time.time()),
        }
        st = self._state
        self._guard("put", lambda: st.kv.put(
            st._k(QUEUE_PREFIX, job_id), pickle.dumps(entry)))

    def drop_submission(self, job_id: str) -> None:
        st = self._state
        self._guard("delete", lambda: st.kv.delete(
            st._k(QUEUE_PREFIX, job_id)))
        self._guard("delete", lambda: st.kv.delete(
            st._k(PLANNED_PREFIX, job_id)))

    def submissions(self) -> List[dict]:
        """Every journaled (non-terminal) submission, oldest first."""
        st = self._state
        rows = self._guard("scan", lambda: st.kv.get_from_prefix(
            st._k(QUEUE_PREFIX) + "/"), default=[])
        out = []
        for _k, v in rows or []:
            try:
                out.append(pickle.loads(v))
            except Exception:  # noqa: BLE001 - skip torn records
                log.warning("skipping undecodable journal record %s", _k)
        out.sort(key=lambda e: e.get("enqueued_at") or 0.0)
        return out

    # -- planned marker ------------------------------------------------------

    def mark_planned(self, job_id: str) -> None:
        """The job's full stage set + task rows are persisted and its
        ready stages are enqueued: restart recovery may trust them."""
        st = self._state
        self._guard("put", lambda: st.kv.put(
            st._k(PLANNED_PREFIX, job_id), b"1"))

    def is_planned(self, job_id: str) -> bool:
        st = self._state
        v = self._guard("get", lambda: st.kv.get(
            st._k(PLANNED_PREFIX, job_id)))
        return v is not None
