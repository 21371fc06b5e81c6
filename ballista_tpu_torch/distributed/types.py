"""Scheduler domain types (reference: rust/core/src/serde/scheduler/mod.rs:
34-253 — Action/PartitionId/PartitionLocation/ExecutorMeta/PartitionStats).

The port's copy of the JAX package's ``distributed/types.py``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass(frozen=True)
class ExecutorMeta:
    id: str
    host: str
    port: int  # data-plane port
    num_devices: int = 1
    # last-heartbeat resource gauges (rss_bytes, device_bytes,
    # inflight_tasks, ingest_pool_depth, peak_host_bytes) for the
    # scheduler's health plane; None from executors predating the field
    resources: Optional[Dict[str, int]] = None


@dataclass(frozen=True)
class PartitionId:
    job_id: str
    stage_id: int
    partition_id: int

    def key(self) -> str:
        return f"{self.job_id}/{self.stage_id}/{self.partition_id}"


@dataclass
class PartitionLocation:
    job_id: str
    stage_id: int
    partition_id: int  # PRODUCER partition for shuffled stages
    executor_id: str
    host: str
    port: int
    path: str = ""
    stats: Optional[Dict[str, int]] = None
    # hash-shuffled stages: which consumer partition this file feeds
    shuffle_output: Optional[int] = None


@dataclass
class TaskStatus:
    partition: PartitionId
    # one of: None (pending), "running", "completed", "failed"
    state: Optional[str] = None
    executor_id: Optional[str] = None
    error: Optional[str] = None
    path: Optional[str] = None
    stats: Optional[Dict[str, int]] = None
    # assignment wall time; drives straggler detection (speculation)
    started_at: Optional[float] = None
    # per-operator execution metrics shipped with completion
    # ({"operators": [...], "elapsed_total": float}; see observability)
    metrics: Optional[dict] = None
    # version of the stage plan the task ran against; reports from a
    # superseded version (adaptive re-planning) are dropped
    stage_version: int = 0


@dataclass
class StagePlan:
    """One stage row as stored by the scheduler state (see
    SchedulerState.save_stage_plan for field semantics)."""

    plan_bytes: bytes
    num_partitions: int
    deps: list
    shuffle_spec: Optional[tuple] = None
    mesh_devices: int = 0
    # bumped each time adaptive re-planning rewrites the stage; task
    # definitions carry it and status reports echo it back
    version: int = 0
    # adaptive reader layouts: dep stage_id -> List[List[(out_lo,
    # out_hi, prod_lo, prod_hi)]] (see adaptive/rules.py)
    reader_layouts: Optional[dict] = None


@dataclass
class JobStatus:
    state: str  # queued|running|completed|failed|cancelled
    error: Optional[str] = None
    partition_locations: Optional[list] = None
    # stage_id -> aggregated task metrics (filled when completed)
    stage_metrics: Optional[dict] = None
    # terminal "cancelled" provenance: client|timeout|deadline|
    # slow-query-kill|drain (read with getattr — durable backends may
    # hold pickles from before the field existed)
    cancel_reason: Optional[str] = None
