"""Error types for ballista-tpu.

Mirrors the error taxonomy of the reference engine's ``BallistaError`` enum
(reference: rust/core/src/error.rs:31-163) with Python-idiomatic exception
classes instead of a Rust enum.
"""

from __future__ import annotations


class BallistaError(Exception):
    """Base error for all ballista-tpu failures."""


class NotImplementedError_(BallistaError):
    """Feature recognized but not yet supported."""


class PlanError(BallistaError):
    """Logical/physical planning failure (bad column, type mismatch, ...)."""


class SqlError(BallistaError):
    """SQL tokenizing/parsing failure."""


class SchemaError(BallistaError):
    """Schema mismatch or unknown field."""


class ExecutionError(BallistaError):
    """Runtime failure while executing a physical plan."""


class SerdeError(BallistaError):
    """Plan (de)serialization failure."""


class IoError(BallistaError):
    """File/scan/shuffle IO failure."""


class ClusterError(BallistaError):
    """Scheduler/executor control-plane failure. Carries the job id
    when one is known (e.g. a client-side timeout), so the caller can
    inspect the job in ``system.queries`` after the fact."""

    def __init__(self, message: str, job_id: "str | None" = None):
        super().__init__(message)
        self.job_id = job_id


class AdmissionRejected(ClusterError):
    """A submission was SHED by the scheduler's admission plane (quota
    exhausted, queue full, queue-time timeout, draining cluster).
    Retryable by contract: ``retry_after_secs`` tells the client when a
    resubmission has a chance (``remote_collect`` honors it
    automatically within the job timeout). Like
    :class:`ShuffleFetchError`, the message format is a wire contract —
    queue-timeout sheds travel as a terminal failed JobStatus whose
    error string the client re-parses into this class."""

    PREFIX = "ADMISSION_SHED"

    def __init__(self, reason: str, retry_after_secs: float = 1.0,
                 detail: str = "", job_id: "str | None" = None):
        self.reason = reason
        self.retry_after_secs = max(float(retry_after_secs), 0.0)
        msg = (f"{self.PREFIX} reason={reason} "
               f"retry_after={self.retry_after_secs:.3f}")
        if detail:
            msg += f": {detail}"
        super().__init__(msg, job_id=job_id)

    @classmethod
    def parse(cls, message: str):
        """Returns ``(reason, retry_after_secs)`` or None. The tag is
        located anywhere in the message (reporters may prefix it)."""
        idx = (message or "").find(cls.PREFIX)
        if idx < 0:
            return None
        body = message[idx + len(cls.PREFIX):].split(":", 1)[0]
        try:
            fields = dict(kv.split("=", 1) for kv in body.split())
            return (fields.get("reason", "unknown"),
                    float(fields.get("retry_after", 1.0)))
        except (KeyError, ValueError):
            return None


class QueryCancelled(BallistaError):
    """A query was cooperatively cancelled (client CancelJob, server
    deadline, slow-query kill, or executor drain). Terminal but NOT a
    failure: surfaces record status ``cancelled`` with the reason."""

    def __init__(self, reason: str = "client",
                 job_id: "str | None" = None):
        self.reason = reason
        self.job_id = job_id
        suffix = f" [job {job_id}]" if job_id else ""
        super().__init__(f"query cancelled ({reason}){suffix}")


class FaultInjected(IoError):
    """Raised by an armed fault point (testing/faults.py). Subclasses
    IoError so injected task failures look transient to the scheduler's
    recovery (``FaultInjected:`` is in TRANSIENT_ERRORS) and exercise
    the retry-budget machinery exactly like a real IO hiccup."""


class ShuffleFetchError(IoError):
    """A consumer could not fetch a producer stage's shuffle output
    (producer executor dead or its data lost). Carries enough structure
    in the message for the scheduler to re-queue the lost producer
    partitions — the string format is the wire contract, since task
    failures travel as plain error strings (TaskStatus.failed.error).
    """

    PREFIX = "SHUFFLE_FETCH_FAILED"

    def __init__(self, stage_id: int, partition_ids, executor_id: str,
                 cause: str):
        self.stage_id = stage_id
        self.partition_ids = sorted(set(partition_ids))
        self.executor_id = executor_id
        parts = ",".join(str(p) for p in self.partition_ids)
        super().__init__(
            f"{self.PREFIX} stage={stage_id} partitions={parts} "
            f"executor={executor_id}: {cause}"
        )

    @classmethod
    def parse(cls, message: str):
        """Returns (stage_id, [partition_ids], executor_id) or None. The
        tag is located anywhere in the message (reporters may prefix the
        exception class name)."""
        idx = (message or "").find(cls.PREFIX)
        if idx < 0:
            return None
        message = message[idx:]
        try:
            fields = dict(
                kv.split("=", 1)
                for kv in message[len(cls.PREFIX):].split(":", 1)[0].split()
            )
            parts = [int(p) for p in fields["partitions"].split(",") if p]
            return int(fields["stage"]), parts, fields.get("executor", "")
        except (KeyError, ValueError):
            return None
