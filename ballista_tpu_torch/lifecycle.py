"""Query lifecycle control plane: cooperative cancellation tokens.

The port of the JAX package's ``lifecycle.py`` (the standalone half: the
cluster's CancelJob path is not ported). It keeps its own reader of the
slow-query-kill knob, which the JAX package reads from its health plane.

- :class:`CancelToken` — a one-shot flag with a reason, fired by
  ``ctx.cancel()`` or the slow-query killer.
- :func:`bind_token` / :func:`check_cancel` — the token rides a
  thread-local so batch loops (scan chunks, the prefetch producers, the
  collect) can check it without plumbing a parameter through every
  operator. A check costs one thread-local read when no token is bound.

Cancellation is COOPERATIVE: work stops at batch/partition boundaries,
never mid-kernel. A fired token raises :class:`QueryCancelled`
(``ballista_tpu_torch.errors``).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional

from .errors import QueryCancelled


class CancelToken:
    """One-shot cooperative cancellation flag.

    ``cancel(reason)`` is idempotent (the FIRST reason wins — a drain
    cancelling an already job-cancelled task must not relabel it);
    ``check()`` raises :class:`QueryCancelled` once fired. ``wait()``
    lets watchdogs block on it."""

    __slots__ = ("_event", "reason", "job_id")

    def __init__(self, job_id: Optional[str] = None):
        self._event = threading.Event()
        self.reason: Optional[str] = None
        self.job_id = job_id

    def cancel(self, reason: str = "client") -> bool:
        """Fire the token; returns True when this call was the one that
        fired it."""
        if self._event.is_set():
            return False
        # benign race: two concurrent first-cancels may both write the
        # reason; either label is truthful and the event fires once
        self.reason = reason
        self._event.set()
        return True

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def check(self) -> None:
        if self._event.is_set():
            raise QueryCancelled(self.reason or "unknown",
                                 job_id=self.job_id)


_tls = threading.local()


def slow_query_kill_secs() -> Optional[float]:
    """``BALLISTA_SLOW_QUERY_KILL_SECS``: standalone collects running
    longer than this fire their cancel token. None when unset/invalid."""
    v = os.environ.get("BALLISTA_SLOW_QUERY_KILL_SECS", "")
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        return None


def current_token() -> Optional[CancelToken]:
    """The token bound to the calling thread, or None."""
    return getattr(_tls, "token", None)


@contextmanager
def bind_token(token: Optional[CancelToken]):
    """Bind ``token`` as the calling thread's current cancel token for
    the duration of the block (None = explicitly unbound). Nested binds
    restore the outer token on exit."""
    prev = getattr(_tls, "token", None)
    _tls.token = token
    try:
        yield token
    finally:
        _tls.token = prev


def check_cancel() -> None:
    """Raise :class:`QueryCancelled` when the thread's bound token has
    fired; no-op (one thread-local read) otherwise. Sprinkled at batch
    and partition boundaries: scan chunks, partition pulls and the
    standalone collect."""
    token = getattr(_tls, "token", None)
    if token is not None and token._event.is_set():
        raise QueryCancelled(token.reason or "unknown",
                             job_id=token.job_id)


@contextmanager
def slow_query_killer(token: CancelToken):
    """The KILL variant of ``watch_slow_query``: when
    ``BALLISTA_SLOW_QUERY_KILL_SECS`` is set, arm a watchdog that fires
    ``token`` (reason ``slow-query-kill``) once the wrapped block has
    run that long. The query then stops at its next batch boundary and
    raises :class:`QueryCancelled`. No-op (and no timer thread) when the
    knob is unset."""
    kill = slow_query_kill_secs()
    if kill is None:
        yield
        return
    timer = threading.Timer(kill, token.cancel,
                            args=("slow-query-kill",))
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()
