"""Buffer-donation eligibility tracking for fused execution.

The port of the JAX package's ``cache/donation.py``. There, a transient
batch's device buffers are donated (``donate_argnums``) to the one
governed XLA program that consumes it, which may then write its output
in place. Torch has no ``donate_argnums``: a tensor lives while anything
references it, and the caching allocator reuses its block once nothing
does. So donation here means that the batch gives up its references
early, and the guarantee is the same as the JAX package's: the engine
proves the batch has exactly one consumer and is never read again.

- On a card's graph path, once the batch's tensors are copied into the
  program's static input buffers, the batch drops them, before the
  replay and the copies out of the graph, so the allocator can hand
  their blocks to those copies and to the rest of the collect
  (``compile/governor.py``).
- Eagerly, and on the CPU, the batch drops them once the program
  returns.
- A donated batch raises on any later read of its columns or selection
  (``ColumnBatch.donate``). Outputs of the program that alias an input
  tensor keep it alive: nothing is freed that anything still reads.

Eligibility is the JAX package's:

- A :class:`~ballista_tpu_torch.columnar.ColumnBatch` carries a
  ``_transient`` flag, ``False`` by default. Only the sites that
  CREATE a single-owner batch mark it: scan emission when the batch is
  *not* being pinned by the device table cache, ``concat_batches`` for
  ``len > 1``, the pipeline chain's per-batch output and the aggregates'
  outputs. Cached / pinned / materialized batches are never marked, so
  they are never donation-eligible by construction.
- :func:`consume_transient` claims the flag exactly once. A call site
  that donates MUST consume first — a second alias of the same batch
  then sees ``False`` and takes the plain path.

``num_rows`` is never given up: ``MetricsSet.record_output_batch`` keeps
that scalar after the batch body is consumed, and the donated-bytes
counter leaves it out, as the JAX package's does.

``BALLISTA_DONATION=off`` disables the whole tier; marked flags are
simply never consumed.
"""

from __future__ import annotations

import os
import threading

_OFF = ("off", "0", "false", "no")


def donation_enabled() -> bool:
    """``BALLISTA_DONATION``: donate single-consumer intermediate
    batches to the governed programs that consume them (default on)."""
    return os.environ.get("BALLISTA_DONATION", "on").lower() not in _OFF


def mark_transient(batch) -> None:
    """Mark ``batch`` single-owner: its creator guarantees no other
    reference will read its tensors after the one consumer."""
    batch._transient = True


def is_transient(batch) -> bool:
    return bool(getattr(batch, "_transient", False))


def consume_transient(batch) -> bool:
    """Claim the donation right: True exactly once per marked batch.
    Clearing before the donating call means an aliasing second consumer
    can never double-donate the same batch."""
    if getattr(batch, "_transient", False):
        batch._transient = False
        return True
    return False


_lock = threading.Lock()
_donated_calls = 0
_donated_bytes = 0


def record_donation(nbytes: int) -> None:
    global _donated_calls, _donated_bytes
    with _lock:
        _donated_calls += 1
        _donated_bytes += int(nbytes)


def donation_stats() -> dict:
    with _lock:
        return {
            "donated_buffers": _donated_calls,
            "donated_bytes": _donated_bytes,
            "enabled": donation_enabled(),
        }


def reset_donation_stats() -> None:
    """Re-baseline the cumulative counters (phases of a run, tests)."""
    global _donated_calls, _donated_bytes
    with _lock:
        _donated_calls = 0
        _donated_bytes = 0
