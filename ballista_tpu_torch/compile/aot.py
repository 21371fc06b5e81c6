"""``BALLISTA_FUSION_AOT_DIR`` on the port: a recorded decision.

The JAX package's ``compile/aot.py`` serializes each governed program's
StableHLO through ``jax.export`` into this directory after its first
call, so that a fresh process deserializes the artifact instead of
tracing and lowering the program again. The port has no trace and no
lowering to skip: a program's first call is an eager warm-up and the
capture of a CUDA graph (``compile/governor.py``), and a CUDA graph
lives in its process's card context, so there is nothing to write that
another process could load.

So with the knob set the port exports nothing and loads nothing: it
neither creates nor writes the directory, ``aot_loads`` and
``aot_exports`` are 0 in ``compile_stats()`` (and ``aot_loads`` in
``system.compile``), and one INFO line per process, logged as
``ballista_tpu_torch.compile`` is imported, says why. The part of
a fresh process's first call that can be moved off the query's path is
its warm-up and capture, which the prewarm pass (``BALLISTA_PREWARM``,
``compile/prewarm.py``) overlaps with the parse instead.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

log = logging.getLogger("ballista.compile.aot")


def aot_dir() -> Optional[str]:
    d = os.environ.get("BALLISTA_FUSION_AOT_DIR", "")
    return d or None


def note_knob() -> None:
    """When the knob is set, log that the port exports and loads nothing
    (module doc). ``compile/__init__`` calls it once, as the package is
    imported."""
    if aot_dir() is not None:
        log.info("BALLISTA_FUSION_AOT_DIR=%s: the port writes and reads no "
                 "program artifacts there (a CUDA graph does not outlive "
                 "its process); BALLISTA_PREWARM overlaps first calls with "
                 "the parse instead", aot_dir())
