"""Stable, hashable compile-cache keys.

A copy of the JAX package's ``compile/keys.py``. A governed key must
capture everything a governed function reads from *Python* state
(operator mode, expressions, schemas, static capacities). Whatever the
function reads from its *arguments* — tensor shapes, dtypes, batch
structure, the dictionaries riding on columns — is the call signature,
which each governed entry specializes on by itself (one program per
signature, ``governor.py``), and must NOT be in the key, or sharing
across operator instances (the whole point of the governor) breaks.

``fingerprint`` turns expression trees and schemas into hashable tuples
by value: two operator instances built from the same logical plan (e.g.
before and after an adaptive re-plan) produce equal fingerprints and so
share one compiled entry.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def fingerprint(obj: Any):
    """Hashable value-signature of plan configuration objects.

    Covers the engine's expression AST generically (class name + public
    attributes, recursively), frozen datatypes (already hashable by
    value), and plain containers. Unknown objects fall back to
    ``(classname, repr)`` — safe for key purposes as long as their repr
    reflects their trace-relevant state."""
    if obj is None or isinstance(obj, (str, int, float, bool, bytes)):
        return obj
    if isinstance(obj, (tuple, list)):
        return tuple(fingerprint(x) for x in obj)
    if isinstance(obj, (set, frozenset)):
        return ("set",) + tuple(sorted(fingerprint(x) for x in obj))
    if isinstance(obj, dict):
        return tuple(sorted((str(k), fingerprint(v))
                            for k, v in obj.items()))
    if isinstance(obj, np.generic):
        # np.generic is host-resident by construction, never a device sync
        # ballista: ignore[sync-span]
        return obj.item()
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.shape, str(obj.dtype), obj.tobytes())
    mod = type(obj).__module__ or ""
    if mod.endswith(".datatypes"):
        return obj  # DataType/Field/Schema: frozen + hashable by value
    # the prefix matches this package's own modules (``ballista_tpu_torch``
    # starts with ``ballista_tpu``) on purpose: the port's expression
    # nodes fingerprint by value exactly as the JAX package's do
    if mod.startswith("ballista_tpu"):
        d = getattr(obj, "__dict__", None)
        if d is not None:
            return (type(obj).__name__,) + tuple(
                sorted((k, fingerprint(v)) for k, v in d.items()
                       if not k.startswith("_"))
            )
    return (type(obj).__name__, repr(obj))
