"""The repo's pandas TPC-H oracle (``benchmarks/tpch/oracle.py``) for
the port's runners.

That file's one import of the engine is ``from .schema_def import
TPCH_SCHEMAS``, and ``schema_def`` imports the JAX package. ``load``
executes the oracle's own source as a module of its own with that one
line reading the port's equal mapping (``testing/tpch_schema.py``)
instead; every query function is the file's, unchanged. The
``benchmarks.tpch`` modules the JAX package's tests import stay as they
are.
"""

from __future__ import annotations

import os
import types

_SCHEMA_IMPORT = "from .schema_def import TPCH_SCHEMAS"
_PORT_IMPORT = ("from ballista_tpu_torch.testing.tpch_schema import "
                "TPCH_SCHEMAS")
_module = None


def oracle_path() -> str:
    from ..benchmarks import REPO_ROOT

    return os.path.join(REPO_ROOT, "benchmarks", "tpch", "oracle.py")


def load() -> types.ModuleType:
    """The oracle module (``load_tables``, ``ORACLES`` and the query
    functions); loaded once a process. Needs pandas."""
    global _module
    if _module is None:
        path = oracle_path()
        with open(path) as f:
            src = f.read()
        if src.count(_SCHEMA_IMPORT) != 1:
            raise ImportError(f"{path} no longer imports its schemas as "
                              f"{_SCHEMA_IMPORT!r}")
        mod = types.ModuleType("ballista_tpu_torch.testing._tpch_oracle")
        mod.__file__ = path
        exec(compile(src.replace(_SCHEMA_IMPORT, _PORT_IMPORT), path,
                     "exec"), mod.__dict__)
        _module = mod
    return _module
