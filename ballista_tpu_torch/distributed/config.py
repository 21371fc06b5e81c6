"""Layered configuration for the scheduler/executor binaries.

Mirrors the reference's configure_me layering (reference:
rust/scheduler/src/main.rs:65-66 + scheduler_config_spec.toml /
executor_config_spec.toml; documented order in
docs/user-guide/src/configuration.md:1-14):

    defaults < /etc/ballista-tpu/<role>.toml < --config-file
             < env BALLISTA_<ROLE>_* < CLI flags

Files are TOML (stdlib tomllib); keys use underscores and match the CLI
flag names (``bind_host``, ``port``, ...).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

SYSTEM_CONFIG_DIR = "/etc/ballista-tpu"


def load_toml(path: str) -> Dict[str, Any]:
    import tomllib

    with open(path, "rb") as fh:
        return tomllib.load(fh)


def layered_config(
    role: str,
    defaults: Dict[str, Any],
    config_file: Optional[str] = None,
    env: Optional[Dict[str, str]] = None,
    cli: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Merge config layers for ``role`` ("scheduler" | "executor").

    ``cli`` holds only flags the user EXPLICITLY passed (argparse values
    that are None are treated as absent). Values from files/env are
    coerced to the default's type when one exists."""
    env = os.environ if env is None else env
    out = dict(defaults)

    def apply(layer: Dict[str, Any]):
        for k, v in layer.items():
            if v is None:
                continue
            base = defaults.get(k)
            if base is not None and not isinstance(v, type(base)):
                try:
                    v = type(base)(v)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"config key {k!r}: cannot coerce {v!r} to "
                        f"{type(base).__name__}"
                    )
            out[k] = v

    system_path = os.path.join(SYSTEM_CONFIG_DIR, f"{role}.toml")
    if os.path.exists(system_path):
        apply(load_toml(system_path))
    if config_file:
        apply(load_toml(config_file))
    prefix = f"BALLISTA_{role.upper()}_"
    apply({
        k[len(prefix):].lower(): v
        for k, v in env.items() if k.startswith(prefix)
    })
    apply(cli or {})
    return out
