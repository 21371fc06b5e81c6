"""AQE knobs: the ``adaptive.*`` section of the Ballista configuration.
A copy of the JAX package's ``adaptive/config.py``.

Configuration travels as the same string-keyed ``settings`` map every
other knob uses (``BallistaContext.standalone(**settings)``). Resolution
order per key:

    settings["adaptive.X"]  >  env BALLISTA_ADAPTIVE_X  >  default

Keys:

- ``adaptive.enabled``                    master switch (default on)
- ``adaptive.target_partition_bytes``     coalescing target (64 MiB)
- ``adaptive.broadcast_threshold_bytes``  join demotion threshold (32 MiB)
- ``adaptive.skew_factor``                skew = factor x median (4.0)
- ``adaptive.coalesce`` / ``adaptive.broadcast`` / ``adaptive.skew``
                                          per-rule gates (default on)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

_TRUE = ("1", "on", "true", "yes", "")
_FALSE = ("0", "off", "false", "no", "none")


def _as_bool(raw: str, key: str, default: bool) -> bool:
    v = str(raw).strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    import logging

    logging.getLogger("ballista.adaptive").warning(
        "unrecognized %s value %r; keeping %s", key, raw,
        "on" if default else "off")
    return default


@dataclass(frozen=True)
class AdaptiveConfig:
    enabled: bool = True
    # merge adjacent shuffle partitions up to roughly this many bytes per
    # reader task (Spark's spark.sql.adaptive.advisoryPartitionSizeInBytes
    # plays the same role)
    target_partition_bytes: int = 64 * 1024 * 1024
    # a completed build side under this many bytes demotes a planned
    # shuffle-hash join to a broadcast join
    broadcast_threshold_bytes: int = 32 * 1024 * 1024
    # a partition is skewed when bytes > skew_factor x median(bytes) AND
    # > target_partition_bytes (both guards, like Spark's skewedPartition
    # Factor + ThresholdInBytes pair)
    skew_factor: float = 4.0
    coalesce: bool = True
    broadcast: bool = True
    skew: bool = True

    @staticmethod
    def from_settings(settings: Optional[Dict[str, str]] = None,
                      env: Optional[Dict[str, str]] = None
                      ) -> "AdaptiveConfig":
        s = settings or {}
        env = os.environ if env is None else env

        def raw(key: str):
            if key in s:
                return s[key]
            return env.get("BALLISTA_" + key.upper().replace(".", "_"))

        def boolean(key: str, default: bool) -> bool:
            v = raw(key)
            return default if v is None else _as_bool(v, key, default)

        def integer(key: str, default: int) -> int:
            v = raw(key)
            if v is None:
                return default
            try:
                n = int(str(v).strip())
            except ValueError:
                raise ValueError(
                    f"config key {key!r}: expected an integer byte count, "
                    f"got {v!r}") from None
            if n <= 0:
                raise ValueError(f"config key {key!r}: must be > 0")
            return n

        def floating(key: str, default: float) -> float:
            v = raw(key)
            if v is None:
                return default
            try:
                f = float(str(v).strip())
            except ValueError:
                raise ValueError(
                    f"config key {key!r}: expected a number, got {v!r}"
                ) from None
            if f <= 1.0:
                raise ValueError(f"config key {key!r}: must be > 1")
            return f

        return AdaptiveConfig(
            enabled=boolean("adaptive.enabled", True),
            target_partition_bytes=integer(
                "adaptive.target_partition_bytes", 64 * 1024 * 1024),
            broadcast_threshold_bytes=integer(
                "adaptive.broadcast_threshold_bytes", 32 * 1024 * 1024),
            skew_factor=floating("adaptive.skew_factor", 4.0),
            coalesce=boolean("adaptive.coalesce", True),
            broadcast=boolean("adaptive.broadcast", True),
            skew=boolean("adaptive.skew", True),
        )

    @property
    def coalesce_enabled(self) -> bool:
        return self.enabled and self.coalesce

    @property
    def broadcast_enabled(self) -> bool:
        return self.enabled and self.broadcast

    @property
    def skew_enabled(self) -> bool:
        return self.enabled and self.skew
