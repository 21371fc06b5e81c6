"""The deployments a configuration names (``"deployment": {"kind": ...}``):
a standalone ``BallistaContext``, or a scheduler and executors in one
process (``LocalCluster``) with one ``BallistaContext.remote`` session
per client. Both register the TPC-H ``.tbl`` files through the port's
public sources; where the deployment says ``"cached": true`` each is
wrapped in ``CacheSource``, so its scans are served from the card after
the first."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))


def tpch_schemas():
    """(schemas, primary keys) of the TPC-H tables, as the port's types,
    from ``data/schema.json``."""
    from ballista_tpu_torch import datatypes as dt

    with open(os.path.join(HERE, "data", "schema.json")) as f:
        spec = json.load(f)
    types = {"int64": dt.Int64, "int32": dt.Int32, "utf8": dt.Utf8,
             "date32": dt.Date32, "decimal(2)": dt.Decimal(2)}
    schemas = {t: dt.schema(*[(c, types[k]) for c, k in cols])
               for t, cols in spec["columns"].items()}
    return schemas, spec["primary_keys"]


def register(ctx, data_dir: str, tables, cached: bool) -> None:
    from ballista_tpu_torch.io import CacheSource, TblSource

    schemas, pks = tpch_schemas()
    for name in tables:
        src = TblSource(os.path.join(data_dir, f"{name}.tbl"), schemas[name],
                        device=ctx.device)
        if cached:
            src = CacheSource(src)
        ctx.register_source(name, src, pks[name])


class Standalone:
    """One in-process context; every session of the traffic shares it."""

    origin = "standalone"

    def __init__(self, config, device: str, data_dir: str):
        from ballista_tpu_torch.client import BallistaContext

        self.device = device
        self.ctx = BallistaContext.standalone(
            device=device, **config["deployment"].get("settings", {}))
        register(self.ctx, data_dir, config["tables"],
                 bool(config["deployment"].get("cached", False)))

    def session(self, index: int):
        return self.ctx

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def close(self) -> None:
        self.ctx = None


class Cluster:
    """A scheduler and executors in this process; each session is its own
    remote context with its own ``session.id``."""

    origin = "cluster"

    def __init__(self, config, device: str, data_dir: str):
        from ballista_tpu_torch.distributed.executor import LocalCluster

        dep = config["deployment"]
        self.device = device
        self.data_dir = data_dir
        self.tables = config["tables"]
        self.settings = dep.get("settings", {})
        self.cached = bool(dep.get("cached", False))
        self.cluster = LocalCluster(num_executors=dep["executors"],
                                    concurrent_tasks=dep["concurrent_tasks"],
                                    device=device)

    def session(self, index: int):
        from ballista_tpu_torch.client import BallistaContext

        ctx = BallistaContext.remote(
            "localhost", self.cluster.port, device=self.device,
            **self.settings, **{"session.id": f"qbench-{index}"})
        register(ctx, self.data_dir, self.tables, self.cached)
        return ctx

    def sync(self) -> None:
        # the answer is on the host once the executors have written it
        pass

    def close(self) -> None:
        work_dirs = [e.config.work_dir for e in self.cluster.executors]
        self.cluster.shutdown()
        for d in work_dirs:
            shutil.rmtree(d, ignore_errors=True)


KINDS = {"standalone": Standalone, "cluster": Cluster}


def start(config, device: str, data_dir: str):
    return KINDS[config["deployment"]["kind"]](config, device, data_dir)
