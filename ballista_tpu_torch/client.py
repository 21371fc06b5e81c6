"""Client API: BallistaContext + DataFrame, standalone mode.

The port of the standalone half of the JAX package's ``client.py``: plans
and executes in-process on one device. The context's device defaults to
``"cuda"`` and is explicit everywhere below it — sources create their
batches there, and no code path moves to another device on its own.
Remote (cluster) mode, cancellation, profiling, the plan-level caches and
the latency ledger are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .datatypes import Schema, schema as make_schema
from .errors import ExecutionError, PlanError
from . import expr as ex
from .io import CsvSource, MemTableSource, TblSource
from .logical import (
    Aggregate,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Projection,
    Repartition,
    Sort,
    TableScan,
    TableSource,
)
from .sql.parser import CreateExternalTable, parse_sql
from .sql.planner import CatalogTable, SqlPlanner


def _default_pk(schema: Schema) -> Optional[str]:
    """TPC-H-style convention: a first column named *key is the primary key."""
    names = schema.names()
    if names and names[0].endswith("key"):
        return names[0]
    return None


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ExecutionError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ExecutionError(f"unsupported device {dev}")
    return dev


class BallistaContext:
    """Entry point: table registration + SQL/DataFrame construction."""

    def __init__(self, settings: Optional[Dict[str, str]] = None,
                 device="cuda"):
        self.mode = "standalone"
        self.device = _resolve_device(device)
        self.settings = dict(settings or {})
        self._catalog: Dict[str, CatalogTable] = {}
        # SQL plan cache: repeated identical queries reuse the planned
        # DataFrame (and its physical plan); cleared on catalog change
        self._plan_cache: Dict[str, "DataFrame"] = {}

    # -- constructors -------------------------------------------------------

    @staticmethod
    def standalone(device="cuda", **settings) -> "BallistaContext":
        """In-process context on ``device`` ("cuda" by default; raises
        when there is no card, unless the caller asks for "cpu")."""
        return BallistaContext(settings or None, device=device)

    # -- registration -------------------------------------------------------

    def register_source(self, name: str, source: TableSource,
                        primary_key: Optional[str] = None) -> None:
        pk = primary_key or _default_pk(source.table_schema())
        self._catalog[name] = CatalogTable(name, source, pk)
        self._plan_cache.clear()

    def register_tbl(self, name: str, path: str, schema: Schema,
                     primary_key: Optional[str] = None, **kw) -> None:
        self.register_source(
            name, TblSource(path, schema, device=self.device, **kw),
            primary_key)

    def register_csv(self, name: str, path: str, schema: Schema,
                     has_header: bool = True,
                     primary_key: Optional[str] = None, **kw) -> None:
        self.register_source(
            name, CsvSource(path, schema, has_header=has_header,
                            device=self.device, **kw),
            primary_key,
        )

    def register_memtable(self, name: str, schema: Schema, data: Dict,
                          num_partitions: int = 1,
                          primary_key: Optional[str] = None) -> None:
        self.register_source(
            name, MemTableSource.from_pydict(schema, data, num_partitions,
                                             device=self.device),
            primary_key,
        )

    def register_table(self, name: str, df: "DataFrame") -> None:
        """Register a DataFrame as a named table (view semantics): SQL
        referencing ``name`` inlines a copy of the frame's logical plan."""
        import copy

        self._catalog[name] = CatalogTable(name, None, None,
                                           plan=copy.deepcopy(df.plan))
        self._plan_cache.clear()

    def deregister_table(self, name: str) -> None:
        self._catalog.pop(name, None)
        self._plan_cache.clear()

    def tables(self) -> List[str]:
        return sorted(self._catalog)

    # -- reads --------------------------------------------------------------

    def read_tbl(self, path: str, schema: Schema, **kw) -> "DataFrame":
        src = TblSource(path, schema, device=self.device, **kw)
        return DataFrame(self, TableScan("tbl:" + path, src))

    def read_csv(self, path: str, schema: Schema, has_header: bool = True,
                 **kw) -> "DataFrame":
        src = CsvSource(path, schema, has_header=has_header,
                        device=self.device, **kw)
        return DataFrame(self, TableScan("csv:" + path, src))

    def table(self, name: str) -> "DataFrame":
        if name not in self._catalog:
            raise PlanError(f"unknown table {name!r}")
        t = self._catalog[name]
        if t.plan is not None:  # registered DataFrame view: inline a copy
            import copy

            return DataFrame(self, copy.deepcopy(t.plan))
        return DataFrame(self, TableScan(t.name, t.source))

    # -- SQL ----------------------------------------------------------------

    def sql(self, query: str) -> "DataFrame":
        cached = self._plan_cache.get(query)
        if cached is not None:
            return cached
        stmt = parse_sql(query)
        if isinstance(stmt, CreateExternalTable):
            sch = make_schema(*[(n, t) for n, t in stmt.columns])
            if stmt.stored_as in ("CSV",):
                self.register_csv(stmt.name, stmt.location, sch,
                                  has_header=stmt.has_header)
            elif stmt.stored_as in ("TBL",):
                self.register_tbl(stmt.name, stmt.location, sch)
            else:
                raise PlanError(f"STORED AS {stmt.stored_as} unsupported")
            return DataFrame(self, None)
        df = DataFrame(self, SqlPlanner(self._catalog).plan(stmt))
        self._plan_cache[query] = df
        return df

    # -- execution ----------------------------------------------------------

    def _planner_options(self):
        from .physical.planner import PlannerOptions

        return PlannerOptions.from_settings(self.settings, self.device)

    def _collect(self, plan: LogicalPlan, phys=None):
        """Plan (unless the caller passes a cached physical plan) and
        execute; returns ``(dict of numpy arrays, phys)``."""
        from .execution import collect_physical, plan_logical

        from .physical.fusion import maybe_fuse

        if phys is None:
            phys = plan_logical(plan, self._planner_options())
        # whole-stage fusion: each pipeline stage becomes one governed
        # program (a no-op on a kept plan, which is fused already)
        phys = maybe_fuse(phys)
        nodes = _plan_nodes(phys)
        for node in nodes:  # report THIS run's metrics
            node.metrics().reset()
        try:
            return collect_physical(phys), phys
        finally:
            for node in nodes:
                node.release()


def _plan_nodes(plan) -> list:
    out = [plan]
    for c in plan.children():
        out.extend(_plan_nodes(c))
    return out


class DataFrame:
    """Lazy relational frame over a logical plan."""

    def __init__(self, ctx: BallistaContext, plan: Optional[LogicalPlan]):
        self.ctx = ctx
        self._plan = plan
        # the physical plan is kept across collects of this frame
        self._phys = None

    # -- plan access --------------------------------------------------------

    @property
    def plan(self) -> LogicalPlan:
        if self._plan is None:
            raise PlanError("this DataFrame carries no plan (DDL result)")
        return self._plan

    def schema(self) -> Schema:
        return self.plan.schema()

    def explain(self) -> str:
        from .optimizer import optimize

        return (
            "== Logical plan ==\n" + self.plan.pretty()
            + "== Optimized ==\n" + optimize(self.plan).pretty()
        )

    def logical_plan(self) -> LogicalPlan:
        return self.plan

    def physical_plan(self):
        """The physical plan of the latest collect (None before one)."""
        return self._phys

    # -- verbs --------------------------------------------------------------

    def _with(self, plan: LogicalPlan) -> "DataFrame":
        return DataFrame(self.ctx, plan)

    def select(self, *exprs: Union[ex.Expr, str]) -> "DataFrame":
        es = [ex.col(e) if isinstance(e, str) else e for e in exprs]
        return self._with(Projection(list(es), self.plan))

    def select_columns(self, *names: str) -> "DataFrame":
        return self.select(*names)

    def filter(self, predicate: ex.Expr) -> "DataFrame":
        return self._with(Filter(predicate, self.plan))

    where = filter

    def aggregate(self, group_by: Sequence[ex.Expr],
                  aggs: Sequence[ex.Expr]) -> "DataFrame":
        return self._with(Aggregate(list(group_by), list(aggs), self.plan))

    def sort(self, *sort_exprs: ex.Expr) -> "DataFrame":
        ses = [
            e if isinstance(e, ex.SortExpr) else ex.SortExpr(e)
            for e in sort_exprs
        ]
        return self._with(Sort(ses, self.plan))

    def limit(self, n: int) -> "DataFrame":
        return self._with(Limit(n, self.plan))

    def join(self, right: "DataFrame", on: Sequence[Tuple[str, str]],
             how: str = "inner") -> "DataFrame":
        return self._with(Join(self.plan, right.plan, list(on), how))

    def repartition(self, num_partitions: int,
                    hash_exprs: Optional[Sequence[ex.Expr]] = None) -> "DataFrame":
        return self._with(
            Repartition(self.plan, num_partitions,
                        list(hash_exprs) if hash_exprs else None)
        )

    # -- execution ----------------------------------------------------------

    def to_pydict(self) -> Dict[str, np.ndarray]:
        """Execute and return the result as a dict of numpy arrays
        (column name -> logical values). Needs no pandas."""
        out, self._phys = self.ctx._collect(self.plan, phys=self._phys)
        return out

    def collect(self):
        """Execute and return a pandas DataFrame."""
        import pandas as pd

        return pd.DataFrame(self.to_pydict())

    def to_pandas(self):
        return self.collect()

    def count(self) -> int:
        agg = Aggregate([], [ex.count().alias("__n")], self.plan)
        out, _ = self.ctx._collect(agg)
        return int(out["__n"][0])

    def show(self, n: int = 20) -> None:
        print(self.limit(n).collect().to_string())
