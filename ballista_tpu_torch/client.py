"""Client API: BallistaContext + DataFrame, standalone mode.

The port of the standalone half of the JAX package's ``client.py``: plans
and executes in-process on one device. The context's device defaults to
``"cuda"`` and is explicit everywhere below it — sources create their
batches there, and no code path moves to another device on its own.

A collect runs as the JAX package's standalone collect does: fusion,
the opt-in result cache, every scan primed on the ingest pool before the
first pull (``ingest.prime_plan``; scans serve from the device table
cache when they can), the standalone adaptive pass over the primed tree
(``adaptive/standalone.py``, once per kept plan, then re-fused), one
cancel token bound around it (``ctx.cancel()`` from another thread), and
``cancel_plan`` in a ``finally``. Remote (cluster) mode, prewarming,
profiling, EXPLAIN and the latency ledger are not ported yet.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
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
        # in-flight collects' cancel tokens (ctx.cancel reaches them)
        self._lifecycle_lock = threading.Lock()
        self._active_tokens: List = []
        # warm-path attribution of this context's collects: scan
        # partitions served by the table cache, results served by the
        # result cache
        self.cache_hits = {"table": 0, "result": 0}

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

    @contextmanager
    def _track_lifecycle(self, token):
        """Register an in-flight collect's cancel token for the duration
        of the collect, so a concurrent ``ctx.cancel()`` can reach it."""
        with self._lifecycle_lock:
            self._active_tokens.append(token)
        try:
            yield token
        finally:
            with self._lifecycle_lock:
                self._active_tokens.remove(token)

    def cancel(self, reason: str = "client") -> int:
        """Cooperatively cancel this context's in-flight collects (call
        from another thread). Each stops at its next batch boundary and
        raises :class:`errors.QueryCancelled`; its scan producers stop at
        their next chunk. Returns how many collects this call
        cancelled."""
        with self._lifecycle_lock:
            tokens = list(self._active_tokens)
        return sum(bool(t.cancel(reason)) for t in tokens)

    def _collect(self, plan: LogicalPlan, phys=None):
        """Plan (unless the caller passes a cached physical plan) and
        execute; returns ``(dict of numpy arrays, phys)``. One cancel
        token per collect: ``cancel()`` fires it from another thread,
        the slow-query killer on timeout, and every batch boundary under
        the bind checks it."""
        from .lifecycle import CancelToken, bind_token, slow_query_killer

        token = CancelToken()
        with self._track_lifecycle(token), bind_token(token), \
                slow_query_killer(token):
            return self._collect_governed(plan, phys)

    def _collect_governed(self, plan: LogicalPlan, phys=None):
        from .cache import results as _results
        from .execution import collect_physical, plan_logical
        from .ingest import cancel_plan, prime_plan
        from .physical.fusion import maybe_fuse

        if phys is None:
            phys = plan_logical(plan, self._planner_options())
        # whole-stage fusion: each pipeline stage becomes one governed
        # program (a no-op on a kept plan, which is fused already)
        phys = maybe_fuse(phys)
        # plan-fingerprint result cache (cache/results.py, opt-in): a
        # repeat of the same fused plan over unchanged files with the
        # same settings on the same device returns the stored result
        # without executing
        rc_key = None
        if _results.result_cache_enabled(self.settings):
            # keyed on the plan as planned: an adapted plan is a function
            # of the planned one and the (signed) files it read
            rc_key = _results.plan_key(getattr(phys, "_planned", phys),
                                       self.settings, self.device)
            cached = _results.process_result_cache().lookup(rc_key)
            if cached is not None:
                self._annotate_cache_hits(result_hit=True)
                return cached, phys
        for node in _plan_nodes(phys):  # report THIS run's metrics
            node.metrics().reset()
        # parallel ingest: start parse+H2D of every leaf scan now, so
        # independent tables overlap each other and the adaptive pass's
        # repartition materializations consume running streams. Scan
        # instances survive the adaptive rewrite (with_new_children
        # keeps leaves), so the primed handles are consumed by the
        # adapted tree; whatever an early exit leaves unconsumed is
        # cancelled, never leaked
        prime_plan(phys)
        try:
            phys = self._apply_adaptive(phys)
            data = collect_physical(phys)
        finally:
            cancel_plan(phys)
            # join builds and repartitioned batches of the tree that ran;
            # scan batches the table cache pins stay with the cache
            for node in _plan_nodes(phys):
                node.release()
        if rc_key is not None:
            _results.process_result_cache().fill(rc_key, data)
        self._annotate_cache_hits(phys)
        return data, phys

    def _apply_adaptive(self, phys):
        """Standalone adaptive execution: rewrite the planned tree from
        observed repartition histograms (``adaptive/standalone.py``).
        Runs once per plan — a kept DataFrame keeps the adapted tree,
        whose layouts stay frozen — then re-fuses what the rewrite
        restructured (a demoted join's probe chain is left unfused, so
        the join keeps the programs it has)."""
        if getattr(phys, "_adaptive_applied", False):
            return phys
        from .adaptive import AdaptiveConfig
        from .adaptive.standalone import apply_adaptive_rules
        from .physical.fusion import fuse_plan, fusion_enabled

        planned = phys
        conf = AdaptiveConfig.from_settings(self.settings)
        if conf.enabled:
            phys = apply_adaptive_rules(phys, conf)
            if fusion_enabled():
                phys = fuse_plan(phys, fuse_joins=False)
                # without the marker the next collect's maybe_fuse would
                # fuse the demoted join's probe chain after all
                phys._fusion_applied = True
        if phys is not planned:
            phys._planned = planned
        phys._adaptive_applied = True
        return phys

    def _annotate_cache_hits(self, phys=None, result_hit=False) -> None:
        """Warm-path attribution of this context (``cache_hits``): the
        plan's ScanExec ``table_cache_hits`` counters of THIS collect
        (reset at its start) and/or a result-cache hit."""
        hits = 0
        if phys is not None:
            for node in _plan_nodes(phys):
                hits += int(node.metrics()._counters.get(
                    "table_cache_hits", 0))
        self.cache_hits["table"] += hits
        self.cache_hits["result"] += int(result_hit)


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

    def cancel(self, reason: str = "client") -> int:
        """Cancel the context's in-flight collects (this frame's
        included) — see :meth:`BallistaContext.cancel`."""
        return self.ctx.cancel(reason)

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
