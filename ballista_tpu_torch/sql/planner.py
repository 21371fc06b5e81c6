"""SQL AST -> LogicalPlan.

Replaces the DataFusion SQL planner the reference leans on (reference:
rust/client/src/context.rs:131-144; scheduler-side planning at
rust/scheduler/src/lib.rs:224-407). Key responsibilities:

- name resolution against a catalog of registered tables AND derived
  tables (FROM-subqueries), with table aliases; self-joins disambiguate by
  renaming the duplicated relations' columns to ``alias__column`` and
  resolving qualified refs through a per-alias rename map;
- join graph extraction: explicit JOIN ... ON plus TPC-H-style comma FROM +
  WHERE equality conjuncts become a greedy join chain whose build sides are
  chosen by primary-key heuristics (build side must be the unique-key side
  for the FK fast path — see physical/join.py);
- subqueries: [NOT] IN (SELECT ...) and [NOT] EXISTS (SELECT ...) are
  decorrelated into semi/anti joins (equality correlation); scalar
  subqueries are planned and inlined as literals at execution time
  (execution.resolve_subqueries);
- aggregate extraction: SELECT/HAVING/ORDER BY expressions over aggregates
  are rewritten to reference generated aggregate output columns;
  COUNT(DISTINCT x) rewrites to a two-level aggregate;
- DISTINCT -> group-by-all; ordinal GROUP BY/ORDER BY references.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..datatypes import Schema
from ..errors import PlanError, SqlError
from .. import expr as ex
from ..logical import (
    Aggregate,
    Explain,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Projection,
    Sort,
    TableScan,
    TableSource,
)
from .parser import (
    ExplainStmt, JoinClause, OrderItem, Query, SelectItem, TableRef,
)


@dataclass
class CatalogTable:
    name: str
    source: Optional[TableSource]
    primary_key: Optional[str] = None  # unique column, for join-side choice
    # view semantics: a registered DataFrame's logical plan, inlined
    # wherever SQL references the name (the reference wraps registered
    # frames the same way: DFTableAdapter, rust/core/src/datasource.rs:28-66)
    plan: Optional["LogicalPlan"] = None


@dataclass
class Relation:
    """One FROM item after resolution (base table or derived subquery)."""

    alias: str
    plan: LogicalPlan  # scan / derived plan, post-rename
    schema: Schema  # exposed schema (post-rename)
    primary_key: Optional[str]  # exposed pk name or None
    rename: Dict[str, str]  # original column -> exposed name


class SqlPlanner:
    def __init__(self, catalog: Dict[str, CatalogTable],
                 system_provider=None):
        self.catalog = catalog
        # system_provider(name) -> TableSource or None for a
        # ``system.*`` table. The port has no system tables yet, so
        # None (the default) resolves only registered tables.
        self._system_provider = system_provider
        # resolved system CatalogTables, cached per planner so one
        # query's several references share a source instance
        self._system_tables: Dict[str, CatalogTable] = {}

    def _table(self, name: str) -> Optional[CatalogTable]:
        """Catalog lookup with a ``system_provider`` fallthrough:
        registered tables always win."""
        t = self.catalog.get(name)
        if t is not None or self._system_provider is None:
            return t
        t = self._system_tables.get(name)
        if t is None:
            src = self._system_provider(name)
            if src is None:
                return None
            t = self._system_tables[name] = CatalogTable(name, src)
        return t

    # ------------------------------------------------------------------ API

    def plan(self, q) -> LogicalPlan:
        if isinstance(q, ExplainStmt):
            # EXPLAIN [ANALYZE] [VERBOSE] <select>: wrap the planned query
            # (reference surface: rust/core/proto/ballista.proto:232
            # ExplainNode)
            return Explain(self.plan(q.query), q.verbose, q.analyze)
        if q.from_table is None:
            raise SqlError("SELECT without FROM not supported yet")

        relations = self._resolve_relations(q)
        col_owner = self._column_owners(relations)

        conjuncts: List[ex.Expr] = []
        if q.where is not None:
            from ..optimizer import factor_or, split_conjuncts

            for c in split_conjuncts(q.where):
                # expose join conditions hidden inside OR-of-ANDs (q19)
                for f in factor_or(c):
                    conjuncts.append(self._qualify(f, relations, col_owner))

        # pull subquery predicates out of the WHERE conjuncts
        semi_specs, conjuncts = self._extract_subquery_predicates(
            conjuncts, relations, col_owner
        )

        plan, remaining = self._plan_joins(
            q, relations, col_owner, conjuncts, semi_specs
        )
        if remaining:
            from ..optimizer import conjoin

            plan = Filter(conjoin(remaining), plan)

        plan = self._plan_select(q, plan, relations, col_owner)
        return plan

    # ------------------------------------------------------- FROM resolution

    def _resolve_relations(self, q: Query) -> List[Relation]:
        refs = [q.from_table] + [j.table for j in q.joins]
        # duplicate-table detection: column names colliding across relations
        raw: List[Tuple[str, TableRef, Schema, Optional[str], Optional[LogicalPlan]]] = []
        for r in refs:
            alias = r.alias or r.name
            if r.subquery is not None:
                sub_plan = self.plan(r.subquery)
                raw.append((alias, r, sub_plan.schema(), None, sub_plan))
            else:
                t = self._table(r.name)
                if t is None:
                    raise SqlError(f"unknown table {r.name!r}")
                if t.plan is not None:  # registered DataFrame: a view
                    # inline a COPY: execution mutates plans in place
                    # (resolve_scalar_subqueries bakes literals into expr
                    # nodes), and the catalog's plan must stay pristine
                    # across queries and re-registrations
                    import copy

                    vplan = copy.deepcopy(t.plan)
                    raw.append(
                        (alias, r, vplan.schema(), t.primary_key, vplan)
                    )
                else:
                    raw.append(
                        (alias, r, t.source.table_schema(), t.primary_key,
                         None)
                    )
        seen: Dict[str, int] = {}
        for _, _, sch, _, _ in raw:
            for n in sch.names():
                seen[n] = seen.get(n, 0) + 1
        dup_cols = {n for n, c in seen.items() if c > 1}

        relations: List[Relation] = []
        for alias, r, sch, pk, sub_plan in raw:
            needs_rename = any(n in dup_cols for n in sch.names())
            if sub_plan is not None:
                base: LogicalPlan = sub_plan
            else:
                t = self._table(r.name)
                base = TableScan(t.name, t.source)
            if needs_rename:
                rename = {
                    n: (f"{alias}__{n}" if n in dup_cols else n)
                    for n in sch.names()
                }
                base = Projection(
                    [ex.ColumnRef(n).alias(rename[n]) for n in sch.names()],
                    base,
                )
                new_schema = base.schema()
                new_pk = rename.get(pk) if pk else None
            else:
                rename = {n: n for n in sch.names()}
                new_schema = sch
                new_pk = pk
            relations.append(Relation(alias, base, new_schema, new_pk, rename))
        return relations

    def _column_owners(self, relations: List[Relation]) -> Dict[str, str]:
        out: Dict[str, str] = {}
        counts: Dict[str, int] = {}
        for rel in relations:
            for n in rel.schema.names():
                out.setdefault(n, rel.alias)
                counts[n] = counts.get(n, 0) + 1
        # exposed names are unique post-rename; a residual dup is an error
        for n, c in counts.items():
            if c > 1:
                raise SqlError(f"ambiguous column {n!r} after aliasing")
        return out

    # ------------------------------------------------------- qualification

    def _qualify(self, e: ex.Expr, relations: List[Relation],
                 col_owner: Dict[str, str], lenient: bool = False) -> ex.Expr:
        by_alias = {r.alias: r for r in relations}
        if isinstance(e, ex.ColumnRef):
            if e.relation is not None:
                rel = by_alias.get(e.relation)
                if rel is None:
                    raise SqlError(f"unknown table alias {e.relation!r}")
                if e.column not in rel.rename:
                    raise SqlError(
                        f"column {e.column!r} not in {e.relation!r}"
                    )
                return ex.ColumnRef(rel.rename[e.column])
            if e.column in col_owner:
                return e
            # maybe the bare name was renamed by a self-join: unique match?
            hits = [
                r.rename[e.column] for r in relations if e.column in r.rename
            ]
            if len(hits) == 1:
                return ex.ColumnRef(hits[0])
            if len(hits) > 1:
                raise SqlError(f"ambiguous column {e.column!r}")
            if lenient:
                # may be a SELECT alias / ordinal; resolved later against
                # the output schema
                return e
            raise SqlError(f"unknown column {e.column!r}")
        if isinstance(e, (ex.ScalarSubquery, ex.Exists, ex.InSubquery)):
            return self._qualify_subquery_expr(e, relations, col_owner)
        for attr in ("expr", "left", "right", "base", "otherwise"):
            if hasattr(e, attr) and isinstance(getattr(e, attr), ex.Expr):
                setattr(e, attr, self._qualify(getattr(e, attr), relations,
                                               col_owner, lenient))
        if hasattr(e, "args"):
            e.args = [self._qualify(a, relations, col_owner, lenient)
                      for a in e.args]
        if hasattr(e, "list"):
            e.list = [self._qualify(a, relations, col_owner, lenient)
                      for a in e.list]
        if hasattr(e, "branches"):
            e.branches = [
                (self._qualify(w, relations, col_owner, lenient),
                 self._qualify(t, relations, col_owner, lenient))
                for w, t in e.branches
            ]
        return e

    def _qualify_subquery_expr(self, e, relations, col_owner):
        if isinstance(e, ex.InSubquery):
            e.expr = self._qualify(e.expr, relations, col_owner)
        if isinstance(e, ex.ScalarSubquery) and e.plan is None:
            try:
                e.plan = self.plan(e.query)  # uncorrelated
            except SqlError:
                # correlated: left for decorrelation at the WHERE level
                e.plan = None
        return e

    # --------------------------------------------- subquery predicate lowering

    def _extract_subquery_predicates(self, conjuncts, relations, col_owner):
        """IN/EXISTS conjuncts -> semi/anti join specs.

        Returns (specs, remaining_conjuncts). A spec is
        (sub_plan, outer_col, sub_col, how).
        """
        specs = []  # (sub_plan, on_pairs [(outer_col, sub_col)], how)
        remaining = []
        self._corr_counter = getattr(self, "_corr_counter", 0)
        for c in conjuncts:
            neg = False
            node = c
            if isinstance(node, ex.Not) and isinstance(node.expr,
                                                       (ex.Exists, ex.InSubquery)):
                neg = True
                node = node.expr
            if isinstance(node, ex.InSubquery):
                negated = neg or node.negated
                inner = ex.strip_alias(node.expr)
                if not isinstance(inner, ex.ColumnRef):
                    raise SqlError("IN-subquery requires a column on the left")
                sub_plan = self.plan(node.query)
                sub_cols = sub_plan.schema().names()
                if len(sub_cols) != 1:
                    raise SqlError("IN-subquery must produce one column")
                specs.append(
                    (sub_plan, [(inner.column, sub_cols[0])],
                     "anti" if negated else "semi", negated)
                )
                continue
            if isinstance(node, ex.Exists):
                negated = neg or node.negated
                plan_, on_pairs, how, pred = self._decorrelate_exists(
                    node.query, relations, col_owner, negated
                )
                specs.append((plan_, on_pairs, how, False))
                if pred is not None:
                    remaining.append(pred)
                continue
            # correlated scalar subquery comparison: expr OP (SELECT agg ...)
            handled = self._try_correlated_scalar(
                node, relations, col_owner, specs, remaining
            )
            if handled:
                continue
            remaining.append(c)
        return specs, remaining

    def _try_correlated_scalar(self, node, relations, col_owner, specs,
                               remaining) -> bool:
        """lhs OP (correlated scalar subquery) -> derived group-by aggregate
        joined on the correlation keys + plain comparison (classic
        decorrelation; covers TPC-H q2/q17/q20)."""
        if not (isinstance(node, ex.BinaryExpr) and node.op in ex.CMP_OPS):
            return False
        lhs, rhs = node.left, node.right
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=",
                "!=": "!="}
        op = node.op
        if isinstance(lhs, ex.ScalarSubquery) and lhs.plan is None:
            lhs, rhs, op = rhs, lhs, flip[op]
        if not (isinstance(rhs, ex.ScalarSubquery) and rhs.plan is None):
            return False
        sub_q: Query = rhs.query
        if len(sub_q.items) != 1 or sub_q.items[0].star:
            raise SqlError("correlated scalar subquery must select one expr")

        from ..optimizer import conjoin, split_conjuncts

        inner_rels = self._resolve_relations(sub_q)
        inner_owner = self._column_owners(inner_rels)
        corr_edges: List[Tuple[str, str]] = []
        residual: List[ex.Expr] = []
        if sub_q.where is not None:
            for c in split_conjuncts(sub_q.where):
                edge = self._correlation_edge(c, inner_rels, inner_owner,
                                              relations, col_owner)
                if edge is not None:
                    corr_edges.append(edge)
                else:
                    residual.append(c)
        if not corr_edges:
            raise SqlError(
                "correlated scalar subquery without equality correlation"
            )
        if len(corr_edges) > 2:
            raise SqlError(">2 correlation columns (round 2)")

        self._corr_counter += 1
        n = self._corr_counter
        key_aliases = [f"__corr_key{n}_{i}" for i in range(len(corr_edges))]
        val_alias = f"__corr_val{n}"
        derived_q = Query(
            items=[
                SelectItem(ex.ColumnRef(ic), ka)
                for (_, ic), ka in zip(corr_edges, key_aliases)
            ] + [SelectItem(sub_q.items[0].expr, val_alias)],
            from_table=sub_q.from_table,
            joins=sub_q.joins,
            where=conjoin(residual) if residual else None,
            group_by=[ex.ColumnRef(ic) for _, ic in corr_edges],
            having=None, order_by=[], limit=None,
        )
        derived = self.plan(derived_q)
        on_pairs = [
            (oc, ka) for (oc, _), ka in zip(corr_edges, key_aliases)
        ]
        specs.append((derived, on_pairs, "inner", False))
        remaining.append(
            ex.BinaryExpr(lhs, op, ex.ColumnRef(val_alias))
        )
        return True

    def _decorrelate_exists(self, sub_q: Query, outer_relations, outer_owner,
                            negated: bool):
        """EXISTS decorrelation.

        Returns (plan, on_pairs, how, residual_pred_or_None).

        Equality-only correlation -> plain semi/anti join (pred None).

        One extra ``inner_col <> outer_col`` correlated conjunct (the q21
        shape) -> group the inner rows by the equality key computing
        count(val)/min(val)/max(val) of the <>-column (count of NON-NULL
        values, so all-NULL groups behave like SQL's unknown comparisons),
        LEFT JOIN that derived table, and test via min/max:
          EXISTS     <=> __c > 0 AND (__mn <> x OR __mx <> x)
          NOT EXISTS <=> __c IS NULL OR __c = 0 OR (__mn = x AND __mx = x)
        """
        from ..optimizer import conjoin, split_conjuncts

        inner_rels = self._resolve_relations(sub_q)
        inner_owner = self._column_owners(inner_rels)
        corr_edges: List[Tuple[str, str]] = []  # (outer_col, inner_col)
        neq_edges: List[Tuple[str, str]] = []  # (outer_col, inner_col)
        inner_conjs: List[ex.Expr] = []
        if sub_q.where is not None:
            for c in split_conjuncts(sub_q.where):
                edge = self._correlation_edge(c, inner_rels, inner_owner,
                                              outer_relations, outer_owner)
                if edge is not None:
                    corr_edges.append(edge)
                    continue
                nedge = self._correlation_edge(
                    c, inner_rels, inner_owner, outer_relations, outer_owner,
                    op="!=",
                )
                if nedge is not None:
                    neq_edges.append(nedge)
                    continue
                inner_conjs.append(self._qualify(c, inner_rels, inner_owner))
        if not corr_edges:
            raise SqlError(
                "EXISTS subquery without equality correlation unsupported"
            )
        if len(corr_edges) > 1:
            raise SqlError("multi-column EXISTS correlation (round 2)")
        if len(neq_edges) > 1:
            raise SqlError("multiple <> correlations in EXISTS (round 2)")
        outer_col, inner_col = corr_edges[0]

        if not neq_edges:
            # plain semi/anti join
            inner_q = Query(
                items=[SelectItem(ex.ColumnRef(inner_col), None)],
                from_table=sub_q.from_table, joins=sub_q.joins, where=None,
                group_by=[], having=None, order_by=[], limit=None,
            )
            plan, remaining = self._plan_joins(
                inner_q, inner_rels, inner_owner, inner_conjs, []
            )
            if remaining:
                plan = Filter(conjoin(remaining), plan)
            plan = Projection([ex.ColumnRef(inner_col)], plan)
            return (plan, [(outer_col, inner_col)],
                    "anti" if negated else "semi", None)

        # generalized (q21): derived per-key count/min/max of the <> column
        neq_outer, neq_inner = neq_edges[0]
        self._corr_counter = getattr(self, "_corr_counter", 0) + 1
        n = self._corr_counter
        ck, cc, mn, mx = (f"__ex_key{n}", f"__ex_cnt{n}", f"__ex_min{n}",
                          f"__ex_max{n}")
        body, remaining = self._plan_joins(
            Query(items=[], from_table=sub_q.from_table, joins=sub_q.joins,
                  where=None, group_by=[], having=None, order_by=[],
                  limit=None),
            inner_rels, inner_owner, inner_conjs, [],
        )
        if remaining:
            body = Filter(conjoin(remaining), body)
        derived = Aggregate(
            [ex.ColumnRef(inner_col).alias(ck)],
            [
                # count of NON-NULL <>-values: all-NULL groups compare
                # unknown in SQL, matching cc = 0 here
                ex.count(ex.ColumnRef(neq_inner)).alias(cc),
                ex.min_(ex.ColumnRef(neq_inner)).alias(mn),
                ex.max_(ex.ColumnRef(neq_inner)).alias(mx),
            ],
            body,
        )
        x = ex.ColumnRef(neq_outer)
        zero = ex.Literal(0, ex.Int64)
        if negated:
            pred = ex.BinaryExpr(
                ex.BinaryExpr(
                    ex.IsNull(ex.ColumnRef(cc)), "or",
                    ex.BinaryExpr(ex.ColumnRef(cc), "=", zero),
                ),
                "or",
                ex.BinaryExpr(
                    ex.BinaryExpr(ex.ColumnRef(mn), "=", x), "and",
                    ex.BinaryExpr(ex.ColumnRef(mx), "=", x),
                ),
            )
        else:
            pred = ex.BinaryExpr(
                ex.BinaryExpr(ex.ColumnRef(cc), ">", zero), "and",
                ex.BinaryExpr(
                    ex.BinaryExpr(ex.ColumnRef(mn), "!=", x), "or",
                    ex.BinaryExpr(ex.ColumnRef(mx), "!=", x),
                ),
            )
        return (derived, [(outer_col, ck)], "left", pred)

    def _correlation_edge(self, c, inner_rels, inner_owner, outer_rels,
                          outer_owner, op: str = "="):
        """outer_col OP inner_col cross-scope conjunct, else None."""
        if not (isinstance(c, ex.BinaryExpr) and c.op == op):
            return None
        sides = [c.left, c.right]
        if not all(isinstance(s, ex.ColumnRef) for s in sides):
            return None

        def resolve(ref, rels, owner):
            try:
                q = self._qualify(
                    ex.ColumnRef(ref.column, ref.relation), rels, owner
                )
                return q.column
            except SqlError:
                return None

        for a, b in ((0, 1), (1, 0)):
            # SQL scoping: a column resolvable in the INNER scope binds
            # there; the correlated side is the one that only resolves in
            # the outer scope
            inner_c = resolve(sides[a], inner_rels, inner_owner)
            inner_of_b = resolve(sides[b], inner_rels, inner_owner)
            outer_c = resolve(sides[b], outer_rels, outer_owner)
            if inner_c and outer_c and inner_of_b is None:
                return (outer_c, inner_c)
        return None

    # ------------------------------------------------------------ join graph

    def _plan_joins(self, q: Query, relations: List[Relation],
                    col_owner: Dict[str, str], conjuncts, semi_specs):
        """Greedy join chain; returns (plan, leftover conjuncts)."""

        def owners(e: ex.Expr) -> Set[str]:
            return {col_owner[c] for c in ex.referenced_columns(e)
                    if c in col_owner}

        join_edges: List[Tuple[str, str, str, str]] = []
        table_filters: Dict[str, List[ex.Expr]] = {r.alias: [] for r in relations}
        post: List[ex.Expr] = []
        # WHERE predicates must run post-join for any null-extended side:
        # the right table of a LEFT JOIN, or everything else under a RIGHT
        # JOIN (conservative)
        explicit_joins = {
            (j.table.alias or j.table.name): j.how for j in q.joins
            if j.how != "cross"
        }
        no_push = {a for a, h in explicit_joins.items() if h == "left"}
        any_right = any(h == "right" for h in explicit_joins.values())

        def classify(c: ex.Expr, from_where: bool = True):
            if (
                isinstance(c, ex.BinaryExpr) and c.op == "="
                and isinstance(c.left, ex.ColumnRef)
                and isinstance(c.right, ex.ColumnRef)
            ):
                o1 = col_owner.get(c.left.column)
                o2 = col_owner.get(c.right.column)
                if o1 and o2 and o1 != o2:
                    join_edges.append((o1, c.left.column, o2, c.right.column))
                    return
            refs = ex.referenced_columns(c)
            if any(r not in col_owner for r in refs):
                # references a subquery-derived column (__corr_val...):
                # must run after those joins are applied
                post.append(c)
                return
            os_ = owners(c)
            if len(os_) == 1:
                owner = next(iter(os_))
                if from_where and (owner in no_push or any_right):
                    post.append(c)
                else:
                    table_filters[owner].append(c)
            else:
                post.append(c)

        for c in conjuncts:
            classify(c, from_where=True)

        explicit_how: Dict[str, str] = {}
        for j in q.joins:
            alias = j.table.alias or j.table.name
            if j.how != "cross":
                explicit_how[alias] = j.how
            if j.on is not None:
                from ..optimizer import split_conjuncts

                for c in split_conjuncts(j.on):
                    # ON-clause filters DO apply pre-join on the new table
                    classify(self._qualify(c, relations, col_owner),
                             from_where=False)

        def filtered_plan(rel: Relation) -> LogicalPlan:
            from ..optimizer import conjoin

            p = rel.plan
            if table_filters[rel.alias]:
                p = Filter(conjoin(table_filters[rel.alias]), p)
            return p

        if len(relations) == 1:
            plan: LogicalPlan = relations[0].plan
            leftover = table_filters[relations[0].alias] + post
        else:
            plan, leftover = self._join_chain(
                relations, join_edges, explicit_how, filtered_plan, post
            )

        # apply subquery-derived joins (semi/anti/correlated-scalar) on top
        for sub_plan, on_pairs, how, null_aware in semi_specs:
            if how == "inner":
                # derived aggregates have unique group keys: put them on
                # the build (left) side for the FK fast path
                plan = Join(sub_plan, plan,
                            [(s_, o) for o, s_ in on_pairs], how)
            else:
                plan = Join(plan, sub_plan, list(on_pairs), how,
                            null_aware=null_aware)
        return plan, leftover

    def _join_chain(self, relations, join_edges, explicit_how, filtered_plan,
                    post):
        by_alias = {r.alias: r for r in relations}
        joined: Set[str] = {relations[0].alias}
        plan = filtered_plan(relations[0])
        acc_unique: Set[str] = set()
        if relations[0].primary_key:
            acc_unique.add(relations[0].primary_key)
        pending = [r.alias for r in relations[1:]]
        edges = list(join_edges)

        while pending:
            progress = False
            for alias in list(pending):
                # collect ALL edges connecting alias to the joined set;
                # every equality edge becomes a composite join key (the
                # join kernels rank arbitrary key tuples against the
                # build side, so there is no column-count cap — and outer
                # joins MUST put every condition in the ON clause, a
                # post filter would drop preserved rows)
                mine: List[Tuple[Tuple[str, str], tuple]] = []
                for e_ in edges:
                    a1, c1, a2, c2 = e_
                    if a1 == alias and a2 in joined:
                        mine.append(((c1, c2), e_))
                    elif a2 == alias and a1 in joined:
                        mine.append(((c2, c1), e_))
                if not mine:
                    continue
                key_pairs = [p for p, _ in mine]  # (t_col, acc_col)
                t_alias = alias
                rel = by_alias[t_alias]
                t_plan = filtered_plan(rel)
                how = explicit_how.get(t_alias, "inner")
                t_col = key_pairs[0][0]
                acc_col = key_pairs[0][1]
                if len(key_pairs) >= 2 and how == "inner":
                    # composite join: build the new table (runtime
                    # uniqueness detection picks the fast path when the
                    # composite key is unique, e.g. partsupp)
                    on = [(t, a) for t, a in key_pairs]
                    plan = Join(t_plan, plan, on, how)
                elif len(key_pairs) >= 2:
                    # outer joins preserve the accumulated side
                    on = [(a, t) for t, a in key_pairs]
                    plan = Join(plan, t_plan, on, how)
                    acc_unique = set()
                elif rel.primary_key == t_col and how == "inner":
                    plan = Join(t_plan, plan, [(t_col, acc_col)], how)
                elif acc_col in acc_unique and how == "inner":
                    plan = Join(plan, t_plan, [(acc_col, t_col)], how)
                    acc_unique = (
                        {rel.primary_key} if rel.primary_key else set()
                    )
                elif how in ("left", "right", "full"):
                    # outer joins: the accumulated side is the logical left
                    plan = Join(plan, t_plan, [(acc_col, t_col)], how)
                    acc_unique = set()
                else:
                    plan = Join(t_plan, plan, [(t_col, acc_col)], how)
                joined.add(t_alias)
                pending.remove(t_alias)
                for _, e_ in mine:
                    edges.remove(e_)
                resolved = [
                    e_ for e_ in edges if e_[0] in joined and e_[2] in joined
                ]
                for a1, c1, a2, c2 in resolved:
                    post.append(
                        ex.BinaryExpr(ex.ColumnRef(c1), "=", ex.ColumnRef(c2))
                    )
                edges = [e_ for e_ in edges if e_ not in resolved]
                progress = True
            if not progress:
                raise SqlError(
                    f"no join condition connects tables {pending} to the rest"
                )
        return plan, post

    # -------------------------------------------------- SELECT/agg/order/limit

    def _plan_select(self, q: Query, plan: LogicalPlan,
                     relations, col_owner) -> LogicalPlan:
        in_schema = plan.schema()

        items: List[SelectItem] = []
        for it in q.items:
            if it.star:
                for n in in_schema.names():
                    items.append(SelectItem(ex.ColumnRef(n), None))
            else:
                e = self._qualify(it.expr, relations, col_owner)
                items.append(SelectItem(e, it.alias))

        select_exprs = [
            it.expr.alias(it.alias) if it.alias else it.expr for it in items
        ]

        group_exprs: List[ex.Expr] = []
        for g in q.group_by:
            g = self._resolve_ref(
                self._qualify(g, relations, col_owner, lenient=True),
                items, in_schema,
            )
            group_exprs.append(g)

        having = (
            self._qualify(q.having, relations, col_owner, lenient=True)
            if q.having is not None else None
        )
        order_items = [
            OrderItem(self._qualify(oi.expr, relations, col_owner,
                                    lenient=True),
                      oi.ascending, oi.nulls_first)
            for oi in q.order_by
        ]

        has_aggs = any(self._contains_agg(e) for e in select_exprs) or (
            having is not None and self._contains_agg(having)
        )
        distinct = q.distinct

        if group_exprs or has_aggs:
            plan = self._plan_aggregate(q, plan, select_exprs, group_exprs,
                                        having, order_items)
        else:
            if distinct:
                proj = Projection(select_exprs, plan)
                names = proj.schema().names()
                plan = Aggregate([ex.ColumnRef(n) for n in names], [], proj)
                distinct = False
            else:
                plan = Projection(select_exprs, plan)

        out_schema = plan.schema()

        if order_items:
            sort_exprs = []
            for oi in order_items:
                e = self._resolve_order_ref(oi.expr, items, out_schema)
                sort_exprs.append(ex.SortExpr(e, oi.ascending,
                                              bool(oi.nulls_first)))
            plan = Sort(sort_exprs, plan)

        if q.limit is not None:
            plan = Limit(q.limit, plan)
        return plan

    def _plan_aggregate(self, q: Query, plan, select_exprs, group_exprs,
                        having, order_items):
        aggs: List[ex.AggregateExpr] = []

        def collect(e: ex.Expr):
            for node in ex.walk(e):
                if isinstance(node, ex.AggregateExpr):
                    if not any(node is a or a.name() == node.name() for a in aggs):
                        aggs.append(node)

        for e in select_exprs:
            collect(e)
        if having is not None:
            collect(having)
        for oi in order_items:
            collect(oi.expr)

        # COUNT(DISTINCT x) -> two-level aggregate rewrite
        distinct_aggs = [a for a in aggs if a.fn == "count_distinct"]
        if distinct_aggs:
            if len(distinct_aggs) != len(aggs):
                raise SqlError(
                    "mixing COUNT(DISTINCT) with other aggregates (round 2)"
                )
            if len(distinct_aggs) > 1:
                raise SqlError("multiple COUNT(DISTINCT) aggregates (round 2)")
            da = distinct_aggs[0]
            inner = Aggregate(group_exprs + [da.expr], [], plan)
            inner_names = inner.schema().names()
            outer_groups = [ex.ColumnRef(n) for n in inner_names[:-1]]
            counted = ex.AggregateExpr(
                "count", ex.ColumnRef(inner_names[-1])
            ).alias(da.name())
            agg_plan = Aggregate(outer_groups, [counted], inner)
        else:
            agg_plan = Aggregate(group_exprs, list(aggs), plan)
        agg_schema = agg_plan.schema()

        group_names = {g.name() for g in group_exprs}

        def rewrite(e: ex.Expr) -> ex.Expr:
            if isinstance(e, ex.Alias):
                return ex.Alias(rewrite(e.expr), e.alias_name)
            if isinstance(e, ex.AggregateExpr):
                return ex.ColumnRef(e.name())
            if e.name() in group_names:
                return ex.ColumnRef(e.name())
            for attr in ("expr", "left", "right", "base", "otherwise"):
                if hasattr(e, attr) and isinstance(getattr(e, attr), ex.Expr):
                    setattr(e, attr, rewrite(getattr(e, attr)))
            if hasattr(e, "args"):
                e.args = [rewrite(a) for a in e.args]
            if hasattr(e, "list"):
                e.list = [rewrite(a) for a in e.list]
            if hasattr(e, "branches"):
                e.branches = [(rewrite(w), rewrite(t)) for w, t in e.branches]
            return e

        out: LogicalPlan = agg_plan
        if having is not None:
            out = Filter(rewrite(having), out)
        projected = [rewrite(e) for e in select_exprs]
        for e in projected:
            for node in ex.walk(e):
                if isinstance(node, ex.ColumnRef) and not agg_schema.has_field(
                    node.column
                ):
                    raise SqlError(
                        f"column {node.column!r} is neither grouped nor aggregated"
                    )
        return Projection(projected, out)

    # ---------------------------------------------------- reference helpers

    def _resolve_ref(self, e: ex.Expr, items: List[SelectItem], schema: Schema):
        if isinstance(e, ex.Literal) and e.dtype.is_integer and items:
            idx = int(e.value) - 1
            if 0 <= idx < len(items):
                return items[idx].expr
            raise SqlError(f"ordinal {e.value} out of range")
        if isinstance(e, ex.ColumnRef) and not schema.has_field(e.column):
            for it in items:
                if it.alias == e.column:
                    return it.expr
        return e

    def _resolve_order_ref(self, e: ex.Expr, items, out_schema: Schema):
        if isinstance(e, ex.Literal) and e.dtype.is_integer:
            idx = int(e.value) - 1
            names = out_schema.names()
            if 0 <= idx < len(names):
                return ex.ColumnRef(names[idx])
            raise SqlError(f"ordinal {e.value} out of range")
        if isinstance(e, ex.AggregateExpr):
            if out_schema.has_field(e.name()):
                return ex.ColumnRef(e.name())
            raise SqlError(f"ORDER BY aggregate {e.name()} not in output")
        if isinstance(e, ex.ColumnRef):
            if out_schema.has_field(e.column):
                return e
            for it in items:
                if it.alias == e.column:
                    return it.expr
            raise SqlError(f"unknown ORDER BY column {e.column!r}")
        return e

    def _contains_agg(self, e: ex.Expr) -> bool:
        return any(isinstance(n, ex.AggregateExpr) for n in ex.walk(e))
