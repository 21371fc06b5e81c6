"""Recursive-descent / Pratt SQL parser producing statement ASTs whose
expressions are ``ballista_tpu_torch.expr`` nodes (with unresolved column
refs).
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Tuple

from ..datatypes import Date32, dtype_from_name
from ..errors import SqlError
from .. import expr as ex
from .lexer import Token, tokenize


# ---------------------------------------------------------------------------
# Statement ASTs
# ---------------------------------------------------------------------------


@dataclass
class SelectItem:
    expr: Optional[ex.Expr]  # None => '*'
    alias: Optional[str] = None
    star: bool = False


@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None
    subquery: Optional["Query"] = None  # derived table: FROM (SELECT ...) a


@dataclass
class JoinClause:
    how: str  # inner|left|right|semi|anti|cross
    table: TableRef
    on: Optional[ex.Expr] = None


@dataclass
class OrderItem:
    expr: ex.Expr
    ascending: bool = True
    nulls_first: Optional[bool] = None


@dataclass
class Query:
    items: List[SelectItem]
    from_table: Optional[TableRef]
    joins: List[JoinClause]
    where: Optional[ex.Expr]
    group_by: List[ex.Expr]
    having: Optional[ex.Expr]
    order_by: List[OrderItem]
    limit: Optional[int]
    distinct: bool = False


@dataclass
class ExplainStmt:
    """EXPLAIN [ANALYZE] [VERBOSE] <select> (reference: rust/core/proto/
    ballista.proto:232 ExplainNode; DataFusion's SQL EXPLAIN surface).
    ``analyze`` executes the query and annotates the rendered plan with
    live operator metrics."""
    query: "Query"
    verbose: bool = False
    analyze: bool = False


@dataclass
class CreateExternalTable:
    name: str
    columns: List[Tuple[str, str]]  # (name, type string)
    stored_as: str  # CSV | TBL | PARQUET
    location: str
    has_header: bool = False


Statement = object  # Query | ExplainStmt | CreateExternalTable


def parse_sql(sql: str) -> Statement:
    return Parser(tokenize(sql)).parse_statement()


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def accept_kw(self, *names: str) -> Optional[Token]:
        if self.peek().is_kw(*names):
            return self.next()
        return None

    def expect_kw(self, *names: str) -> Token:
        t = self.next()
        if not t.is_kw(*names):
            raise SqlError(f"expected {'/'.join(names).upper()}, got {t.value!r}")
        return t

    def accept_op(self, *ops: str) -> Optional[Token]:
        t = self.peek()
        if t.kind == "op" and t.value in ops:
            return self.next()
        return None

    def expect_op(self, op: str) -> Token:
        t = self.next()
        if t.kind != "op" or t.value != op:
            raise SqlError(f"expected {op!r}, got {t.value!r}")
        return t

    def expect_ident(self) -> str:
        t = self.next()
        if t.kind == "ident":
            return t.value
        # allow non-reserved keywords as identifiers in limited spots
        if t.kind == "kw":
            return t.value
        raise SqlError(f"expected identifier, got {t.value!r}")

    # -- statements ---------------------------------------------------------

    def _peek_soft(self, name: str) -> bool:
        """Contextual keyword: an identifier matched by value, so the same
        word stays usable as a column name elsewhere in the query."""
        from .lexer import SOFT_KEYWORDS

        assert name in SOFT_KEYWORDS, f"{name} not registered as soft kw"
        t = self.peek()
        return t.kind == "ident" and t.value.lower() == name

    def parse_statement(self) -> Statement:
        if self.peek().is_kw("create"):
            return self.parse_create_external_table()
        if self._peek_soft("explain"):
            self.next()
            verbose = analyze = False
            # EXPLAIN [ANALYZE] [VERBOSE] — flags accepted in either order
            while True:
                if not verbose and self._peek_soft("verbose"):
                    self.next()
                    verbose = True
                elif not analyze and self._peek_soft("analyze"):
                    self.next()
                    analyze = True
                else:
                    break
            if not self.peek().is_kw("select"):
                raise SqlError(
                    f"EXPLAIN expects SELECT, got {self.peek().value!r}")
            q = self.parse_query()
            self.accept_op(";")
            if self.peek().kind != "eof":
                raise SqlError(f"trailing tokens at {self.peek().pos}")
            return ExplainStmt(q, verbose, analyze)
        if self.peek().is_kw("select"):
            q = self.parse_query()
            self.accept_op(";")
            if self.peek().kind != "eof":
                raise SqlError(f"trailing tokens at {self.peek().pos}")
            return q
        raise SqlError(
            f"expected SELECT, EXPLAIN or CREATE, got {self.peek().value!r}")

    def parse_create_external_table(self) -> CreateExternalTable:
        self.expect_kw("create")
        self.expect_kw("external")
        self.expect_kw("table")
        name = self.expect_ident()
        self.expect_op("(")
        cols: List[Tuple[str, str]] = []
        while True:
            cname = self.expect_ident()
            tparts = [self.expect_ident()]
            if self.accept_op("("):
                inner = []
                while not self.accept_op(")"):
                    inner.append(self.next().value)
                tparts.append("(" + ",".join(inner) + ")")
            cols.append((cname, " ".join(tparts)))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        has_header = False
        if self.accept_kw("with"):
            self.expect_kw("header")
            self.expect_kw("row")
            has_header = True
        self.expect_kw("stored")
        self.expect_kw("as")
        stored = self.expect_ident().upper()
        self.expect_kw("location")
        t = self.next()
        if t.kind != "string":
            raise SqlError("LOCATION requires a string literal")
        self.accept_op(";")
        return CreateExternalTable(name, cols, stored, t.value, has_header)

    # -- queries ------------------------------------------------------------

    def parse_query(self) -> Query:
        self.expect_kw("select")
        distinct = bool(self.accept_kw("distinct"))
        self.accept_kw("all")
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())

        from_table: Optional[TableRef] = None
        joins: List[JoinClause] = []
        if self.accept_kw("from"):
            from_table = self.parse_table_ref()
            while True:
                if self.accept_op(","):
                    joins.append(JoinClause("cross", self.parse_table_ref()))
                    continue
                how = self.parse_join_kind()
                if how is None:
                    break
                tref = self.parse_table_ref()
                on = None
                if self.accept_kw("on"):
                    on = self.parse_expr()
                joins.append(JoinClause(how, tref, on))

        where = self.parse_expr() if self.accept_kw("where") else None

        group_by: List[ex.Expr] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self.parse_expr())
            while self.accept_op(","):
                group_by.append(self.parse_expr())

        having = self.parse_expr() if self.accept_kw("having") else None

        order_by: List[OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())

        limit = None
        if self.accept_kw("limit"):
            t = self.next()
            if t.kind != "number":
                raise SqlError("LIMIT requires a number")
            limit = int(t.value)

        return Query(items, from_table, joins, where, group_by, having,
                     order_by, limit, distinct)

    def parse_join_kind(self) -> Optional[str]:
        if self.accept_kw("join"):
            return "inner"
        if self.accept_kw("inner"):
            self.expect_kw("join")
            return "inner"
        for kw in ("left", "right", "full"):
            if self.peek().is_kw(kw):
                self.next()
                self.accept_kw("outer")
                self.expect_kw("join")
                return kw
        for kw in ("semi", "anti"):
            if self.peek().is_kw(kw):
                self.next()
                self.expect_kw("join")
                return kw
        return None

    def parse_table_ref(self) -> TableRef:
        if self.accept_op("("):
            sub = self.parse_query()
            self.expect_op(")")
            alias = None
            if self.accept_kw("as"):
                alias = self.expect_ident()
            elif self.peek().kind == "ident":
                alias = self.next().value
            if alias is None:
                raise SqlError("derived table requires an alias")
            return TableRef(f"__subquery_{alias}", alias, subquery=sub)
        name = self.expect_ident()
        # dotted table names (one schema level, e.g. ``system.queries``):
        # consumed here so the catalog can key on the qualified name
        if self.peek().kind == "op" and self.peek().value == "." and \
                self.peek(1).kind in ("ident", "kw"):
            self.next()
            name = f"{name}.{self.next().value}"
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.peek().kind == "ident":
            alias = self.next().value
        return TableRef(name, alias)

    def parse_select_item(self) -> SelectItem:
        if self.accept_op("*"):
            return SelectItem(None, None, star=True)
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.peek().kind == "ident":
            alias = self.next().value
        return SelectItem(e, alias)

    def parse_order_item(self) -> OrderItem:
        e = self.parse_expr()
        asc = True
        if self.accept_kw("asc"):
            asc = True
        elif self.accept_kw("desc"):
            asc = False
        nulls_first = None
        if self.accept_kw("nulls"):
            t = self.expect_kw("first", "last")
            nulls_first = t.value == "first"
        return OrderItem(e, asc, nulls_first)

    # -- expressions (Pratt) -------------------------------------------------

    def parse_expr(self) -> ex.Expr:
        return self.parse_or()

    def parse_or(self) -> ex.Expr:
        e = self.parse_and()
        while self.accept_kw("or"):
            e = ex.BinaryExpr(e, "or", self.parse_and())
        return e

    def parse_and(self) -> ex.Expr:
        e = self.parse_not()
        while self.accept_kw("and"):
            e = ex.BinaryExpr(e, "and", self.parse_not())
        return e

    def parse_not(self) -> ex.Expr:
        if self.accept_kw("not"):
            return ex.Not(self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> ex.Expr:
        e = self.parse_additive()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("=", "<", ">", "<=", ">=", "<>", "!="):
                self.next()
                op = "!=" if t.value in ("<>", "!=") else t.value
                e = ex.BinaryExpr(e, op, self.parse_additive())
                continue
            negated = False
            if t.is_kw("not"):
                nxt = self.peek(1)
                if nxt.is_kw("between", "in", "like"):
                    self.next()
                    negated = True
                    t = self.peek()
                else:
                    break
            if t.is_kw("between"):
                self.next()
                lo = self.parse_additive()
                self.expect_kw("and")
                hi = self.parse_additive()
                rng = ex.BinaryExpr(
                    ex.BinaryExpr(e, ">=", lo), "and", ex.BinaryExpr(e, "<=", hi)
                )
                e = ex.Not(rng) if negated else rng
                continue
            if t.is_kw("in"):
                self.next()
                self.expect_op("(")
                if self.peek().is_kw("select"):
                    sub = self.parse_query()
                    self.expect_op(")")
                    e = ex.InSubquery(e, sub, negated)
                    continue
                vals = [self.parse_expr()]
                while self.accept_op(","):
                    vals.append(self.parse_expr())
                self.expect_op(")")
                e = ex.InList(e, vals, negated)
                continue
            if t.is_kw("like"):
                self.next()
                pat = self.next()
                if pat.kind != "string":
                    raise SqlError("LIKE requires a string pattern")
                e = ex.Like(e, pat.value, negated)
                continue
            if t.is_kw("is"):
                self.next()
                neg = bool(self.accept_kw("not"))
                self.expect_kw("null")
                e = ex.IsNotNull(e) if neg else ex.IsNull(e)
                continue
            break
        return e

    def parse_additive(self) -> ex.Expr:
        e = self.parse_multiplicative()
        while True:
            t = self.accept_op("+", "-")
            if not t:
                return e
            rhs = self.parse_multiplicative()
            e = self._fold_date_arith(e, t.value, rhs)

    def _fold_date_arith(self, l: ex.Expr, op: str, r: ex.Expr) -> ex.Expr:
        # interval plumbing: intervals parse as Literal(days, Int32) tagged
        # via _IntervalDays, or month-intervals that only fold on date
        # literals
        if isinstance(r, _IntervalMonths):
            if isinstance(l, ex.Literal) and l.dtype == Date32:
                base = _dt.date(1970, 1, 1) + _dt.timedelta(days=int(l.value))
                months = r.months if op == "+" else -r.months
                y = base.year + (base.month - 1 + months) // 12
                m = (base.month - 1 + months) % 12 + 1
                d = min(base.day, _days_in_month(y, m))
                return ex.Literal((_dt.date(y, m, d) - _dt.date(1970, 1, 1)).days,
                                  Date32)
            raise SqlError("month/year intervals supported only on date literals")
        if isinstance(r, _IntervalDays):
            r = ex.Literal(r.days, _I32)  # plain int day count
        e = ex.BinaryExpr(l, op, r)
        # constant-fold date literal +/- int literal
        if (
            isinstance(l, ex.Literal) and l.dtype == Date32
            and isinstance(r, ex.Literal) and r.dtype.is_integer
        ):
            days = int(l.value) + (int(r.value) if op == "+" else -int(r.value))
            return ex.Literal(days, Date32)
        return e

    def parse_multiplicative(self) -> ex.Expr:
        e = self.parse_unary()
        while True:
            t = self.accept_op("*", "/", "%")
            if not t:
                return e
            e = ex.BinaryExpr(e, t.value, self.parse_unary())

    def parse_unary(self) -> ex.Expr:
        if self.accept_op("-"):
            inner = self.parse_unary()
            if isinstance(inner, ex.Literal) and inner.dtype.is_numeric:
                return ex.Literal(-inner.value, inner.dtype)
            return ex.BinaryExpr(ex.Literal(0, _I64), "-", inner)
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> ex.Expr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            if "." in t.value or "e" in t.value.lower():
                return ex.Literal(float(t.value), _F64)
            return ex.Literal(int(t.value), _I64)
        if t.kind == "string":
            self.next()
            return ex.Literal(t.value, _UTF8)
        if t.is_kw("true"):
            self.next()
            return ex.Literal(True, _BOOL)
        if t.is_kw("false"):
            self.next()
            return ex.Literal(False, _BOOL)
        if t.is_kw("null"):
            self.next()
            return ex.Literal(None, _I64)
        if t.is_kw("date"):
            self.next()
            s = self.next()
            if s.kind != "string":
                raise SqlError("DATE requires a string literal")
            return ex.Literal(ex.parse_date_literal(s.value), Date32)
        if t.is_kw("interval"):
            self.next()
            s = self.next()
            if s.kind not in ("string", "number"):
                raise SqlError("INTERVAL requires a quantity")
            qty = s.value
            unit = self.expect_ident().lower().rstrip("s")
            # also supports "interval '3 month'" style
            if " " in qty.strip():
                parts = qty.split()
                qty, unit = parts[0], parts[1].lower().rstrip("s")
            n = int(float(qty))
            if unit == "day":
                return _IntervalDays(n)
            if unit == "week":
                return _IntervalDays(7 * n)
            if unit == "month":
                return _IntervalMonths(n)
            if unit == "year":
                return _IntervalMonths(12 * n)
            raise SqlError(f"unsupported interval unit {unit}")
        if t.is_kw("exists"):
            self.next()
            self.expect_op("(")
            sub = self.parse_query()
            self.expect_op(")")
            return ex.Exists(sub)
        if t.is_kw("case"):
            return self.parse_case()
        if t.is_kw("cast"):
            self.next()
            self.expect_op("(")
            inner = self.parse_expr()
            self.expect_kw("as")
            tname = [self.expect_ident()]
            if self.accept_op("("):
                args = []
                while not self.accept_op(")"):
                    args.append(self.next().value)
                tname.append("(" + ",".join(args) + ")")
            self.expect_op(")")
            return ex.Cast(inner, dtype_from_name(" ".join(tname)))
        if t.is_kw("extract"):
            self.next()
            self.expect_op("(")
            part = self.expect_ident().lower()
            self.expect_kw("from")
            inner = self.parse_expr()
            self.expect_op(")")
            if part not in ("year", "month", "day"):
                raise SqlError(f"EXTRACT({part}) unsupported")
            return ex.ScalarFunction(f"extract_{part}", [inner])
        if self.accept_op("("):
            if self.peek().is_kw("select"):
                sub = self.parse_query()
                self.expect_op(")")
                return ex.ScalarSubquery(None, sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "ident" or t.is_kw("left", "right"):  # fn names may clash
            name = self.next().value
            if self.accept_op("("):
                return self.parse_function(name.lower())
            if self.accept_op("."):
                colname = self.expect_ident()
                return ex.ColumnRef(colname, name)
            return ex.ColumnRef(name)
        raise SqlError(f"unexpected token {t.value!r} at {t.pos}")

    def parse_function(self, name: str) -> ex.Expr:
        args: List[ex.Expr] = []
        distinct = False
        if self.accept_op("*"):
            self.expect_op(")")
            if name != "count":
                raise SqlError(f"{name}(*) not supported")
            return ex.count()
        if self.accept_kw("distinct"):
            distinct = True
        if not self.accept_op(")"):
            args.append(self.parse_expr())
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
        if name in ("sum", "avg", "min", "max", "count"):
            if len(args) != 1:
                raise SqlError(f"{name} takes one argument")
            if distinct:
                if name != "count":
                    raise SqlError(f"{name}(DISTINCT) not supported")
                return ex.count_distinct(args[0])
            return ex.AggregateExpr(name, args[0])
        if name in ("substring", "substr"):
            return ex.ScalarFunction("substr", args)
        if name == "char_length":
            return ex.ScalarFunction("length", args)
        return ex.ScalarFunction(name, args)

    def parse_case(self) -> ex.Expr:
        self.expect_kw("case")
        base = None
        if not self.peek().is_kw("when"):
            base = self.parse_expr()
        branches = []
        while self.accept_kw("when"):
            w = self.parse_expr()
            self.expect_kw("then")
            th = self.parse_expr()
            branches.append((w, th))
        otherwise = None
        if self.accept_kw("else"):
            otherwise = self.parse_expr()
        self.expect_kw("end")
        return ex.Case(base, branches, otherwise)


# -- helper literal dtypes (avoid importing the heavy module paths inline) ---

from ..datatypes import (  # noqa: E402
    Boolean as _BOOL,
    Float64 as _F64,
    Int32 as _I32,
    Int64 as _I64,
    Utf8 as _UTF8,
)


@dataclass(repr=False, eq=False)
class _IntervalDays(ex.Expr):
    days: int

    def name(self) -> str:
        return f"INTERVAL {self.days} DAY"


@dataclass(repr=False, eq=False)
class _IntervalMonths(ex.Expr):
    months: int

    def name(self) -> str:
        return f"INTERVAL {self.months} MONTH"


def _days_in_month(y: int, m: int) -> int:
    if m == 12:
        return 31
    return ((_dt.date(y, m + 1, 1)) - _dt.date(y, m, 1)).days
