"""Logical expression AST.

Covers the reference wire contract's expression surface (reference:
rust/core/proto/ballista.proto:14-45 ``LogicalExprNode`` with 16 variants,
:80-114 scalar functions, :121-127 aggregate functions MIN/MAX/SUM/AVG/COUNT)
plus the operator-overload ergonomics of its Python bindings (reference:
python/src/expression.rs:1-304).

Expressions are pure ASTs; evaluation against a ColumnBatch happens in
``kernels.expr_eval`` inside a jit trace, and type inference happens here via
``to_field``.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field as dc_field
from typing import Any, List, Optional, Sequence, Tuple, Union

from .datatypes import (
    Boolean,
    DataType,
    Date32,
    Decimal,
    Field,
    Float32,
    Float64,
    Int32,
    Int64,
    Schema,
    Utf8,
    common_numeric_type,
)
from .errors import PlanError, SchemaError

# ---------------------------------------------------------------------------
# Base
# ---------------------------------------------------------------------------


class Expr:
    """Base logical expression."""

    # -- naming / typing ----------------------------------------------------

    def name(self) -> str:
        raise NotImplementedError(type(self).__name__)

    def to_field(self, schema: Schema) -> Field:
        raise NotImplementedError(type(self).__name__)

    def children(self) -> List["Expr"]:
        return []

    # -- fluent builders (DataFrame API) ------------------------------------

    def alias(self, name: str) -> "Expr":
        return Alias(self, name)

    def cast(self, dtype: DataType) -> "Expr":
        return Cast(self, dtype)

    def asc(self, nulls_first: bool = False) -> "SortExpr":
        return SortExpr(self, True, nulls_first)

    def desc(self, nulls_first: bool = False) -> "SortExpr":
        return SortExpr(self, False, nulls_first)

    def is_null(self) -> "Expr":
        return IsNull(self)

    def is_not_null(self) -> "Expr":
        return IsNotNull(self)

    def between(self, low, high) -> "Expr":
        return (self >= low) & (self <= high)

    def isin(self, values: Sequence) -> "Expr":
        return InList(self, [_wrap(v) for v in values], negated=False)

    # -- operator overloads --------------------------------------------------

    def __add__(self, other):
        return BinaryExpr(self, "+", _wrap(other))

    def __radd__(self, other):
        return BinaryExpr(_wrap(other), "+", self)

    def __sub__(self, other):
        return BinaryExpr(self, "-", _wrap(other))

    def __rsub__(self, other):
        return BinaryExpr(_wrap(other), "-", self)

    def __mul__(self, other):
        return BinaryExpr(self, "*", _wrap(other))

    def __rmul__(self, other):
        return BinaryExpr(_wrap(other), "*", self)

    def __truediv__(self, other):
        return BinaryExpr(self, "/", _wrap(other))

    def __rtruediv__(self, other):
        return BinaryExpr(_wrap(other), "/", self)

    def __mod__(self, other):
        return BinaryExpr(self, "%", _wrap(other))

    def __eq__(self, other):  # type: ignore[override]
        return BinaryExpr(self, "=", _wrap(other))

    def __ne__(self, other):  # type: ignore[override]
        return BinaryExpr(self, "!=", _wrap(other))

    def __lt__(self, other):
        return BinaryExpr(self, "<", _wrap(other))

    def __le__(self, other):
        return BinaryExpr(self, "<=", _wrap(other))

    def __gt__(self, other):
        return BinaryExpr(self, ">", _wrap(other))

    def __ge__(self, other):
        return BinaryExpr(self, ">=", _wrap(other))

    def __and__(self, other):
        return BinaryExpr(self, "and", _wrap(other))

    def __or__(self, other):
        return BinaryExpr(self, "or", _wrap(other))

    def __invert__(self):
        return Not(self)

    # Identity hash: __eq__ is DSL sugar (returns a BinaryExpr), so Exprs
    # must never rely on structural set/dict semantics — planners key on
    # .name() strings instead.
    __hash__ = object.__hash__

    def __repr__(self) -> str:
        return self.name()

    def __bool__(self):
        raise PlanError(
            "cannot coerce Expr to bool — use & | ~ instead of and/or/not"
        )


def _wrap(v) -> Expr:
    if isinstance(v, Expr):
        return v
    return Literal.infer(v)


# ---------------------------------------------------------------------------
# Leaf expressions
# ---------------------------------------------------------------------------


@dataclass(repr=False, eq=False)
class ColumnRef(Expr):
    """Reference to an input column, optionally qualified (table.column)."""

    column: str
    relation: Optional[str] = None

    def name(self) -> str:
        return self.column

    def qualified(self) -> str:
        return f"{self.relation}.{self.column}" if self.relation else self.column

    def to_field(self, schema: Schema) -> Field:
        return schema.field(self.column)


@dataclass(repr=False, eq=False)
class Literal(Expr):
    """Typed literal. ``value`` is the logical Python value."""

    value: Any
    dtype: DataType

    @staticmethod
    def infer(v) -> "Literal":
        if isinstance(v, bool):
            return Literal(v, Boolean)
        if isinstance(v, int):
            return Literal(v, Int64)
        if isinstance(v, float):
            return Literal(v, Float64)
        if isinstance(v, str):
            return Literal(v, Utf8)
        if isinstance(v, _dt.date):
            return Literal((v - _dt.date(1970, 1, 1)).days, Date32)
        if v is None:
            return Literal(None, Int64)
        raise PlanError(f"cannot infer literal type for {v!r}")

    def name(self) -> str:
        return repr(self.value) if not isinstance(self.value, str) else self.value

    def to_field(self, schema: Schema) -> Field:
        return Field(self.name(), self.dtype, self.value is None)


def parse_date_literal(s: str) -> int:
    """'YYYY-MM-DD' -> days since epoch."""
    d = _dt.date.fromisoformat(s.strip())
    return (d - _dt.date(1970, 1, 1)).days


# ---------------------------------------------------------------------------
# Compound expressions
# ---------------------------------------------------------------------------


@dataclass(repr=False, eq=False)
class Alias(Expr):
    expr: Expr
    alias_name: str

    def name(self) -> str:
        return self.alias_name

    def children(self) -> List[Expr]:
        return [self.expr]

    def to_field(self, schema: Schema) -> Field:
        inner = self.expr.to_field(schema)
        return Field(self.alias_name, inner.dtype, inner.nullable)


ARITH_OPS = ("+", "-", "*", "/", "%")
CMP_OPS = ("=", "!=", "<", "<=", ">", ">=")
BOOL_OPS = ("and", "or")


@dataclass(repr=False, eq=False)
class BinaryExpr(Expr):
    left: Expr
    op: str
    right: Expr

    def name(self) -> str:
        return f"{self.left.name()} {self.op.upper()} {self.right.name()}"

    def children(self) -> List[Expr]:
        return [self.left, self.right]

    def to_field(self, schema: Schema) -> Field:
        lf = self.left.to_field(schema)
        rf = self.right.to_field(schema)
        nullable = lf.nullable or rf.nullable
        if self.op in BOOL_OPS:
            if lf.dtype != Boolean or rf.dtype != Boolean:
                raise SchemaError(f"{self.op} requires booleans, got {lf} / {rf}")
            return Field(self.name(), Boolean, nullable)
        if self.op in CMP_OPS:
            _ = _coerced_binary_type(lf.dtype, rf.dtype, self)
            return Field(self.name(), Boolean, nullable)
        if self.op in ARITH_OPS:
            out = _arith_result_type(lf.dtype, rf.dtype, self.op)
            return Field(self.name(), out, nullable)
        raise PlanError(f"unknown binary op {self.op}")


def _coerced_binary_type(l: DataType, r: DataType, ctx: Expr) -> DataType:
    """Common comparison type; utf8 comparisons require utf8 on both sides
    (literals adapt to dictionary codes at evaluation time)."""
    if l.is_string or r.is_string:
        if l.kind == "date32" or r.kind == "date32":
            return Date32  # string date literal vs date column
        if l.is_string and r.is_string:
            return Utf8
        raise SchemaError(f"cannot compare {l!r} with {r!r} in {ctx.name()}")
    if l == Boolean and r == Boolean:
        return Boolean
    return common_numeric_type(l, r)


def _arith_result_type(l: DataType, r: DataType, op: str) -> DataType:
    if l.kind == "date32" or r.kind == "date32":
        if op in ("+", "-"):
            # date +/- int days -> date; date - date -> int
            if l.kind == "date32" and r.kind == "date32":
                return Int32
            return Date32
        raise SchemaError(f"op {op} invalid for dates")
    if l.kind == "decimal" or r.kind == "decimal":
        ls = l.scale if l.kind == "decimal" else 0
        rs = r.scale if r.kind == "decimal" else 0
        if op in ("+", "-"):
            if l.is_floating or r.is_floating:
                return Float64
            return Decimal(max(ls, rs))
        if op == "*":
            if l.is_floating or r.is_floating:
                return Float64
            return Decimal(ls + rs)
        if op == "/":
            return Float64
        if op == "%":
            raise SchemaError("modulo on decimal not supported")
    if op == "/":
        if l.is_integer and r.is_integer:
            return common_numeric_type(l, r)
        return Float64
    return common_numeric_type(l, r)


@dataclass(repr=False, eq=False)
class Not(Expr):
    expr: Expr

    def name(self) -> str:
        return f"NOT {self.expr.name()}"

    def children(self) -> List[Expr]:
        return [self.expr]

    def to_field(self, schema: Schema) -> Field:
        f = self.expr.to_field(schema)
        return Field(self.name(), Boolean, f.nullable)


@dataclass(repr=False, eq=False)
class IsNull(Expr):
    expr: Expr

    def name(self) -> str:
        return f"{self.expr.name()} IS NULL"

    def children(self) -> List[Expr]:
        return [self.expr]

    def to_field(self, schema: Schema) -> Field:
        return Field(self.name(), Boolean, False)


@dataclass(repr=False, eq=False)
class IsNotNull(Expr):
    expr: Expr

    def name(self) -> str:
        return f"{self.expr.name()} IS NOT NULL"

    def children(self) -> List[Expr]:
        return [self.expr]

    def to_field(self, schema: Schema) -> Field:
        return Field(self.name(), Boolean, False)


@dataclass(repr=False, eq=False)
class InList(Expr):
    expr: Expr
    list: List[Expr]
    negated: bool = False

    def name(self) -> str:
        n = "NOT IN" if self.negated else "IN"
        return f"{self.expr.name()} {n} ({', '.join(e.name() for e in self.list)})"

    def children(self) -> List[Expr]:
        return [self.expr] + list(self.list)

    def to_field(self, schema: Schema) -> Field:
        f = self.expr.to_field(schema)
        return Field(self.name(), Boolean, f.nullable)


@dataclass(repr=False, eq=False)
class Cast(Expr):
    expr: Expr
    dtype: DataType

    def name(self) -> str:
        return f"CAST({self.expr.name()} AS {self.dtype!r})"

    def children(self) -> List[Expr]:
        return [self.expr]

    def to_field(self, schema: Schema) -> Field:
        f = self.expr.to_field(schema)
        return Field(self.name(), self.dtype, f.nullable)


@dataclass(repr=False, eq=False)
class Case(Expr):
    """CASE [expr] WHEN v THEN r ... [ELSE d] END."""

    base: Optional[Expr]
    branches: List[Tuple[Expr, Expr]]
    otherwise: Optional[Expr]

    def name(self) -> str:
        parts = ["CASE"]
        if self.base is not None:
            parts.append(self.base.name())
        for w, t in self.branches:
            parts.append(f"WHEN {w.name()} THEN {t.name()}")
        if self.otherwise is not None:
            parts.append(f"ELSE {self.otherwise.name()}")
        parts.append("END")
        return " ".join(parts)

    def children(self) -> List[Expr]:
        out = [self.base] if self.base is not None else []
        for w, t in self.branches:
            out += [w, t]
        if self.otherwise is not None:
            out.append(self.otherwise)
        return out

    def to_field(self, schema: Schema) -> Field:
        t = self.branches[0][1].to_field(schema)
        return Field(self.name(), t.dtype, True)


@dataclass(repr=False, eq=False)
class Like(Expr):
    expr: Expr
    pattern: str
    negated: bool = False

    def name(self) -> str:
        n = "NOT LIKE" if self.negated else "LIKE"
        return f"{self.expr.name()} {n} {self.pattern!r}"

    def children(self) -> List[Expr]:
        return [self.expr]

    def to_field(self, schema: Schema) -> Field:
        f = self.expr.to_field(schema)
        return Field(self.name(), Boolean, f.nullable)


# ---------------------------------------------------------------------------
# Subquery expressions (resolved/decorrelated by the SQL planner; a
# ScalarSubquery that survives to execution is inlined to a Literal by
# execution.resolve_subqueries)
# ---------------------------------------------------------------------------


@dataclass(repr=False, eq=False)
class ScalarSubquery(Expr):
    """(SELECT single_value ...) used as a scalar."""

    plan: object  # LogicalPlan (late-bound by the SQL planner)
    query: object = None  # parser AST before planning

    def name(self) -> str:
        return "(<scalar subquery>)"

    def to_field(self, schema: Schema) -> Field:
        sub_schema = self.plan.schema()
        f = sub_schema.fields[0]
        return Field(self.name(), f.dtype, True)


@dataclass(repr=False, eq=False)
class Exists(Expr):
    """EXISTS (SELECT ...); planner decorrelates into a semi/anti join."""

    query: object  # parser Query AST
    negated: bool = False

    def name(self) -> str:
        return ("NOT " if self.negated else "") + "EXISTS(<subquery>)"

    def to_field(self, schema: Schema) -> Field:
        return Field(self.name(), Boolean, False)


@dataclass(repr=False, eq=False)
class InSubquery(Expr):
    """expr [NOT] IN (SELECT col ...); planner turns into semi/anti join."""

    expr: Expr
    query: object  # parser Query AST
    negated: bool = False

    def name(self) -> str:
        n = "NOT IN" if self.negated else "IN"
        return f"{self.expr.name()} {n} (<subquery>)"

    def children(self) -> List[Expr]:
        return [self.expr]

    def to_field(self, schema: Schema) -> Field:
        return Field(self.name(), Boolean, True)


# ---------------------------------------------------------------------------
# Scalar functions
# ---------------------------------------------------------------------------

# name -> (arity, result type rule). Rule: "same" | "float" | "bool" | "int"
# | "utf8" | callable(schema, args)->DataType
SCALAR_FUNCTIONS = {
    "abs": (1, "same"),
    "sqrt": (1, "float"),
    "exp": (1, "float"),
    "ln": (1, "float"),
    "log": (1, "float"),
    "log2": (1, "float"),
    "log10": (1, "float"),
    "floor": (1, "float"),
    "ceil": (1, "float"),
    "round": (1, "float"),
    "trunc": (1, "float"),
    "signum": (1, "same"),
    "sin": (1, "float"),
    "cos": (1, "float"),
    "tan": (1, "float"),
    "asin": (1, "float"),
    "acos": (1, "float"),
    "atan": (1, "float"),
    "upper": (1, "utf8"),
    "lower": (1, "utf8"),
    "trim": (1, "utf8"),
    "ltrim": (1, "utf8"),
    "rtrim": (1, "utf8"),
    "length": (1, "int"),
    "character_length": (1, "int"),
    "octet_length": (1, "int"),
    "md5": (1, "utf8"),
    "sha224": (1, "utf8"),
    "sha256": (1, "utf8"),
    "sha384": (1, "utf8"),
    "sha512": (1, "utf8"),
    "date_trunc": (2, "arg1"),  # date_trunc('month', d) -> d's type
    "to_timestamp": (1, "timestamp"),
    "substr": (3, "utf8"),
    "concat": (-1, "utf8"),
    "date_part": (2, "int"),
    "extract_year": (1, "int"),
    "extract_month": (1, "int"),
    "extract_day": (1, "int"),
    "nullif": (2, "same"),
    "coalesce": (-1, "same"),
    # ARRAY constructor (reference: rust/core/proto/ballista.proto:105) —
    # numeric/temporal elements, coerced to a common type
    "array": (-1, "array"),
}


@dataclass(repr=False, eq=False)
class ScalarFunction(Expr):
    fn: str
    args: List[Expr]

    def name(self) -> str:
        return f"{self.fn}({', '.join(a.name() for a in self.args)})"

    def children(self) -> List[Expr]:
        return list(self.args)

    def to_field(self, schema: Schema) -> Field:
        if self.fn not in SCALAR_FUNCTIONS:
            raise PlanError(f"unknown scalar function {self.fn}")
        arity, rule = SCALAR_FUNCTIONS[self.fn]
        if arity >= 0 and len(self.args) != arity:
            raise PlanError(f"{self.fn} expects {arity} args, got {len(self.args)}")
        nullable = any(a.to_field(schema).nullable for a in self.args)
        if rule == "same":
            return Field(self.name(), self.args[0].to_field(schema).dtype, nullable)
        if rule == "float":
            return Field(self.name(), Float64, nullable)
        if rule == "int":
            return Field(self.name(), Int32, nullable)
        if rule == "bool":
            return Field(self.name(), Boolean, nullable)
        if rule == "utf8":
            return Field(self.name(), Utf8, nullable)
        if rule == "arg1":
            return Field(self.name(), self.args[1].to_field(schema).dtype, nullable)
        if rule == "timestamp":
            from .datatypes import TimestampNs

            return Field(self.name(), TimestampNs, nullable)
        if rule == "array":
            from .datatypes import FixedSizeList

            if not self.args:
                raise PlanError("array() requires at least one argument")
            dts = [a.to_field(schema).dtype for a in self.args]
            if any(d.kind in ("utf8", "list") for d in dts):
                raise PlanError("array() supports numeric/temporal elements")
            elem = dts[0]
            for d in dts[1:]:
                elem = d if d == elem else common_numeric_type(elem, d)
            return Field(self.name(), FixedSizeList(elem, len(self.args)),
                         nullable)
        raise PlanError(f"bad rule for {self.fn}")


# ---------------------------------------------------------------------------
# Aggregate expressions (the reference's 5: MIN/MAX/SUM/AVG/COUNT)
# ---------------------------------------------------------------------------

AGG_FUNCTIONS = ("sum", "avg", "min", "max", "count", "count_distinct")


@dataclass(repr=False, eq=False)
class AggregateExpr(Expr):
    fn: str  # one of AGG_FUNCTIONS
    expr: Expr  # inner expression (Literal(1) for COUNT(*))
    is_star: bool = False

    def name(self) -> str:
        if self.fn == "count" and self.is_star:
            return "COUNT(*)"
        if self.fn == "count_distinct":
            return f"COUNT(DISTINCT {self.expr.name()})"
        return f"{self.fn.upper()}({self.expr.name()})"

    def children(self) -> List[Expr]:
        return [self.expr]

    def to_field(self, schema: Schema) -> Field:
        if self.fn in ("count", "count_distinct"):
            return Field(self.name(), Int64, False)
        inner = self.expr.to_field(schema)
        if self.fn == "avg":
            # exact-ish fixed-point average for int/decimal inputs: TPU has
            # no fast f64, so sum stays int64 and avg is scaled to 6 dp
            if inner.dtype.is_integer or inner.dtype.kind == "decimal":
                return Field(self.name(), Decimal(6), True)
            return Field(self.name(), Float64, True)
        if self.fn == "sum":
            dt = inner.dtype
            if dt.is_integer:
                dt = Int64
            return Field(self.name(), dt, True)
        # min/max keep input type
        return Field(self.name(), inner.dtype, True)


# ---------------------------------------------------------------------------
# Sort key
# ---------------------------------------------------------------------------


@dataclass(repr=False, eq=False)
class SortExpr(Expr):
    expr: Expr
    ascending: bool = True
    nulls_first: bool = False

    def name(self) -> str:
        d = "ASC" if self.ascending else "DESC"
        return f"{self.expr.name()} {d}"

    def children(self) -> List[Expr]:
        return [self.expr]

    def to_field(self, schema: Schema) -> Field:
        return self.expr.to_field(schema)


# ---------------------------------------------------------------------------
# Public constructors (mirrors reference python functions module,
# reference: python/src/functions.rs:1-171)
# ---------------------------------------------------------------------------


def col(name: str) -> ColumnRef:
    if "." in name:
        rel, c = name.split(".", 1)
        return ColumnRef(c, rel)
    return ColumnRef(name)


def lit(v) -> Literal:
    return Literal.infer(v)


def date_lit(s: str) -> Literal:
    return Literal(parse_date_literal(s), Date32)


def sum_(e: Expr) -> AggregateExpr:
    return AggregateExpr("sum", e)


def avg(e: Expr) -> AggregateExpr:
    return AggregateExpr("avg", e)


def min_(e: Expr) -> AggregateExpr:
    return AggregateExpr("min", e)


def max_(e: Expr) -> AggregateExpr:
    return AggregateExpr("max", e)


def count(e: Optional[Expr] = None) -> AggregateExpr:
    if e is None:
        return AggregateExpr("count", Literal(1, Int64), is_star=True)
    return AggregateExpr("count", e)


def count_distinct(e: Expr) -> AggregateExpr:
    return AggregateExpr("count_distinct", e)


def case(base: Optional[Expr] = None) -> "CaseBuilder":
    return CaseBuilder(base)


class CaseBuilder:
    """Fluent CASE builder (reference: python/src/expression.rs CaseBuilder)."""

    def __init__(self, base: Optional[Expr] = None):
        self._base = base
        self._branches: List[Tuple[Expr, Expr]] = []
        self._otherwise: Optional[Expr] = None

    def when(self, cond, then) -> "CaseBuilder":
        self._branches.append((_wrap(cond), _wrap(then)))
        return self

    def otherwise(self, v) -> Case:
        self._otherwise = _wrap(v)
        return self.end()

    def end(self) -> Case:
        return Case(self._base, self._branches, self._otherwise)


# -- tree utilities ---------------------------------------------------------


def walk(e: Expr):
    yield e
    for c in e.children():
        if c is not None:
            yield from walk(c)


def referenced_columns(e: Expr) -> List[str]:
    out = []
    for node in walk(e):
        if isinstance(node, ColumnRef) and node.column not in out:
            out.append(node.column)
    return out


def strip_alias(e: Expr) -> Expr:
    while isinstance(e, Alias):
        e = e.expr
    return e
