"""Evaluation of logical expressions against a ColumnBatch.

The port of the JAX package's ``kernels/expr_eval.py`` to eager torch ops
on the batch's device (the JAX version is traced into a jit; here each op
runs as it is called).

Conventions:
- decimals are scaled int64; arithmetic tracks scales exactly (see
  datatypes.py);
- float64 results are computed/stored as f32 on device, as in the JAX
  package (f32 rather than f64 keeps the physical types of the two
  packages identical) — exactness-critical reductions stay in int64;
- utf8 columns are dictionary codes; string predicates (equality, ordering,
  LIKE, substr...) are evaluated *on the host dictionary once* and become
  cheap gathers/compares over the codes on device;
- scalars (literals) are 0-d tensors on the batch's device; every
  operand is cast explicitly before mixing dtypes, because torch does not
  let a 0-d tensor widen a 1-d one of the same kind (int32 column vs
  int64 literal stays int32), where JAX does;
- SQL NULL: validity masks propagate through; predicates treat NULL as
  False at filter boundaries.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..columnar import Column, ColumnBatch, Dictionary
from ..datatypes import (
    Boolean,
    DataType,
    Date32,
    Decimal,
    Float64,
    Int32,
    Int64,
    Schema,
    Utf8,
)
from ..errors import NotImplementedError_, PlanError
from .. import expr as ex
from . import dates as date_kernels


@dataclass
class Evaluated:
    """Result of evaluating one expression: tensor values + metadata."""

    values: torch.Tensor  # 0-d or [capacity]
    dtype: DataType
    validity: Optional[torch.Tensor] = None  # bool, None = all valid
    dictionary: Optional[Dictionary] = None
    # set when this is a literal: the exact Python value, enabling exact
    # decimal-vs-float-literal comparisons (no f32 boundary drift)
    literal_value: object = None

    def valid_or(self, cap: int) -> torch.Tensor:
        if self.validity is None:
            return torch.ones((cap,), dtype=torch.bool,
                              device=self.values.device)
        return torch.broadcast_to(self.validity, (cap,))


def _and_validity(*vs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    present = [v for v in vs if v is not None]
    if not present:
        return None
    out = present[0]
    for v in present[1:]:
        out = torch.logical_and(out, v)
    return out


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _gather_clip(table: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """``table[codes]`` with codes clamped into range — the counterpart of
    ``jnp.take(..., mode="clip")`` (torch raises on an out-of-range index,
    and asserts on CUDA)."""
    t = torch.from_numpy(np.ascontiguousarray(table)).to(codes.device)
    if t.shape[0] == 0:
        return torch.zeros(codes.shape, dtype=t.dtype, device=codes.device)
    idx = codes.to(torch.int64).clamp(0, t.shape[0] - 1)
    return t[idx]


class Evaluator:
    """Evaluates logical Exprs against batches of a fixed input schema."""

    def __init__(self, schema: Schema):
        self.schema = schema

    # ------------------------------------------------------------------ API

    def evaluate(self, e: ex.Expr, batch: ColumnBatch) -> Evaluated:
        method = getattr(self, "_eval_" + type(e).__name__, None)
        if method is None:
            raise NotImplementedError_(f"cannot evaluate {type(e).__name__}")
        return method(e, batch)

    def evaluate_predicate(self, e: ex.Expr, batch: ColumnBatch) -> torch.Tensor:
        """Boolean mask [capacity]; NULL -> False."""
        r = self.evaluate(e, batch)
        if r.dtype != Boolean:
            raise PlanError(f"predicate has type {r.dtype!r}, expected boolean")
        mask = torch.broadcast_to(r.values, (batch.capacity,))
        if r.validity is not None:
            mask = torch.logical_and(mask, r.validity)
        return mask

    def to_column(self, e: ex.Expr, batch: ColumnBatch) -> Column:
        r = self.evaluate(e, batch)
        # scalar/1-D values broadcast to (capacity,); fixed-size-list
        # values keep their trailing element axis: (capacity, length)
        trailing = tuple(r.values.shape)[1:]
        vals = torch.broadcast_to(r.values, (batch.capacity,) + trailing)
        return Column(vals, r.dtype, r.validity, r.dictionary)

    # ----------------------------------------------------------- leaf nodes

    def _eval_ColumnRef(self, e: ex.ColumnRef, batch: ColumnBatch) -> Evaluated:
        idx = batch.schema.index_of(e.column)
        col = batch.columns[idx]
        return Evaluated(col.values, col.dtype, col.validity, col.dictionary)

    def _eval_Literal(self, e: ex.Literal, batch: ColumnBatch) -> Evaluated:
        dev = batch.device
        if e.value is None:
            cap = batch.capacity
            return Evaluated(
                torch.zeros((), dtype=e.dtype.torch_dtype(), device=dev),
                e.dtype,
                torch.zeros((cap,), dtype=torch.bool, device=dev),
            )
        if e.dtype.kind == "utf8":
            # bare utf8 literal (e.g. in projection): 1-entry dictionary
            d = Dictionary([e.value])
            return Evaluated(torch.zeros((), dtype=torch.int32, device=dev),
                             Utf8, None, d)
        v = e.value
        if e.dtype.kind == "decimal":
            v = int(round(float(v) * 10 ** e.dtype.scale))
        return Evaluated(
            torch.tensor(v, dtype=e.dtype.torch_dtype(), device=dev), e.dtype,
            literal_value=e.value,
        )

    # ------------------------------------------------------------- wrappers

    def _eval_Alias(self, e: ex.Alias, batch: ColumnBatch) -> Evaluated:
        return self.evaluate(e.expr, batch)

    def _eval_SortExpr(self, e: ex.SortExpr, batch: ColumnBatch) -> Evaluated:
        return self.evaluate(e.expr, batch)

    def _eval_Not(self, e: ex.Not, batch: ColumnBatch) -> Evaluated:
        r = self.evaluate(e.expr, batch)
        return Evaluated(torch.logical_not(r.values), Boolean, r.validity)

    def _eval_IsNull(self, e: ex.IsNull, batch: ColumnBatch) -> Evaluated:
        r = self.evaluate(e.expr, batch)
        if r.validity is None:
            return Evaluated(torch.zeros((batch.capacity,), dtype=torch.bool,
                                         device=batch.device), Boolean)
        return Evaluated(torch.logical_not(r.validity), Boolean)

    def _eval_IsNotNull(self, e: ex.IsNotNull, batch: ColumnBatch) -> Evaluated:
        r = self.evaluate(e.expr, batch)
        if r.validity is None:
            return Evaluated(torch.ones((batch.capacity,), dtype=torch.bool,
                                        device=batch.device), Boolean)
        return Evaluated(r.validity, Boolean)

    def _eval_Cast(self, e: ex.Cast, batch: ColumnBatch) -> Evaluated:
        r = self.evaluate(e.expr, batch)
        return self._cast(r, e.dtype)

    def _cast(self, r: Evaluated, to: DataType) -> Evaluated:
        if r.dtype == to:
            return r
        src, dst = r.dtype, to
        v = r.values
        if dst.kind == "decimal":
            if src.kind == "decimal":
                shift = dst.scale - src.scale
                if shift >= 0:
                    out = v.to(torch.int64) * (10 ** shift)
                else:  # floors, as jnp's // does
                    out = v.to(torch.int64) // (10 ** (-shift))
            elif src.is_integer:
                out = v.to(torch.int64) * (10 ** dst.scale)
            elif src.is_floating:
                out = torch.round(_f32(v) * (10.0 ** dst.scale)).to(torch.int64)
            else:
                raise PlanError(f"cast {src!r} -> {dst!r} unsupported")
            return Evaluated(out, dst, r.validity)
        if dst.is_floating:
            if src.kind == "decimal":
                out = _f32(v) / (10.0 ** src.scale)
            else:
                out = _f32(v)
            return Evaluated(out, dst, r.validity)
        if dst.is_integer:
            if src.kind == "decimal":
                out = (v // (10 ** src.scale)).to(dst.torch_dtype())
            else:
                out = v.to(dst.torch_dtype())
            return Evaluated(out, dst, r.validity)
        if dst.kind == "date32" and src.is_integer:
            return Evaluated(v.to(torch.int32), dst, r.validity)
        if dst.kind == "boolean":
            return Evaluated(v.to(torch.bool), dst, r.validity)
        raise PlanError(f"cast {src!r} -> {dst!r} unsupported")

    # --------------------------------------------------------------- binary

    def _eval_BinaryExpr(self, e: ex.BinaryExpr, batch: ColumnBatch) -> Evaluated:
        op = e.op
        l = self.evaluate(e.left, batch)
        r = self.evaluate(e.right, batch)
        validity = _and_validity(l.validity, r.validity)

        if op in ex.BOOL_OPS:
            # NULL-as-False at boolean combinators (adequate for TPC-H)
            lv = l.values if l.validity is None else torch.logical_and(l.values, l.validity)
            rv = r.values if r.validity is None else torch.logical_and(r.values, r.validity)
            fn = torch.logical_and if op == "and" else torch.logical_or
            return Evaluated(fn(lv, rv), Boolean, None)

        if op in ex.CMP_OPS:
            return self._compare(op, l, r, validity)

        # arithmetic
        return self._arith(op, l, r, validity)

    # comparison ----------------------------------------------------------

    _CMP = {
        "=": torch.eq,
        "!=": torch.ne,
        "<": torch.lt,
        "<=": torch.le,
        ">": torch.gt,
        ">=": torch.ge,
    }

    def _compare(self, op, l: Evaluated, r: Evaluated, validity) -> Evaluated:
        # utf8 handling
        if l.dtype.kind == "utf8" or r.dtype.kind == "utf8":
            return self._compare_utf8(op, l, r, validity)
        # exact decimal column vs numeric literal: integer threshold compare
        if l.dtype.kind == "decimal" and r.literal_value is not None \
                and r.dtype.is_numeric and r.dtype.kind != "decimal":
            res = self._compare_decimal_literal(op, l, r.literal_value, validity)
            if res is not None:
                return res
        if r.dtype.kind == "decimal" and l.literal_value is not None \
                and l.dtype.is_numeric and l.dtype.kind != "decimal":
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                    "=": "=", "!=": "!="}
            res = self._compare_decimal_literal(
                flip[op], r, l.literal_value, validity
            )
            if res is not None:
                return res
        lv, rv = self._coerce_pair(l, r)
        return Evaluated(self._CMP[op](lv, rv), Boolean, validity)

    _I64_MAX = (1 << 63) - 1
    _I64_MIN = -(1 << 63)

    def _compare_decimal_literal(self, op, col: Evaluated, lit_val,
                                 validity) -> Optional[Evaluated]:
        """decimal(s) column vs float/int literal without f32 drift: the
        literal scales to c*10^s in host float64, then integer thresholds
        (floor/ceil) make every comparison exact. Returns None for
        non-finite literals (caller falls back to the generic float path,
        where NaN compares all-false)."""
        import math

        n = tuple(col.values.shape)
        dev = col.values.device
        c = float(lit_val) * (10 ** col.dtype.scale)
        if not math.isfinite(c):
            return None
        v = col.values.to(torch.int64)
        # literals beyond int64 range: every value is on one side
        if c > self._I64_MAX:
            true_ops = ("<", "<=", "!=")
        elif c < self._I64_MIN:
            true_ops = (">", ">=", "!=")
        else:
            true_ops = None
        if true_ops is not None:
            fill = torch.full(n, op in true_ops, dtype=torch.bool, device=dev)
            return Evaluated(fill, Boolean, validity)
        # relative tolerance: double rounding error grows with |c|
        is_int = abs(c - round(c)) <= max(1e-9, abs(c) * 1e-12)
        ci = int(round(c))
        if op == "=":
            out = (v == ci) if is_int else torch.zeros(n, dtype=torch.bool, device=dev)
        elif op == "!=":
            out = (v != ci) if is_int else torch.ones(n, dtype=torch.bool, device=dev)
        elif op == "<":
            out = v < (ci if is_int else math.ceil(c))
        elif op == "<=":
            out = v <= (ci if is_int else math.floor(c))
        elif op == ">":
            out = v > (ci if is_int else math.floor(c))
        else:  # >=
            out = v >= (ci if is_int else math.ceil(c))
        return Evaluated(out, Boolean, validity)

    def _compare_utf8(self, op, l: Evaluated, r: Evaluated, validity) -> Evaluated:
        # date column vs string literal
        if l.dtype.kind == "date32" and r.dtype.kind == "utf8":
            days = ex.parse_date_literal(self._literal_str(r))
            return Evaluated(
                self._CMP[op](l.values.to(torch.int32), int(days)), Boolean,
                validity,
            )
        if r.dtype.kind == "date32" and l.dtype.kind == "utf8":
            days = ex.parse_date_literal(self._literal_str(l))
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}
            return Evaluated(
                self._CMP[flip[op]](r.values.to(torch.int32), int(days)),
                Boolean, validity,
            )
        # dict-coded column vs string literal
        if l.dictionary is not None and r.dictionary is not None:
            if len(r.dictionary) == 1:  # literal on the right
                return self._compare_codes_literal(
                    op, l, r.dictionary.values[0], validity
                )
            if len(l.dictionary) == 1:  # literal on the left (flip op)
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}
                return self._compare_codes_literal(
                    flip[op], r, l.dictionary.values[0], validity
                )
            if l.dictionary is r.dictionary:
                return Evaluated(self._CMP[op](l.values, r.values), Boolean, validity)
            raise NotImplementedError_(
                "comparison between differently-encoded utf8 columns"
            )
        raise PlanError("utf8 comparison requires dictionary-encoded operands")

    def _compare_codes_literal(self, op, col: Evaluated, s: str, validity) -> Evaluated:
        d = col.dictionary
        codes = col.values
        if op in ("=", "!="):
            code = d.code_of(s)
            if code < 0:
                out = torch.zeros(codes.shape, dtype=torch.bool,
                                  device=codes.device)
            else:
                out = torch.eq(codes, code)
            if op == "!=":
                out = torch.logical_not(out)
            return Evaluated(out, Boolean, validity)
        # ordering against a sorted dictionary: code-space boundary compare
        lo, hi = d.code_range(s)
        if op == "<":
            out = codes < lo
        elif op == "<=":
            out = codes < hi
        elif op == ">":
            out = codes >= hi
        else:  # >=
            out = codes >= lo
        return Evaluated(out, Boolean, validity)

    def _literal_str(self, r: Evaluated) -> str:
        if r.dictionary is None or len(r.dictionary) != 1:
            raise PlanError("expected a string literal")
        return str(r.dictionary.values[0])

    def _coerce_pair(self, l: Evaluated, r: Evaluated):
        """Coerce two numeric/temporal operands to a directly comparable repr."""
        a, b = l.dtype, r.dtype
        if a.kind == "decimal" or b.kind == "decimal":
            if a.is_floating or b.is_floating:
                lv = _f32(l.values) / (10.0 ** a.scale) if a.kind == "decimal" else _f32(l.values)
                rv = _f32(r.values) / (10.0 ** b.scale) if b.kind == "decimal" else _f32(r.values)
                return lv, rv
            sa = a.scale if a.kind == "decimal" else 0
            sb = b.scale if b.kind == "decimal" else 0
            s = max(sa, sb)
            lv = l.values.to(torch.int64) * (10 ** (s - sa))
            rv = r.values.to(torch.int64) * (10 ** (s - sb))
            return lv, rv
        if a.is_floating or b.is_floating:
            return _f32(l.values), _f32(r.values)
        if a.kind == "date32" or b.kind == "date32":
            return l.values.to(torch.int32), r.values.to(torch.int32)
        if a.kind == "int64" or b.kind == "int64":
            return l.values.to(torch.int64), r.values.to(torch.int64)
        return l.values, r.values

    # arithmetic -----------------------------------------------------------

    def _arith(self, op, l: Evaluated, r: Evaluated, validity) -> Evaluated:
        a, b = l.dtype, r.dtype
        # dates
        if a.kind == "date32" or b.kind == "date32":
            lv = l.values.to(torch.int32)
            rv = r.values.to(torch.int32)
            if op == "+":
                return Evaluated(lv + rv, Date32, validity)
            if op == "-":
                out_t = Int32 if (a.kind == b.kind == "date32") else Date32
                return Evaluated(lv - rv, out_t, validity)
            raise PlanError(f"op {op} invalid for dates")
        # decimal exact paths
        if (a.kind == "decimal" or b.kind == "decimal") and not (
            a.is_floating or b.is_floating
        ):
            sa = a.scale if a.kind == "decimal" else 0
            sb = b.scale if b.kind == "decimal" else 0
            lv = l.values.to(torch.int64)
            rv = r.values.to(torch.int64)
            if op in ("+", "-"):
                s = max(sa, sb)
                lv = lv * (10 ** (s - sa))
                rv = rv * (10 ** (s - sb))
                out = lv + rv if op == "+" else lv - rv
                return Evaluated(out, Decimal(s), validity)
            if op == "*":
                return Evaluated(lv * rv, Decimal(sa + sb), validity)
            if op == "/":
                out = (_f32(lv) / (10.0 ** sa)) / (_f32(rv) / (10.0 ** sb))
                return Evaluated(out, Float64, validity)
            raise PlanError(f"op {op} unsupported on decimal")
        # float path (int/int division stays integer, matching the planner's
        # _arith_result_type: SQL integer division truncates toward zero)
        int_int = a.is_integer and b.is_integer
        if a.is_floating or b.is_floating or (op == "/" and not int_int):
            lv = _f32(l.values) / (10.0 ** a.scale) if a.kind == "decimal" else _f32(l.values)
            rv = _f32(r.values) / (10.0 ** b.scale) if b.kind == "decimal" else _f32(r.values)
            out = {"+": torch.add, "-": torch.sub, "*": torch.mul,
                   "/": torch.div, "%": torch.remainder}[op](lv, rv)
            return Evaluated(out, Float64, validity)
        # integer path
        out_t = Int64 if (a.kind == "int64" or b.kind == "int64") else Int32
        lv = l.values.to(out_t.torch_dtype())
        rv = r.values.to(out_t.torch_dtype())
        if op == "/":
            # truncating integer division (lax.div), not floor
            out = torch.div(lv, rv, rounding_mode="trunc")
        else:
            out = {"+": torch.add, "-": torch.sub, "*": torch.mul,
                   "%": torch.remainder}[op](lv, rv)
        return Evaluated(out, out_t, validity)

    # ------------------------------------------------------------ compound

    def _eval_InList(self, e: ex.InList, batch: ColumnBatch) -> Evaluated:
        base = self.evaluate(e.expr, batch)
        acc = None
        for item in e.list:
            cmp = self._compare("=", base, self.evaluate(item, batch), None)
            acc = cmp.values if acc is None else torch.logical_or(acc, cmp.values)
        if acc is None:
            acc = torch.zeros((batch.capacity,), dtype=torch.bool,
                              device=batch.device)
        if e.negated:
            acc = torch.logical_not(acc)
        return Evaluated(acc, Boolean, base.validity)

    def _eval_Like(self, e: ex.Like, batch: ColumnBatch) -> Evaluated:
        base = self.evaluate(e.expr, batch)
        if base.dictionary is None:
            raise NotImplementedError_("LIKE on non-dictionary column")
        # SQL LIKE -> regex on the host dictionary, gather match by code
        pat = re.escape(str(e.pattern)).replace("%", ".*").replace("_", ".")
        rx = re.compile("^" + pat + "$", re.S)
        host = np.asarray(
            [bool(rx.match(str(v))) for v in base.dictionary.values], dtype=np.bool_
        )
        out = _gather_clip(host, base.values)
        if e.negated:
            out = torch.logical_not(out)
        return Evaluated(out, Boolean, base.validity)

    def _eval_Case(self, e: ex.Case, batch: ColumnBatch) -> Evaluated:
        # Evaluate all branches; select with torch.where chains.
        cap = batch.capacity
        conds = []
        thens = []
        for w, t in e.branches:
            if e.base is not None:
                c = self._eval_BinaryExpr(ex.BinaryExpr(e.base, "=", w), batch)
            else:
                c = self.evaluate(w, batch)
            conds.append(c)
            thens.append(self.evaluate(t, batch))
        if e.otherwise is not None:
            other = self.evaluate(e.otherwise, batch)
        else:
            other = Evaluated(
                torch.zeros((), dtype=thens[0].values.dtype,
                            device=batch.device),
                thens[0].dtype,
                torch.zeros((cap,), dtype=torch.bool, device=batch.device),
            )
        out_dtype = thens[0].dtype
        # normalize all THEN/ELSE branches to out_dtype
        norm = [self._cast(t, out_dtype) for t in thens]
        other = self._cast(other, out_dtype)
        vals = torch.broadcast_to(other.values, (cap,))
        validity = other.validity
        for c, t in zip(reversed(conds), reversed(norm)):
            cm = torch.broadcast_to(c.values, (cap,))
            if c.validity is not None:
                cm = torch.logical_and(cm, c.validity)
            vals = torch.where(cm, torch.broadcast_to(t.values, (cap,)), vals)
            tv = t.valid_or(cap)
            ov = validity if validity is not None else torch.ones(
                (cap,), dtype=torch.bool, device=batch.device
            )
            validity = torch.where(cm, tv, ov)
        return Evaluated(vals, out_dtype, validity)

    # ------------------------------------------------------ scalar functions

    def _eval_ScalarFunction(self, e: ex.ScalarFunction, batch: ColumnBatch) -> Evaluated:
        fn = e.fn
        # string functions -> host dictionary transforms
        if fn in ("upper", "lower", "trim", "ltrim", "rtrim", "substr", "length",
                  "character_length", "octet_length", "concat", "md5",
                  "sha224", "sha256", "sha384", "sha512", "to_timestamp"):
            return self._eval_string_fn(e, batch)
        if fn in ("extract_year", "extract_month", "extract_day", "date_part",
                  "date_trunc"):
            return self._eval_date_fn(e, batch)
        args = [self.evaluate(a, batch) for a in e.args]
        validity = _and_validity(*[a.validity for a in args])
        cap = batch.capacity
        if fn == "array":
            # rectangular (capacity, n) stack; a NULL element NULLs the row
            # (documented restriction — no per-element validity planes)
            out_f = e.to_field(batch.schema)
            elem = out_f.dtype.element
            norm = [self._cast(a, elem) for a in args]
            stacked = torch.stack(
                [torch.broadcast_to(a.values, (cap,)) for a in norm], dim=1)
            return Evaluated(stacked, out_f.dtype, validity)
        if fn == "nullif":
            eqr = self._compare("=", args[0], args[1], None)
            base_valid = args[0].valid_or(cap)
            new_valid = torch.logical_and(base_valid, torch.logical_not(eqr.values))
            return Evaluated(args[0].values, args[0].dtype, new_valid)
        if fn == "coalesce":
            out_dtype = args[0].dtype
            norm = [self._cast(a, out_dtype) for a in args]
            out = torch.broadcast_to(norm[-1].values, (cap,))
            validity = norm[-1].validity
            for a in reversed(norm[:-1]):
                av = a.valid_or(cap)
                out = torch.where(av, torch.broadcast_to(a.values, (cap,)), out)
                validity = torch.logical_or(av, validity) if validity is not None else av
            return Evaluated(out, out_dtype, validity)
        x = args[0]
        if fn == "abs":
            return Evaluated(torch.abs(x.values), x.dtype, validity)
        if fn == "signum":
            return Evaluated(torch.sign(x.values), x.dtype, validity)
        # float math
        xv = _f32(x.values)
        if x.dtype.kind == "decimal":
            xv = xv / (10.0 ** x.dtype.scale)
        tfn = {
            "sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log,
            "log": torch.log, "log2": torch.log2, "log10": torch.log10,
            "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
            "trunc": torch.trunc, "sin": torch.sin, "cos": torch.cos,
            "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
            "atan": torch.atan,
        }.get(fn)
        if tfn is None:
            raise NotImplementedError_(f"scalar function {fn}")
        return Evaluated(tfn(xv), Float64, validity)

    @staticmethod
    def _literal_part(e: ex.ScalarFunction, arg_index: int = 0) -> str:
        part = e.args[arg_index]
        name = part.value if isinstance(part, ex.Literal) else None
        if name is None:
            raise PlanError(f"{e.fn} requires a literal part name")
        return str(name).lower()

    _NS_PER_DAY = 86_400_000_000_000

    def _as_epoch_days(self, x: Evaluated):
        """Temporal value -> days-since-epoch int32 (timestamps floor to
        their calendar day)."""
        if x.dtype.kind == "timestamp_ns":
            return torch.div(x.values, self._NS_PER_DAY,
                             rounding_mode="floor").to(torch.int32)
        return x.values

    _NS_PER = {"hour": 3_600_000_000_000, "minute": 60_000_000_000,
               "second": 1_000_000_000}

    def _eval_date_fn(self, e: ex.ScalarFunction, batch: ColumnBatch) -> Evaluated:
        if e.fn == "date_trunc":
            part_name = self._literal_part(e)
            x = self.evaluate(e.args[1], batch)
            if part_name in self._NS_PER or part_name == "day":
                if x.dtype.kind != "timestamp_ns":  # dates: day- no-ops
                    if part_name == "day":
                        return x
                    raise PlanError(
                        f"date_trunc({part_name!r}) needs a timestamp, "
                        f"got {x.dtype}")
                unit = self._NS_PER.get(part_name, self._NS_PER_DAY)
                return Evaluated(
                    torch.div(x.values, unit, rounding_mode="floor") * unit,
                    x.dtype, x.validity)
            if part_name not in ("year", "quarter", "month", "week"):
                raise PlanError(f"date_trunc part {part_name!r}")
            days = self._as_epoch_days(x)
            td = date_kernels.date_trunc(part_name, days)
            if x.dtype.kind == "timestamp_ns":
                td = td.to(torch.int64) * self._NS_PER_DAY
            return Evaluated(td, x.dtype, x.validity)
        if e.fn == "date_part":
            part_name = self._literal_part(e)
            x = self.evaluate(e.args[1], batch)
            return self._extract_part(part_name, x)
        x = self.evaluate(e.args[0], batch)
        return self._extract_part(e.fn.removeprefix("extract_"), x)

    def _extract_part(self, part_name: str, x: Evaluated) -> Evaluated:
        if part_name in self._NS_PER:
            if x.dtype.kind != "timestamp_ns":
                raise PlanError(
                    f"date_part({part_name!r}) needs a timestamp, "
                    f"got {x.dtype}")
            unit = self._NS_PER[part_name]
            mod = (self._NS_PER_DAY if part_name == "hour"
                   else self._NS_PER["hour"] if part_name == "minute"
                   else self._NS_PER["minute"])
            v = torch.div(torch.remainder(x.values, mod), unit,
                          rounding_mode="floor")
            return Evaluated(v.to(torch.int32), Int32, x.validity)
        fn = {"year": date_kernels.extract_year,
              "month": date_kernels.extract_month,
              "day": date_kernels.extract_day}.get(part_name)
        if fn is None:
            raise PlanError(f"date_part part {part_name!r}")
        return Evaluated(fn(self._as_epoch_days(x)), Int32, x.validity)

    def _eval_string_fn(self, e: ex.ScalarFunction, batch: ColumnBatch) -> Evaluated:
        fn = e.fn
        if fn == "concat":
            raise NotImplementedError_("concat over columns (host-side only)")
        base = self.evaluate(e.args[0], batch)
        if base.dictionary is None:
            raise NotImplementedError_(f"{fn} on non-dictionary column")
        d = base.dictionary
        if fn in ("length", "character_length", "octet_length"):
            if fn == "octet_length":  # bytes, not codepoints
                host = np.asarray(
                    [len(str(v).encode("utf-8")) for v in d.values],
                    dtype=np.int32)
            else:
                host = np.asarray([len(str(v)) for v in d.values],
                                  dtype=np.int32)
            return Evaluated(_gather_clip(host, base.values), Int32,
                             base.validity)
        if fn in ("md5", "sha224", "sha256", "sha384", "sha512"):
            # dictionary transform: hash each distinct string once
            import hashlib

            h = getattr(hashlib, fn)
            return self._remapped_dict(
                base, [h(str(v).encode("utf-8")).hexdigest() for v in d.values]
            )
        if fn == "to_timestamp":
            # parse each distinct string once -> epoch-ns lookup table
            from ..datatypes import TimestampNs

            # ns-representable range; np.datetime64(s, "ns") silently
            # WRAPS int64 outside it instead of raising
            lo = np.datetime64("1677-09-22", "s")
            hi = np.datetime64("2262-04-11", "s")

            def parse_one(v):
                try:
                    d = np.datetime64(str(v))  # native unit, no wrap
                except ValueError:
                    return np.datetime64("NaT", "ns")
                if np.isnat(d) or not (lo <= d.astype("datetime64[s]") <= hi):
                    return np.datetime64("NaT", "ns")
                return d.astype("datetime64[ns]")

            parsed = np.asarray([parse_one(v) for v in d.values],
                                dtype="datetime64[ns]")
            host = parsed.astype(np.int64)
            bad = np.isnat(parsed)
            out = _gather_clip(host, base.values)
            validity = base.validity
            if bad.any():
                ok = _gather_clip(~bad, base.values)
                validity = ok if validity is None else torch.logical_and(
                    validity, ok)
            return Evaluated(out, TimestampNs, validity)
        if fn == "substr":
            start = e.args[1]
            length = e.args[2]
            if not (isinstance(start, ex.Literal) and isinstance(length, ex.Literal)):
                raise NotImplementedError_("substr with non-literal bounds")
            s0 = int(start.value) - 1  # SQL 1-based
            ln = int(length.value)
            return self._remapped_dict(base, [str(v)[s0 : s0 + ln] for v in d.values])
        tf = {"upper": str.upper, "lower": str.lower, "trim": str.strip,
              "ltrim": str.lstrip, "rtrim": str.rstrip}[fn]
        return self._remapped_dict(base, [tf(str(v)) for v in d.values])

    def _remapped_dict(self, base: Evaluated, new_values) -> Evaluated:
        # derived dictionaries must stay sorted + duplicate-free for the
        # comparison kernels; canonicalize and remap the codes
        newd, remap = Dictionary.canonicalize(new_values)
        return Evaluated(_gather_clip(remap, base.values), Utf8,
                         base.validity, newd)
