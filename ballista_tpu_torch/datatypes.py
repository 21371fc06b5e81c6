"""Arrow-flavored type system (copied from the JAX package's
``datatypes.py``; ``DataType.torch_dtype`` is the port's addition).

The reference engine uses the Arrow type system directly (reference:
rust/core/proto/ballista.proto:611-800 defines Schema/Field/ArrowType
messages). We keep the same *logical* types but fix the *physical* device
representation up front, because XLA/TPU wants static dtypes and has no
efficient float64 or variable-length strings:

- ``Utf8``      -> dictionary-encoded int32 codes on device; the dictionary
                   (numpy object array of Python strings) stays host-side.
- ``Decimal``   -> scaled int64 ("value * 10^scale"), giving exact arithmetic
                   on TPU where f64 is emulated and slow. Sums of TPC-H money
                   columns stay well inside int64.
- ``Date32``    -> int32 days since Unix epoch (same as Arrow).
- ``Boolean``   -> bool_ on device.

Everything here is hashable/frozen so schemas can key jit caches.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from .errors import SchemaError


# ---------------------------------------------------------------------------
# DataType
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataType:
    """Logical data type. ``kind`` is one of the KIND_* constants."""

    kind: str
    # Decimal only: digits after the point. Physical value = logical * 10**scale.
    scale: int = 0
    # FixedSizeList only: element type + fixed per-row length. Physical
    # representation is a (capacity, length) device array of the element's
    # physical dtype (SoA stays rectangular — no ragged buffers on TPU).
    element: Optional["DataType"] = None
    length: int = 0

    # -- constructors -------------------------------------------------------

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        if self.kind == "decimal":
            return f"Decimal(scale={self.scale})"
        if self.kind == "list":
            return f"FixedSizeList({self.element!r}, {self.length})"
        return self.kind.capitalize()

    # -- classification -----------------------------------------------------

    @property
    def is_numeric(self) -> bool:
        return self.kind in ("int32", "int64", "float32", "float64", "decimal")

    @property
    def is_integer(self) -> bool:
        return self.kind in ("int32", "int64")

    @property
    def is_floating(self) -> bool:
        return self.kind in ("float32", "float64")

    @property
    def is_string(self) -> bool:
        return self.kind == "utf8"

    @property
    def is_temporal(self) -> bool:
        return self.kind in ("date32", "timestamp_ns")

    # -- device representation ----------------------------------------------

    def device_dtype(self) -> np.dtype:
        """numpy dtype of the on-device physical column."""
        m = {
            "int32": np.int32,
            "int64": np.int64,
            "float32": np.float32,
            "float64": np.float32,  # TPU: f64 stored as f32 on device
            "decimal": np.int64,
            "boolean": np.bool_,
            "date32": np.int32,
            "timestamp_ns": np.int64,  # epoch nanoseconds
            "utf8": np.int32,  # dictionary codes
        }
        if self.kind == "list":
            return self.element.device_dtype()
        if self.kind not in m:
            raise SchemaError(f"no device representation for {self.kind}")
        return np.dtype(m[self.kind])

    def torch_dtype(self):
        """torch dtype of the on-device physical column (the same
        physical representation as ``device_dtype``: Float64 stays
        float32, so results match the JAX package bit for bit)."""
        return torch_dtype_of(self.device_dtype())


def torch_dtype_of(np_dtype) -> "torch.dtype":
    """numpy physical dtype -> torch dtype (numpy and torch share the
    names of every physical dtype the engine uses)."""
    import torch

    return getattr(torch, np.dtype(np_dtype).name)


Int32 = DataType("int32")
Int64 = DataType("int64")
Float32 = DataType("float32")
Float64 = DataType("float64")
Boolean = DataType("boolean")
Utf8 = DataType("utf8")
Date32 = DataType("date32")
# Epoch-nanosecond timestamps (the reference's TOTIMESTAMP result type,
# reference: rust/core/proto/ballista.proto:104 TOTIMESTAMP)
TimestampNs = DataType("timestamp_ns")


def Decimal(scale: int = 2) -> DataType:
    return DataType("decimal", scale=scale)


def FixedSizeList(element: DataType, length: int) -> DataType:
    """ARRAY constructor result type (reference surface:
    rust/core/proto/ballista.proto:105 ARRAY -> DataFusion fixed-size
    list). Rectangular (capacity, length) physical layout."""
    if element.kind == "list":
        raise SchemaError("nested lists are not supported")
    return DataType("list", element=element, length=length)


_BY_NAME = {
    "int": Int64,
    "i32": Int32,
    "i64": Int64,
    "int32": Int32,
    "int64": Int64,
    "bigint": Int64,
    "integer": Int32,
    "f32": Float32,
    "f64": Float64,
    "float": Float32,
    "float32": Float32,
    "float64": Float64,
    "double": Float64,
    "bool": Boolean,
    "boolean": Boolean,
    "utf8": Utf8,
    "str": Utf8,
    "string": Utf8,
    "varchar": Utf8,
    "text": Utf8,
    "date": Date32,
    "date32": Date32,
    "timestamp": TimestampNs,
    "timestamp_ns": TimestampNs,
    "datetime": TimestampNs,
}


def dtype_from_name(name: str) -> DataType:
    """Parse a type name (as used in SQL DDL / config strings)."""
    key = name.strip().lower()
    if key.startswith("decimal"):
        # decimal(p, s) — precision ignored, scale kept
        if "(" in key:
            inner = key[key.index("(") + 1 : key.rindex(")")]
            parts = [p.strip() for p in inner.split(",")]
            scale = int(parts[1]) if len(parts) > 1 else 0
            return Decimal(scale)
        return Decimal(2)
    if key in _BY_NAME:
        return _BY_NAME[key]
    raise SchemaError(f"unknown type name: {name!r}")


# ---------------------------------------------------------------------------
# Field / Schema
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        n = "" if self.nullable else " NOT NULL"
        return f"{self.name}: {self.dtype!r}{n}"


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __init__(self, fields: Iterable[Field]):
        object.__setattr__(self, "fields", tuple(fields))

    # -- access -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise SchemaError(f"field {name!r} not in schema {self.names()}")

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise SchemaError(f"field {name!r} not in schema {self.names()}")

    def has_field(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def project(self, names: Sequence[str]) -> "Schema":
        return Schema([self.field(n) for n in names])

    def merge(self, other: "Schema") -> "Schema":
        return Schema(list(self.fields) + list(other.fields))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        inner = ", ".join(repr(f) for f in self.fields)
        return f"Schema[{inner}]"


def schema(*pairs, nullable: bool = True) -> Schema:
    """Convenience: schema(("a", Int64), ("b", "utf8"), ...)."""
    fields = []
    for name, dt in pairs:
        if isinstance(dt, str):
            dt = dtype_from_name(dt)
        fields.append(Field(name, dt, nullable))
    return Schema(fields)


# ---------------------------------------------------------------------------
# Type coercion rules (used by the expression binder)
# ---------------------------------------------------------------------------

_NUMERIC_ORDER = ["int32", "int64", "decimal", "float32", "float64"]


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Result type for binary arithmetic/comparison between a and b."""
    if a == b:
        return a
    if a.kind == "date32" and b.is_integer:
        return a
    if b.kind == "date32" and a.is_integer:
        return b
    if not (a.is_numeric and b.is_numeric):
        if a.kind == b.kind:
            return a
        raise SchemaError(f"no common type for {a!r} and {b!r}")
    if a.kind == "decimal" and b.kind == "decimal":
        return Decimal(max(a.scale, b.scale))
    ia, ib = _NUMERIC_ORDER.index(a.kind), _NUMERIC_ORDER.index(b.kind)
    winner = a if ia >= ib else b
    if winner.kind == "decimal":
        return Decimal(winner.scale)
    return winner
