"""Logical type system for the device-native query engine.

Re-designs the reference's type layer (reference: velox/type/Type.h:62 ``TypeKind``,
velox/type/Type.h:438 ``class Type``) for an accelerator execution model.  The key departure:
every logical type maps to a *fixed-width device representation* chosen for XLA
friendliness:

* integer / floating kinds map 1:1 to jnp dtypes;
* DATE is int32 days since the Unix epoch (reference: velox/type/Type.h:1248);
* TIMESTAMP is int64 microseconds since the epoch (the reference stores seconds+nanos,
  velox/type/Timestamp.h — micros in a single int64 is the device-friendly layout);
* short DECIMAL(p<=18, s) is int64 fixed-point scaled by 10**s
  (reference: velox/type/Type.h:665-744) — exact arithmetic without float64 emulation;
* VARCHAR / VARBINARY have no direct device representation: on device they always
  travel dictionary-encoded (int32 codes into a host-side `StringTable`), mirroring the
  reference's aggressive dictionary encoding of strings in scan
  (velox/dwio/dwrf string-dictionary readers).

Complex kinds (ARRAY/MAP/ROW) are represented columnar-offset-style at the Batch layer.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Optional, Tuple

import jax.numpy as jnp


class TypeKind(str, Enum):
    """Mirrors the reference TypeKind enum (velox/type/Type.h:62-84)."""

    BOOLEAN = "BOOLEAN"
    TINYINT = "TINYINT"
    SMALLINT = "SMALLINT"
    INTEGER = "INTEGER"
    BIGINT = "BIGINT"
    HUGEINT = "HUGEINT"
    REAL = "REAL"
    DOUBLE = "DOUBLE"
    VARCHAR = "VARCHAR"
    VARBINARY = "VARBINARY"
    TIMESTAMP = "TIMESTAMP"
    DATE = "DATE"
    DECIMAL = "DECIMAL"
    ARRAY = "ARRAY"
    MAP = "MAP"
    ROW = "ROW"
    UNKNOWN = "UNKNOWN"

    def __repr__(self) -> str:  # pragma: no cover
        return f"TypeKind.{self.name}"


_FIXED_DEVICE_DTYPES = {
    TypeKind.BOOLEAN: jnp.bool_,
    TypeKind.TINYINT: jnp.int8,
    TypeKind.SMALLINT: jnp.int16,
    TypeKind.INTEGER: jnp.int32,
    TypeKind.BIGINT: jnp.int64,
    TypeKind.REAL: jnp.float32,
    TypeKind.DOUBLE: jnp.float64,
    TypeKind.TIMESTAMP: jnp.int64,
    TypeKind.DATE: jnp.int32,
    TypeKind.DECIMAL: jnp.int64,
    # Strings travel as dictionary codes on device.
    TypeKind.VARCHAR: jnp.int32,
    TypeKind.VARBINARY: jnp.int32,
    TypeKind.UNKNOWN: jnp.bool_,
}

_NUMERIC_KINDS = {
    TypeKind.TINYINT,
    TypeKind.SMALLINT,
    TypeKind.INTEGER,
    TypeKind.BIGINT,
    TypeKind.REAL,
    TypeKind.DOUBLE,
    TypeKind.DECIMAL,
}

_INTEGER_KINDS = {
    TypeKind.TINYINT,
    TypeKind.SMALLINT,
    TypeKind.INTEGER,
    TypeKind.BIGINT,
}


@dataclasses.dataclass(frozen=True)
class DataType:
    """An immutable logical type node.

    Unlike the reference's shared-pointer Type tree, these are hashable frozen
    dataclasses so they can be static (non-traced) metadata under ``jax.jit``.
    """

    kind: TypeKind
    # DECIMAL parameters.
    precision: Optional[int] = None
    scale: Optional[int] = None
    # ARRAY element / MAP key+value / ROW children.
    children: Tuple["DataType", ...] = ()
    # ROW field names.
    names: Tuple[str, ...] = ()

    # ---- classification ------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self.kind in _NUMERIC_KINDS

    @property
    def is_integer(self) -> bool:
        return self.kind in _INTEGER_KINDS

    @property
    def is_floating(self) -> bool:
        return self.kind in (TypeKind.REAL, TypeKind.DOUBLE)

    @property
    def is_string(self) -> bool:
        return self.kind in (TypeKind.VARCHAR, TypeKind.VARBINARY)

    @property
    def is_complex(self) -> bool:
        return self.kind in (TypeKind.ARRAY, TypeKind.MAP, TypeKind.ROW)

    @property
    def is_long_decimal(self) -> bool:
        """DECIMAL backed by 128-bit storage (reference: Type.h:665 HUGEINT
        backing DecimalType<p> for p > 18).  Device representation: TWO int64
        limb columns (lo unsigned, hi signed), lowered by exec/hugeint.py."""
        return (
            self.kind == TypeKind.DECIMAL
            and self.precision is not None
            and self.precision > 18
        )

    @property
    def is_orderable(self) -> bool:
        return not self.is_complex and self.kind != TypeKind.UNKNOWN

    # ---- device mapping -------------------------------------------------
    @property
    def device_dtype(self):
        """The jnp dtype of this type's device column."""
        if self.kind in _FIXED_DEVICE_DTYPES:
            return _FIXED_DEVICE_DTYPES[self.kind]
        raise TypeError(f"{self.kind} has no single device dtype")

    # ---- structure ------------------------------------------------------
    @property
    def element(self) -> "DataType":
        assert self.kind == TypeKind.ARRAY
        return self.children[0]

    @property
    def key_type(self) -> "DataType":
        assert self.kind == TypeKind.MAP
        return self.children[0]

    @property
    def value_type(self) -> "DataType":
        assert self.kind == TypeKind.MAP
        return self.children[1]

    def child(self, name: str) -> "DataType":
        assert self.kind == TypeKind.ROW
        return self.children[self.names.index(name)]

    def equivalent(self, other: "DataType") -> bool:
        """Type equality ignoring ROW field names (reference Type::equivalent)."""
        if self.kind != other.kind:
            return False
        if self.kind == TypeKind.DECIMAL and (
            self.precision != other.precision or self.scale != other.scale
        ):
            return False
        if len(self.children) != len(other.children):
            return False
        return all(a.equivalent(b) for a, b in zip(self.children, other.children))

    # ---- serde ----------------------------------------------------------
    def to_json(self) -> Any:
        out: dict = {"kind": self.kind.value}
        if self.kind == TypeKind.DECIMAL:
            out["precision"] = self.precision
            out["scale"] = self.scale
        if self.children:
            out["children"] = [c.to_json() for c in self.children]
        if self.names:
            out["names"] = list(self.names)
        return out

    @staticmethod
    def from_json(obj: Any) -> "DataType":
        kind = TypeKind(obj["kind"])
        return DataType(
            kind=kind,
            precision=obj.get("precision"),
            scale=obj.get("scale"),
            children=tuple(DataType.from_json(c) for c in obj.get("children", ())),
            names=tuple(obj.get("names", ())),
        )

    def __str__(self) -> str:
        if self.kind == TypeKind.DECIMAL:
            return f"DECIMAL({self.precision},{self.scale})"
        if self.kind == TypeKind.ARRAY:
            return f"ARRAY<{self.element}>"
        if self.kind == TypeKind.MAP:
            return f"MAP<{self.key_type},{self.value_type}>"
        if self.kind == TypeKind.ROW:
            inner = ",".join(f"{n}:{c}" for n, c in zip(self.names, self.children))
            return f"ROW<{inner}>"
        return self.kind.value


# ---- singletons / constructors ------------------------------------------

BOOLEAN = DataType(TypeKind.BOOLEAN)
TINYINT = DataType(TypeKind.TINYINT)
SMALLINT = DataType(TypeKind.SMALLINT)
INTEGER = DataType(TypeKind.INTEGER)
BIGINT = DataType(TypeKind.BIGINT)
REAL = DataType(TypeKind.REAL)
DOUBLE = DataType(TypeKind.DOUBLE)
VARCHAR = DataType(TypeKind.VARCHAR)
VARBINARY = DataType(TypeKind.VARBINARY)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)
DATE = DataType(TypeKind.DATE)
UNKNOWN = DataType(TypeKind.UNKNOWN)


def decimal(precision: int, scale: int) -> DataType:
    """DECIMAL(p, s): int64 fixed-point for p <= 18; two int64 limbs
    (hugeint, reference Type.h:665) for 18 < p <= 38 (exec/hugeint.py)."""
    if not (0 < precision <= 38):
        raise ValueError(f"bad decimal precision {precision} (max 38)")
    if not (0 <= scale <= precision):
        raise ValueError(f"bad decimal scale {scale} for precision {precision}")
    return DataType(TypeKind.DECIMAL, precision=precision, scale=scale)


def array(element: DataType) -> DataType:
    return DataType(TypeKind.ARRAY, children=(element,))


def map_(key: DataType, value: DataType) -> DataType:
    return DataType(TypeKind.MAP, children=(key, value))


def row(names, types) -> DataType:
    names = tuple(names)
    types = tuple(types)
    assert len(names) == len(types)
    return DataType(TypeKind.ROW, children=types, names=names)


class RowType:
    """Convenience wrapper for a ROW DataType used as a relation schema."""

    def __init__(self, names, types):
        self.dtype = row(names, types)

    @property
    def names(self) -> Tuple[str, ...]:
        return self.dtype.names

    @property
    def types(self) -> Tuple[DataType, ...]:
        return self.dtype.children

    def __len__(self) -> int:
        return len(self.dtype.names)

    def index_of(self, name: str) -> int:
        return self.dtype.names.index(name)

    def type_of(self, name: str) -> DataType:
        return self.dtype.child(name)

    def __contains__(self, name: str) -> bool:
        return name in self.dtype.names

    def __eq__(self, other) -> bool:
        return isinstance(other, RowType) and self.dtype == other.dtype

    def __hash__(self) -> int:
        return hash(self.dtype)

    def __repr__(self) -> str:
        return str(self.dtype)


# Widening order used by binary-op type resolution (smallest common super type).
_WIDEN_ORDER = [
    TypeKind.TINYINT,
    TypeKind.SMALLINT,
    TypeKind.INTEGER,
    TypeKind.BIGINT,
    TypeKind.REAL,
    TypeKind.DOUBLE,
]


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Smallest common numeric super-type, Presto-style."""
    if a == b:
        return a
    if a.kind == TypeKind.DECIMAL or b.kind == TypeKind.DECIMAL:
        if a.kind == b.kind == TypeKind.DECIMAL:
            scale = max(a.scale, b.scale)
            ip = max(a.precision - a.scale, b.precision - b.scale)
            # long-decimal operands keep 128-bit width (exec/hugeint.py)
            cap = 38 if (a.is_long_decimal or b.is_long_decimal) else 18
            return decimal(min(cap, ip + scale), scale)
        other = b if a.kind == TypeKind.DECIMAL else a
        if other.is_integer:
            return a if a.kind == TypeKind.DECIMAL else b
        return DOUBLE
    if not a.is_numeric or not b.is_numeric:
        raise TypeError(f"no common numeric type for {a} and {b}")
    return DataType(_WIDEN_ORDER[max(_WIDEN_ORDER.index(a.kind), _WIDEN_ORDER.index(b.kind))])
