"""Spark-SQL-compatible type algebra with torch device mappings.

Port of blaze_tpu/columnar/types.py: the same logical types, recorded as
the torch dtype each lands in on the device:

  logical type          device representation
  --------------------  -----------------------------------------
  boolean               torch.bool (cap,)
  int8/16/32/64         torch.intN (cap,)
  float32/64            torch.floatN (cap,)
  date32                torch.int32 (cap,)   days since epoch
  timestamp[us]         torch.int64 (cap,)   micros since epoch
  decimal(p<=18, s)     torch.int64 (cap,)   unscaled value
  null                  torch.int8 zeros (all-invalid validity)

  string/binary         columnar/batch.StringData: uint8 (cap, W) + int32
                        lengths, or DictData: int32 codes into a small
                        dictionary of that form
  list<T>               columnar/batch.ListData: int32 offsets (cap + 1,)
                        into a flat element column of its own capacity
  map<K, V>             list<struct<key, value>> (`storage_element`)
  struct<...>           columnar/batch.StructData: one row-aligned child
                        column per field
  decimal(p>18, s)      columnar/batch.StructData of two int64 planes,
                        hi (signed) and lo (unsigned): hi * 2^64 + u64(lo)
                        (`wide_decimal_storage`, columnar/int128.py)

Nested columns and wide decimals have no dense dtype: `torch_dtype()`
raises for them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np
import torch


class TypeKind(enum.Enum):
    NULL = 0
    BOOLEAN = 1
    INT8 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT32 = 6
    FLOAT64 = 7
    STRING = 8
    BINARY = 9
    DATE = 10        # days since epoch, int32
    TIMESTAMP = 11   # microseconds since epoch, int64
    DECIMAL = 12     # unscaled int64 (p<=18)
    LIST = 13
    MAP = 14
    STRUCT = 15


_TORCH_DTYPES = {
    TypeKind.NULL: torch.int8,
    TypeKind.BOOLEAN: torch.bool,
    TypeKind.INT8: torch.int8,
    TypeKind.INT16: torch.int16,
    TypeKind.INT32: torch.int32,
    TypeKind.INT64: torch.int64,
    TypeKind.FLOAT32: torch.float32,
    TypeKind.FLOAT64: torch.float64,
    TypeKind.DATE: torch.int32,
    TypeKind.TIMESTAMP: torch.int64,
    TypeKind.DECIMAL: torch.int64,
}

_NP_DTYPES = {
    torch.bool: np.dtype(bool), torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64), torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}


@dataclasses.dataclass(frozen=True)
class DataType:
    kind: TypeKind
    precision: int = 0          # decimal only
    scale: int = 0              # decimal only
    element: Optional["DataType"] = None  # list element / map value
    key: Optional["DataType"] = None      # map key
    fields: Tuple["Field", ...] = ()      # struct fields

    # ---- classification ----
    @property
    def is_string_like(self) -> bool:
        return self.kind in (TypeKind.STRING, TypeKind.BINARY)

    @property
    def is_numeric(self) -> bool:
        return self.kind in (
            TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
            TypeKind.FLOAT32, TypeKind.FLOAT64, TypeKind.DECIMAL,
        )

    @property
    def is_integral(self) -> bool:
        return self.kind in (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
                             TypeKind.INT64)

    @property
    def is_floating(self) -> bool:
        return self.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64)

    @property
    def is_nested(self) -> bool:
        return self.kind in (TypeKind.LIST, TypeKind.MAP, TypeKind.STRUCT)

    @property
    def is_decimal(self) -> bool:
        return self.kind == TypeKind.DECIMAL

    @property
    def wide_decimal(self) -> bool:
        return self.kind == TypeKind.DECIMAL and self.precision > 18

    # ---- device mapping ----
    def torch_dtype(self) -> torch.dtype:
        if self.kind not in _TORCH_DTYPES or self.wide_decimal:
            raise NotImplementedError(
                f"type {self} has no dense device dtype (its storage is "
                "nested or two limb planes)")
        return _TORCH_DTYPES[self.kind]

    def np_dtype(self) -> np.dtype:
        return _NP_DTYPES[self.torch_dtype()]

    def byte_width(self) -> int:
        return self.np_dtype().itemsize

    def __repr__(self) -> str:
        if self.kind == TypeKind.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        return self.kind.name.lower()


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def field(self, name: str) -> Field:
        return self.fields[self.index_of(name)]

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)


NULL = DataType(TypeKind.NULL)
BOOLEAN = DataType(TypeKind.BOOLEAN)
INT8 = DataType(TypeKind.INT8)
INT16 = DataType(TypeKind.INT16)
INT32 = DataType(TypeKind.INT32)
INT64 = DataType(TypeKind.INT64)
FLOAT32 = DataType(TypeKind.FLOAT32)
FLOAT64 = DataType(TypeKind.FLOAT64)
STRING = DataType(TypeKind.STRING)
BINARY = DataType(TypeKind.BINARY)
DATE = DataType(TypeKind.DATE)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)


def decimal(precision: int, scale: int) -> DataType:
    return DataType(TypeKind.DECIMAL, precision=precision, scale=scale)


def list_of(element: DataType) -> DataType:
    return DataType(TypeKind.LIST, element=element)


def map_of(key: DataType, value: DataType) -> DataType:
    return DataType(TypeKind.MAP, key=key, element=value)


def struct_of(fields) -> DataType:
    return DataType(TypeKind.STRUCT, fields=tuple(fields))


def wide_decimal_storage(dtype: DataType) -> DataType:
    """Physical storage of a decimal(p>18) column: struct<hi:int64,
    lo:int64> limb planes, value = hi * 2^64 + u64(lo) (columnar/int128.py,
    the engine's Decimal128; ref: arrow-rs i128 unscaled storage)."""
    assert dtype.wide_decimal
    return struct_of([Field("hi", INT64, nullable=False),
                      Field("lo", INT64, nullable=False)])


def struct_fields(dtype: DataType) -> Tuple[Field, ...]:
    """The fields of a StructData column's children: a struct's own, or a
    wide decimal's two limb planes."""
    return (wide_decimal_storage(dtype).fields if dtype.wide_decimal
            else dtype.fields)


def storage_element(dtype: DataType) -> DataType:
    """Element dtype of the flat storage under a LIST or MAP column.

    A MAP column is stored as list<struct<key, value>> (Arrow's map layout),
    so its storage element is the entry struct, not the value type."""
    if dtype.kind == TypeKind.MAP:
        return struct_of([Field("key", dtype.key, nullable=False),
                          Field("value", dtype.element)])
    return dtype.element
