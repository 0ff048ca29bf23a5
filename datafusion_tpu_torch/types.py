"""Type system: logical data types, scalar values, and coercion rules.

The supertype lattice and lossless-coercion predicate reproduce the
reference's semantics exactly (reference: src/logicalplan.rs:446-605) —
they define result parity for binary-expression planning.

Physical (device) dtypes are native: Float64, Int64 and Timestamp stay
64-bit on the GPU, so results match the JAX package's x64 CPU results
with no narrowing. Unsigned types are carried in the narrowest signed
torch dtype that holds every value, because torch's unsigned dtypes
beyond uint8 support few operations:

  * UInt8  -> torch.uint8 (native)
  * UInt16 -> torch.int32, UInt32 -> torch.int64 (widened, exact)
  * UInt64 -> torch.int64 (same bits; values >= 2**63 are refused at
    ingest, see columnar/table.py)

Integer arithmetic wraps to the LOGICAL width after every operation
(ops/expr_eval.py `wrap_to`), so a widened unsigned column overflows
exactly as the numpy/JAX type would. Results convert back to the
logical numpy dtype when they reach the host (`DataType.to_np`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


class DataType(enum.Enum):
    """Logical column types (reference: arrow DataType subset used by
    logicalplan.rs:96-111 plus Boolean/Utf8)."""

    Boolean = "Boolean"
    Int8 = "Int8"
    Int16 = "Int16"
    Int32 = "Int32"
    Int64 = "Int64"
    UInt8 = "UInt8"
    UInt16 = "UInt16"
    UInt32 = "UInt32"
    UInt64 = "UInt64"
    Float32 = "Float32"
    Float64 = "Float64"
    Utf8 = "Utf8"
    # Date32: days since 1970-01-01, int32 on device — comparisons,
    # sorts, groups, joins, MIN/MAX all run on the integer image
    # (utils/dates.py; beyond the reference, whose type set had no dates)
    # untyped NULL literal; unifies with every type (supertype(X, Null)
    # = X), physically an int32 zero with an all-false validity
    Null = "Null"
    Date32 = "Date32"
    # Timestamp: SECONDS since the Unix epoch, int64 on device (int32 on
    # no-x64 TPU → representable range 1901..2038 there, full range on
    # x64 CPU; fractional seconds truncate — documented). All device
    # operators ride the integer image (beyond the reference).
    Timestamp = "Timestamp"
    # Struct values exist only on host (object column of python tuples);
    # the reference declared ScalarValue::Struct but every use was
    # unimplemented! (reference: logicalplan.rs:110,128). Here they are
    # produced/consumed by host-stage functions (ops/functions.py).
    Struct = "Struct"

    def __repr__(self) -> str:  # Rust Debug-format parity: "Int64" etc.
        return self.value

    def __str__(self) -> str:
        return self.value

    @property
    def is_numeric(self) -> bool:
        return self not in (
            DataType.Boolean,
            DataType.Utf8,
            DataType.Struct,
            DataType.Date32,
            DataType.Timestamp,
            DataType.Null,
        )

    @property
    def is_integer(self) -> bool:
        return self in _INTS

    @property
    def is_signed(self) -> bool:
        return self in (DataType.Int8, DataType.Int16, DataType.Int32, DataType.Int64)

    @property
    def is_unsigned(self) -> bool:
        return self in (DataType.UInt8, DataType.UInt16, DataType.UInt32, DataType.UInt64)

    @property
    def is_float(self) -> bool:
        return self in (DataType.Float32, DataType.Float64)

    def to_np(self) -> np.dtype:
        """Physical dtype of the device buffer for this logical type.

        Utf8 columns are dictionary-encoded: the device buffer holds int32
        codes into a host-side, lexicographically-sorted vocabulary
        (SURVEY.md §7 'Strings on TPU').
        """
        return _NP_DTYPES[self]


_INTS = frozenset(
    {
        DataType.Int8,
        DataType.Int16,
        DataType.Int32,
        DataType.Int64,
        DataType.UInt8,
        DataType.UInt16,
        DataType.UInt32,
        DataType.UInt64,
    }
)

_NP_DTYPES = {
    DataType.Boolean: np.dtype(np.bool_),
    DataType.Int8: np.dtype(np.int8),
    DataType.Int16: np.dtype(np.int16),
    DataType.Int32: np.dtype(np.int32),
    DataType.Int64: np.dtype(np.int64),
    DataType.UInt8: np.dtype(np.uint8),
    DataType.UInt16: np.dtype(np.uint16),
    DataType.UInt32: np.dtype(np.uint32),
    DataType.UInt64: np.dtype(np.uint64),
    DataType.Float32: np.dtype(np.float32),
    DataType.Float64: np.dtype(np.float64),
    DataType.Utf8: np.dtype(np.int32),  # dictionary codes
    DataType.Struct: np.dtype(object),  # host-only
    DataType.Null: np.dtype(np.int32),  # placeholder zeros, never valid
    DataType.Date32: np.dtype(np.int32),  # days since epoch
    DataType.Timestamp: np.dtype(np.int64),  # seconds since epoch
}

_FROM_NP = {
    np.dtype(np.bool_): DataType.Boolean,
    np.dtype(np.int8): DataType.Int8,
    np.dtype(np.int16): DataType.Int16,
    np.dtype(np.int32): DataType.Int32,
    np.dtype(np.int64): DataType.Int64,
    np.dtype(np.uint8): DataType.UInt8,
    np.dtype(np.uint16): DataType.UInt16,
    np.dtype(np.uint32): DataType.UInt32,
    np.dtype(np.uint64): DataType.UInt64,
    np.dtype(np.float32): DataType.Float32,
    np.dtype(np.float64): DataType.Float64,
}


def from_np(dtype: np.dtype) -> DataType:
    """Logical type for a numpy dtype (strings never come through here)."""
    return _FROM_NP[np.dtype(dtype)]


_PHYSICAL = {
    DataType.UInt16: np.dtype(np.int32),
    DataType.UInt32: np.dtype(np.int64),
    DataType.UInt64: np.dtype(np.int64),
}


def physical_np(dt: DataType) -> np.dtype:
    """Host numpy dtype of the device buffer for a logical type: the
    logical dtype, except the widened unsigned types (module doc)."""
    return _PHYSICAL.get(dt, dt.to_np())


def torch_dtype(dt: DataType):
    """torch dtype of the device buffer for a logical type."""
    import torch

    np_dt = physical_np(dt)
    if np_dt == np.dtype(object):
        raise ValueError(f"{dt} has no device representation")
    return torch.from_numpy(np.zeros(0, np_dt)).dtype


# ---------------------------------------------------------------------------
# Supertype lattice — byte-for-byte the reference's table
# (reference: src/logicalplan.rs:456-554 `_get_supertype`).
# ---------------------------------------------------------------------------

_D = DataType
_SUPERTYPE: dict[tuple[DataType, DataType], DataType] = {}


def _st(l: DataType, r: DataType, out: DataType) -> None:
    _SUPERTYPE[(l, r)] = out


# mixed-sign pairs
_st(_D.UInt8, _D.Int8, _D.Int8)
_st(_D.UInt8, _D.Int16, _D.Int16)
_st(_D.UInt8, _D.Int32, _D.Int32)
_st(_D.UInt8, _D.Int64, _D.Int64)
_st(_D.UInt16, _D.Int16, _D.Int16)
_st(_D.UInt16, _D.Int32, _D.Int32)
_st(_D.UInt16, _D.Int64, _D.Int64)
_st(_D.UInt32, _D.Int32, _D.Int32)
_st(_D.UInt32, _D.Int64, _D.Int64)
_st(_D.UInt64, _D.Int64, _D.Int64)
_st(_D.Int8, _D.UInt8, _D.Int8)
_st(_D.Int16, _D.UInt8, _D.Int16)
_st(_D.Int16, _D.UInt16, _D.Int16)
_st(_D.Int32, _D.UInt8, _D.Int32)
_st(_D.Int32, _D.UInt16, _D.Int32)
_st(_D.Int32, _D.UInt32, _D.Int32)
_st(_D.Int64, _D.UInt8, _D.Int64)
_st(_D.Int64, _D.UInt16, _D.Int64)
_st(_D.Int64, _D.UInt32, _D.Int64)
_st(_D.Int64, _D.UInt64, _D.Int64)

# unsigned × (unsigned | float)
for _l, _rank in ((_D.UInt8, 0), (_D.UInt16, 1), (_D.UInt32, 2), (_D.UInt64, 3)):
    for _r, _rrank in ((_D.UInt8, 0), (_D.UInt16, 1), (_D.UInt32, 2), (_D.UInt64, 3)):
        _st(_l, _r, _r if _rrank >= _rank else _l)
    _st(_l, _D.Float32, _D.Float32)
    _st(_l, _D.Float64, _D.Float64)

# signed × (signed | float)
for _l, _rank in ((_D.Int8, 0), (_D.Int16, 1), (_D.Int32, 2), (_D.Int64, 3)):
    for _r, _rrank in ((_D.Int8, 0), (_D.Int16, 1), (_D.Int32, 2), (_D.Int64, 3)):
        _st(_l, _r, _r if _rrank >= _rank else _l)
    _st(_l, _D.Float32, _D.Float32)
    _st(_l, _D.Float64, _D.Float64)

# floats, strings, booleans
_st(_D.Float32, _D.Float32, _D.Float32)
_st(_D.Float32, _D.Float64, _D.Float64)
_st(_D.Float64, _D.Float32, _D.Float64)
_st(_D.Float64, _D.Float64, _D.Float64)
_st(_D.Utf8, _D.Utf8, _D.Utf8)
_st(_D.Boolean, _D.Boolean, _D.Boolean)


# Date32 only unifies with itself (beyond the reference's lattice);
# Date32 vs Timestamp compares as Timestamp (midnight of the date)
_st(_D.Date32, _D.Date32, _D.Date32)
_st(_D.Timestamp, _D.Timestamp, _D.Timestamp)
_st(_D.Date32, _D.Timestamp, _D.Timestamp)
_st(_D.Timestamp, _D.Date32, _D.Timestamp)

# NULL unifies with everything (reference ScalarValue::Null exists but
# its lattice has no Null rows — beyond the reference)
for _t in _D:
    _st(_D.Null, _t, _t)
    _st(_t, _D.Null, _t)
_st(_D.Null, _D.Null, _D.Null)


def get_supertype(l: DataType, r: DataType) -> Optional[DataType]:
    """Common supertype for binary expressions, or None
    (reference: logicalplan.rs:446-454 tries (l,r) then (r,l))."""
    st = _SUPERTYPE.get((l, r))
    if st is None:
        st = _SUPERTYPE.get((r, l))
    return st


# Deviation from the reference: its can_coerce_from rejects
# unsigned→wider-signed (logicalplan.rs:563-575) even though its own
# get_supertype proposes those pairs (e.g. (UInt8, Int64)→Int64,
# logicalplan.rs:462) — making `WHERE c_uint8 > 5` unplannable. We allow
# the strictly lossless unsigned→wider-signed coercions.
_COERCE_FROM: dict[DataType, frozenset[DataType]] = {
    _D.Int8: frozenset({_D.Int8}),
    _D.Int16: frozenset({_D.Int8, _D.Int16, _D.UInt8}),
    _D.Int32: frozenset({_D.Int8, _D.Int16, _D.Int32, _D.UInt8, _D.UInt16}),
    # UInt64→Int64 is lossy above 2^63, but COUNT returns UInt64
    # (reference: sqlplanner.rs:336) and comparing counts with integer
    # literals (HAVING n > 1) must be plannable — pragmatic inclusion
    _D.Int64: frozenset(
        {
            _D.Int8,
            _D.Int16,
            _D.Int32,
            _D.Int64,
            _D.UInt8,
            _D.UInt16,
            _D.UInt32,
            _D.UInt64,
        }
    ),
    _D.UInt8: frozenset({_D.UInt8}),
    _D.UInt16: frozenset({_D.UInt8, _D.UInt16}),
    _D.UInt32: frozenset({_D.UInt8, _D.UInt16, _D.UInt32}),
    _D.UInt64: frozenset({_D.UInt8, _D.UInt16, _D.UInt32, _D.UInt64}),
    _D.Float32: frozenset(
        {_D.Int8, _D.Int16, _D.Int32, _D.Int64, _D.UInt8, _D.UInt16, _D.UInt32, _D.UInt64, _D.Float32}
    ),
    _D.Float64: frozenset(
        {
            _D.Int8,
            _D.Int16,
            _D.Int32,
            _D.Int64,
            _D.UInt8,
            _D.UInt16,
            _D.UInt32,
            _D.UInt64,
            _D.Float32,
            _D.Float64,
        }
    ),
}


_COERCE_FROM[_D.Date32] = frozenset({_D.Date32})
_COERCE_FROM[_D.Timestamp] = frozenset({_D.Timestamp, _D.Date32})
_COERCE_FROM[_D.Boolean] = frozenset({_D.Boolean})
_COERCE_FROM[_D.Utf8] = frozenset({_D.Utf8})
# NULL casts losslessly to anything
for _t in list(_COERCE_FROM):
    _COERCE_FROM[_t] = _COERCE_FROM[_t] | {_D.Null}
_COERCE_FROM[_D.Null] = frozenset({_D.Null})


def can_coerce_from(target: DataType, source: DataType) -> bool:
    """Whether `source` losslessly coerces to `target`
    (reference: logicalplan.rs:556-605)."""
    return source in _COERCE_FROM.get(target, frozenset())


# ---------------------------------------------------------------------------
# Scalar values
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScalarValue:
    """A typed literal (reference: logicalplan.rs:96-111).

    Debug-format parity with Rust's derived Debug: `Int64(9)`, `Utf8("CO")`,
    `Float64(1.5)` — the plan pretty-printer goldens depend on this.
    """

    dtype: DataType
    value: Any

    def __repr__(self) -> str:
        from datafusion_tpu_torch.utils.fmt import rust_debug_scalar

        return rust_debug_scalar(self)

    # constructors mirroring the reference's variants
    @staticmethod
    def int64(v: int) -> "ScalarValue":
        return ScalarValue(DataType.Int64, int(v))

    @staticmethod
    def float64(v: float) -> "ScalarValue":
        return ScalarValue(DataType.Float64, float(v))

    @staticmethod
    def utf8(v: str) -> "ScalarValue":
        return ScalarValue(DataType.Utf8, v)

    @staticmethod
    def boolean(v: bool) -> "ScalarValue":
        return ScalarValue(DataType.Boolean, bool(v))

    @staticmethod
    def date32(days: int) -> "ScalarValue":
        return ScalarValue(DataType.Date32, int(days))

    @staticmethod
    def timestamp(seconds: int) -> "ScalarValue":
        return ScalarValue(DataType.Timestamp, int(seconds))

    @staticmethod
    def null() -> "ScalarValue":
        return ScalarValue(DataType.Null, None)
