"""Columnar device tables — the engine's memory model, over torch tensors.

One device tensor per column plus an optional bool validity tensor, with
strings dictionary-encoded on the host into order-preserving int32 codes
(a lexicographically sorted vocabulary), as in the JAX package
(datafusion_tpu/columnar/table.py). Columns are NOT padded: torch runs
eagerly, so a column is exactly `num_rows` long and the CUDA kernels
mask their own ragged edge.

Every table lives on one explicit torch device. Entry points default to
the card: `resolve_device(None)` is "cuda" and raises on a machine with
no CUDA device unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.schema import Field, Schema
from datafusion_tpu_torch.types import DataType, from_np, physical_np


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another. Raises when CUDA is asked for (explicitly or by
    default) and this machine has none — nothing silently moves to the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ExecutionError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def encode_dictionary(values: Sequence[str]) -> tuple[np.ndarray, tuple[str, ...]]:
    """Dictionary-encode strings with an order-preserving (sorted) vocab:
    code comparisons are order-isomorphic to string comparisons, so <, >,
    MIN, MAX, ORDER BY and GROUP BY all run on int32 codes."""
    arr = np.asarray(values, dtype=object)
    vocab, codes = np.unique(arr.astype(str), return_inverse=True)
    return codes.astype(np.int32), tuple(vocab.tolist())


def _split_nulls(vals) -> tuple[object, Optional[np.ndarray]]:
    """Split Python-level NULLs (`None`, NaT) out of one raw column:
    returns `(cleaned_values, validity_or_None)`; the type is inferred
    from the non-NULL values and NULL slots hold an unobservable fill."""
    arr = np.asarray(vals)
    if arr.dtype.kind == "M":
        nat = np.isnat(arr)
        if not nat.any():
            return vals, None
        filled = arr.copy()
        filled[nat] = np.zeros((), arr.dtype)
        return filled, ~nat
    if arr.dtype.kind != "O":
        return vals, None
    flat = list(arr.flat)
    valid = np.array([v is not None for v in flat], dtype=bool)
    if valid.all():
        return vals, None
    non_null = [v for v in flat if v is not None]
    if not non_null:
        # all-NULL, untyped: Float64 by convention (Arrow's null -> double)
        return np.zeros(len(flat), dtype=np.float64), valid
    import datetime as _dtm

    ex = non_null[0]
    if isinstance(ex, str):
        return np.array(["" if v is None else v for v in flat], dtype=object), valid
    if isinstance(ex, _dtm.datetime):
        fill = _dtm.datetime(1970, 1, 1)
        return np.array([fill if v is None else v for v in flat], dtype=object), valid
    if isinstance(ex, _dtm.date):
        fill = _dtm.date(1970, 1, 1)
        return np.array([fill if v is None else v for v in flat], dtype=object), valid
    if isinstance(ex, bool) and all(isinstance(v, bool) for v in non_null):
        return np.array([bool(v) for v in flat], dtype=np.bool_), valid
    base = np.asarray(non_null)
    if base.dtype.kind in ("i", "u", "f", "b"):
        cleaned = np.zeros(len(flat), dtype=base.dtype)
        cleaned[valid] = base
        return cleaned, valid
    return np.array(["" if v is None else str(v) for v in flat], dtype=object), valid


def _physical_host(field_dtype: DataType, arr) -> np.ndarray:
    """Host array in the device buffer's physical dtype (types.py)."""
    if field_dtype is DataType.Date32:
        from datafusion_tpu_torch.utils.dates import to_days_array

        return to_days_array(arr)
    if field_dtype is DataType.Timestamp:
        from datafusion_tpu_torch.utils.dates import to_seconds_array

        return to_seconds_array(arr)
    if field_dtype is DataType.UInt64:
        host = np.asarray(arr, dtype=np.uint64)
        if host.size and int(host.max()) >= 1 << 63:
            raise ExecutionError(
                "UInt64 values >= 2**63 are not supported (carried as int64)"
            )
        return host.astype(np.int64)
    return np.asarray(np.asarray(arr, dtype=field_dtype.to_np()), dtype=physical_np(field_dtype))


@dataclass(frozen=True)
class Column:
    """One column: logical type + device buffer (+ validity, + dict).
    `validity` is None when every row is non-null."""

    dtype: DataType
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None
    dictionary: Optional[tuple[str, ...]] = None

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def to(self, device) -> "Column":
        return Column(
            self.dtype,
            self.data.to(device),
            None if self.validity is None else self.validity.to(device),
            self.dictionary,
        )

    def to_numpy(self, num_rows: int) -> np.ndarray:
        """The first `num_rows` values on the host, dictionaries decoded;
        NULLs become None (an object array then)."""
        from datafusion_tpu_torch.parallel.multihost import to_host

        data, valid = to_host([self.data[:num_rows], None if self.validity is None else self.validity[:num_rows]])
        if self.dtype is DataType.Utf8:
            vocab = np.asarray(self.dictionary, dtype=object)
            out = vocab[np.clip(data, 0, len(vocab) - 1)]
        else:
            out = data
        if valid is not None:
            out = np.asarray(out, dtype=object)
            out[~valid] = None
        return out


@dataclass(frozen=True)
class Table:
    """A device-resident table: schema + columns + row count."""

    schema: Schema
    columns: tuple[Column, ...]
    num_rows: int

    def __post_init__(self):
        caps = {c.capacity for c in self.columns}
        if caps and caps != {self.num_rows}:
            raise ExecutionError(f"column lengths {sorted(caps)} != {self.num_rows} rows")

    @property
    def device(self) -> torch.device:
        return self.columns[0].data.device if self.columns else torch.device("cpu")

    def to(self, device) -> "Table":
        return Table(self.schema, tuple(c.to(device) for c in self.columns), self.num_rows)

    # ------------------------------------------------------------------
    @staticmethod
    def from_arrays(
        schema: Schema,
        arrays: Sequence,
        *,
        validity: Optional[Sequence[Optional[np.ndarray]]] = None,
        device=None,
    ) -> "Table":
        """Build a device table from host arrays (numpy columns; Utf8
        columns may be lists of str or pre-encoded `(int32 codes, sorted
        vocab tuple)` pairs)."""
        dev = resolve_device(device)
        if len(arrays) != len(schema):
            raise ExecutionError(f"{len(arrays)} arrays for schema of {len(schema)} fields")

        def pre_encoded(a) -> bool:
            return isinstance(a, tuple) and len(a) == 2 and isinstance(a[1], tuple)

        n = (len(arrays[0][0]) if pre_encoded(arrays[0]) else len(arrays[0])) if arrays else 0
        cols = []
        for i, field in enumerate(schema.fields):
            arr = arrays[i]
            vocab = None
            if field.dtype is DataType.Utf8:
                if pre_encoded(arr):
                    host, vocab = np.asarray(arr[0], dtype=np.int32), arr[1]
                else:
                    host, vocab = encode_dictionary(arr)
            else:
                host = _physical_host(field.dtype, arr)
            if len(host) != n:
                raise ExecutionError("ragged input arrays")
            data = torch.from_numpy(np.array(host, copy=True)).to(dev)
            vmask = None
            if validity is not None and validity[i] is not None:
                vmask = torch.from_numpy(np.array(validity[i], dtype=np.bool_, copy=True)).to(dev)
            cols.append(Column(field.dtype, data, vmask, vocab))
        return Table(schema, tuple(cols), n)

    @staticmethod
    def from_reference_arrays(
        fields: Sequence[Field],
        datas: Sequence[np.ndarray],
        validities: Sequence[Optional[np.ndarray]],
        dictionaries: Sequence[Optional[tuple[str, ...]]],
        device=None,
        num_rows: Optional[int] = None,
    ) -> "Table":
        """Build a table from another engine's columns given as plain
        numpy arrays — logical-dtype data (e.g. `np.asarray(col.data)`),
        validity (or None) and the sorted dictionary tuple of each Utf8
        column — so two engines can be fed identical data. `num_rows`
        cuts padded buffers to the table's logical length."""
        n = len(datas[0]) if num_rows is None and datas else (num_rows or 0)
        arrays = []
        for f, d, vocab in zip(fields, datas, dictionaries):
            d = np.asarray(d)[:n]
            arrays.append((d.astype(np.int32), tuple(vocab)) if f.dtype is DataType.Utf8 else d)
        validity = [None if v is None else np.asarray(v)[:n] for v in validities]
        return Table.from_arrays(Schema(fields), arrays, validity=validity, device=device)

    @staticmethod
    def from_pydict(data: dict, schema: Optional[Schema] = None, device=None) -> "Table":
        """Convenience constructor from {name: values}; Python `None`
        entries become SQL NULLs (the type comes from the non-None
        values)."""
        arrays: list = []
        validity: list = []
        for vals in data.values():
            cleaned, vmask = _split_nulls(vals)
            arrays.append(cleaned)
            validity.append(vmask)
        if schema is None:
            import datetime as _dtm

            fields = []
            for name, vals in zip(data.keys(), arrays):
                v0 = np.asarray(vals)
                if v0.dtype.kind == "M":
                    coarse = np.datetime_data(v0.dtype)[0] in ("D", "W", "M", "Y")
                    fields.append(Field(name, DataType.Date32 if coarse else DataType.Timestamp))
                elif v0.dtype.kind in ("U", "O", "S"):
                    if len(v0) and isinstance(v0.flat[0], _dtm.datetime):
                        fields.append(Field(name, DataType.Timestamp))
                    elif len(v0) and isinstance(v0.flat[0], _dtm.date):
                        fields.append(Field(name, DataType.Date32))
                    else:
                        fields.append(Field(name, DataType.Utf8))
                else:
                    fields.append(Field(name, from_np(v0.dtype)))
            schema = Schema(fields)
        any_valid = any(v is not None for v in validity)
        return Table.from_arrays(
            schema, arrays, validity=validity if any_valid else None, device=device
        )
