"""Parquet ingest -> device Table.

Port of datafusion_tpu/columnar/parquet.py, with the same schema
inference and the same order-preserving dictionaries.

The reference declared the parquet crate, parsed `STORED AS PARQUET`,
shipped .parquet fixtures — and never implemented a reader
(reference: Cargo.toml:29, dfparser.rs:34, SURVEY.md §2). Implemented
here on pyarrow: columnar extraction end to end (string columns
dictionary-encode in Arrow C++ and only the small vocab crosses into
Python — VERDICT r3 next #8 replaced the per-row `s.iloc[i]` loop), and
schema inference reads Arrow types directly instead of matching
pandas-version-dependent dtype strings. Columns are coerced to the
declared schema (or inferred when none is given), with nulls tracked in
validity. A pandas fallback keeps the reader alive without pyarrow.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from datafusion_tpu_torch.columnar.table import Table
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.schema import Field, Schema
from datafusion_tpu_torch.types import DataType, from_np


def _decode(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    return str(v)


def read_parquet(path: str, schema: Optional[Schema] = None, *, device=None) -> Table:
    """Read a Parquet file onto `device` (default: the card), with pyarrow,
    else pandas; an ExecutionError when neither imports."""
    try:
        import pyarrow as pa
        import pyarrow.compute as pc
        import pyarrow.parquet as pq
    except ImportError:
        return _read_parquet_pandas(path, schema, device=device)

    t = pq.read_table(path)
    names = set(t.schema.names)

    def _is_stringy(ty) -> bool:
        return (
            pa.types.is_string(ty)
            or pa.types.is_large_string(ty)
            or pa.types.is_binary(ty)
            or pa.types.is_large_binary(ty)
        )

    if schema is None:
        fields = []
        for f in t.schema:
            ty = f.type
            if _is_stringy(ty):
                dt = DataType.Utf8
            elif pa.types.is_timestamp(ty):
                dt = DataType.Int64  # epoch ns (pandas-era inference parity)
            elif pa.types.is_date32(ty):
                dt = DataType.Date32
            elif pa.types.is_boolean(ty):
                dt = DataType.Boolean
            else:
                dt = from_np(np.dtype(ty.to_pandas_dtype()))
            fields.append(Field(str(f.name), dt))
        schema = Schema(fields)

    arrays = []
    validity: list = []
    any_null = False
    for field in schema.fields:
        if field.name not in names:
            raise ExecutionError(f"parquet file has no column '{field.name}'")
        col = t.column(field.name).combine_chunks()
        valid = None
        if col.null_count:
            any_null = True
            valid = ~pc.is_null(col).to_numpy(zero_copy_only=False)
        if field.dtype is DataType.Utf8:
            try:
                scol = (
                    col
                    if pa.types.is_string(col.type)
                    or pa.types.is_large_string(col.type)
                    else col.cast(pa.string())
                )
            except pa.ArrowInvalid:
                # invalid UTF-8 bytes: per-value lossy decode (rare path)
                scol = pa.array(
                    [None if v is None else _decode(v) for v in col.to_pylist()],
                    type=pa.string(),
                )
            d = pc.dictionary_encode(pc.fill_null(scol, ""))
            codes = d.indices.to_numpy(zero_copy_only=False).astype(np.int32)
            vocab = np.asarray(d.dictionary.to_pylist(), dtype=object).astype(str)
            # the engine's dictionaries are ORDER-PRESERVING (code order ==
            # string sort order: MIN/MAX/compares run on codes) — re-sort
            # the first-occurrence-ordered Arrow vocab and remap
            uvocab, inv = np.unique(vocab, return_inverse=True)
            arrays.append((inv.astype(np.int32)[codes], tuple(uvocab.tolist())))
        elif field.dtype is DataType.Boolean:
            arrays.append(
                pc.fill_null(col, False).to_numpy(zero_copy_only=False).astype(np.bool_)
            )
        elif pa.types.is_timestamp(col.type):
            arrays.append(
                pc.fill_null(col.cast(pa.int64()), 0).to_numpy(
                    zero_copy_only=False
                )
            )
        elif pa.types.is_date32(col.type):
            arrays.append(
                pc.fill_null(col.cast(pa.int32()), 0)
                .to_numpy(zero_copy_only=False)
                .astype(np.int32)
            )
        else:
            arrays.append(
                pc.fill_null(col, 0)
                .to_numpy(zero_copy_only=False)
                .astype(field.dtype.to_np(), copy=False)
            )
        validity.append(valid)
    return Table.from_arrays(
        schema, arrays, validity=validity if any_null else None, device=device
    )


def _read_parquet_pandas(
    path: str, schema: Optional[Schema] = None, *, device=None
) -> Table:
    """pandas fallback (pre-r4 reader) for environments without pyarrow."""
    try:
        import pandas as pd
    except ImportError as e:  # pragma: no cover
        raise ExecutionError("parquet support requires pyarrow or pandas") from e
    df = pd.read_parquet(path)

    if schema is None:
        fields = []
        for name in df.columns:
            s = df[name]
            # pandas may surface parquet strings as object, "string", or
            # the "str" extension dtype depending on version/backend
            if s.dtype == object or str(s.dtype) in ("string", "str") or str(
                s.dtype
            ).startswith("string"):
                fields.append(Field(str(name), DataType.Utf8))
            elif str(s.dtype).startswith("datetime"):
                fields.append(Field(str(name), DataType.Int64))  # epoch ns
            elif s.dtype == np.bool_:
                fields.append(Field(str(name), DataType.Boolean))
            else:
                fields.append(Field(str(name), from_np(s.dtype)))
        schema = Schema(fields)

    arrays = []
    validity: list = []
    any_null = False
    for field in schema.fields:
        if field.name not in df.columns:
            raise ExecutionError(f"parquet file has no column '{field.name}'")
        s = df[field.name]
        isna = s.isna().to_numpy()
        valid = None if not isna.any() else ~isna
        if valid is not None:
            any_null = True
        if field.dtype is DataType.Utf8:
            vals = s.to_numpy(dtype=object)
            out = np.where(isna, "", vals)
            if any(isinstance(v, bytes) for v in out[:64]):
                out = np.frompyfunc(_decode, 1, 1)(out)
                out = np.where(isna, "", out)
            arrays.append(out.tolist())
        elif field.dtype is DataType.Boolean:
            arrays.append(s.fillna(False).to_numpy(dtype=np.bool_))
        elif str(s.dtype).startswith("datetime"):
            arrays.append(s.astype("int64").to_numpy())
        else:
            arrays.append(
                s.fillna(0).to_numpy().astype(field.dtype.to_np(), copy=False)
            )
        validity.append(valid)
    return Table.from_arrays(
        schema, arrays, validity=validity if any_null else None, device=device
    )
