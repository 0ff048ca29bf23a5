"""Host-side CSV ingest -> device Table.

Plays the role of the reference's CsvDataSource + arrow::csv::Reader
(reference: src/execution/datasource.rs:33-58). Ingest happens once on
the host; the whole file becomes one device-resident Table. This is the
JAX package's pure-Python reader (datafusion_tpu/columnar/csv.py); its
native C++ parser and the lazy, column-on-demand table are not part of
the port yet.

Parity note: the reference constructs its CSV reader with
has_header=true unconditionally (datasource.rs:41), which swallows the
first data row of headerless files like uk_cities.csv — its test goldens
depend on this. `CsvDataSource` mirrors that default; `read_csv` lets
callers choose.
"""

from __future__ import annotations

import csv as _csv
from dataclasses import dataclass

import numpy as np

from datafusion_tpu_torch.columnar.table import Table
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.schema import Schema
from datafusion_tpu_torch.types import DataType


def _parse_column(values: list[str], dtype: DataType):
    """Parse one column of raw CSV strings; returns (array, validity|None)."""
    if dtype is DataType.Utf8:
        return values, None
    if dtype is DataType.Date32:
        from datafusion_tpu_torch.utils.dates import parse_iso_date

        n = len(values)
        arr = np.zeros((n,), dtype=np.int32)
        validity = np.ones((n,), dtype=np.bool_)
        for i, v in enumerate(values):
            if v == "":
                validity[i] = False
            else:
                arr[i] = parse_iso_date(v)
        return arr, (None if validity.all() else validity)
    if dtype is DataType.Timestamp:
        from datafusion_tpu_torch.utils.dates import parse_iso_timestamp

        n = len(values)
        arr = np.zeros((n,), dtype=np.int64)
        validity = np.ones((n,), dtype=np.bool_)
        for i, v in enumerate(values):
            if v == "":
                validity[i] = False
            else:
                arr[i] = parse_iso_timestamp(v)
        return arr, (None if validity.all() else validity)
    n = len(values)
    np_dtype = dtype.to_np()
    missing = [i for i, v in enumerate(values) if v == ""]
    if not missing:
        if dtype is DataType.Boolean:
            arr = np.array([v.strip().lower() in ("true", "1", "t") for v in values])
        else:
            arr = np.array(values, dtype=np_dtype)
        return arr, None
    arr = np.zeros((n,), dtype=np_dtype)
    validity = np.ones((n,), dtype=np.bool_)
    for i, v in enumerate(values):
        if v == "":
            validity[i] = False
        elif dtype is DataType.Boolean:
            arr[i] = v.strip().lower() in ("true", "1", "t")
        else:
            arr[i] = np_dtype.type(v)
    return arr, validity


def read_csv(
    path: str,
    schema: Schema,
    *,
    has_header: bool = True,
    device=None,
) -> Table:
    """Read a CSV file into a Table on `device` (default: the card)
    using the provided schema."""
    with open(path, newline="") as f:
        rows = list(_csv.reader(f))
    if has_header and rows:
        rows = rows[1:]
    ncols = len(schema)
    raw_cols: list[list[str]] = [[] for _ in range(ncols)]
    for r in rows:
        if len(r) < ncols:
            raise ExecutionError(f"CSV row has {len(r)} fields, schema has {ncols}")
        for j in range(ncols):
            raw_cols[j].append(r[j])
    arrays = []
    validity = []
    for j, field in enumerate(schema.fields):
        arr, valid = _parse_column(raw_cols[j], field.dtype)
        arrays.append(arr)
        validity.append(valid)
    if all(v is None for v in validity):
        validity = None
    return Table.from_arrays(schema, arrays, validity=validity, device=device)


@dataclass
class CsvDataSource:
    """Named CSV data source registered with an ExecutionContext
    (reference: CsvDataSource::new(filename, schema, batch_size),
    datasource.rs:39 — batch_size is obsolete here; the whole file is one
    device table; has_header defaults to True like the reference). The
    file is read when a context registers it, onto that context's
    device."""

    filename: str
    schema: Schema
    has_header: bool = True

    def table(self, device=None) -> Table:
        return read_csv(self.filename, self.schema, has_header=self.has_header, device=device)
