"""Host-side CSV ingest -> device Table.

Plays the role of the reference's CsvDataSource + arrow::csv::Reader
(reference: src/execution/datasource.rs:33-58). Ingest happens once on
the host; the whole file becomes one device-resident Table. As in the
JAX package (datafusion_tpu/columnar/csv.py), the multithreaded native
C++ parser (io/native.py) reads the file where it can be built, and the
pure-Python reader where it cannot. `LazyCsvTable` parses a column only
when a query scans it.

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
import torch

from datafusion_tpu_torch.columnar.table import Column, Table, resolve_device
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.io.native import count_csv_rows_native, parse_csv_native
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
    native: bool = True,
) -> Table:
    """Read a CSV file into a Table on `device` (default: the card)
    using the provided schema. `native`: parse with the multithreaded C++
    parser (io/native.py) when it can be built here; False, or no C++
    toolchain, parses in Python."""
    arrays, validity, _ = read_csv_columns(path, schema, has_header, range(len(schema)), native=native)
    if all(v is None for v in validity):
        validity = None
    return Table.from_arrays(schema, arrays, validity=validity, device=device)


def read_csv_columns(path: str, schema: Schema, has_header: bool, columns, *, native: bool = True):
    """Host parse of only the given column indices, in one pass over the
    file: `(arrays, validity, nrows)` with None entries for the columns
    not asked for. The lazy scan's primitive: the native parser skips the
    other columns in C++, the Python one never converts them."""
    columns = sorted(set(columns))
    if native:
        parsed = parse_csv_native(path, schema, has_header, columns=columns)
        if parsed is not None:
            arrays, validity = parsed
            if validity is None:
                validity = [None] * len(schema)
            n = next((len(a[0]) if isinstance(a, tuple) else len(a) for a in arrays if a is not None), 0)
            return arrays, validity, n
    with open(path, newline="") as f:
        rows = list(_csv.reader(f))
    if has_header and rows:
        rows = rows[1:]
    ncols = len(schema)
    raw_cols: dict[int, list[str]] = {j: [] for j in columns}
    for r in rows:
        if len(r) < ncols:
            raise ExecutionError(f"CSV row has {len(r)} fields, schema has {ncols}")
        for j in columns:
            raw_cols[j].append(r[j])
    arrays: list = [None] * ncols
    validity: list = [None] * ncols
    for j in columns:
        arrays[j], validity[j] = _parse_column(raw_cols[j], schema.fields[j].dtype)
    return arrays, validity, len(rows)


def count_csv_rows(path: str, has_header: bool) -> int:
    """The file's data-row count, without parsing any field (the native
    index pass where the library builds)."""
    n = count_csv_rows_native(path, has_header)
    if n is not None:
        return n
    with open(path, newline="") as f:
        n = sum(1 for _ in _csv.reader(f))
    return max(0, n - 1) if has_header else n


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


class _LazyColumn:
    """A column of a LazyCsvTable: it has Column's attributes, and reading
    its data, validity, dictionary or values parses it (its owner's
    `_col`)."""

    __slots__ = ("_owner", "_idx", "dtype")

    def __init__(self, owner: "LazyCsvTable", idx: int, dtype: DataType):
        self._owner = owner
        self._idx = idx
        self.dtype = dtype

    @property
    def data(self):
        return self._owner._col(self._idx).data

    @property
    def validity(self):
        return self._owner._col(self._idx).validity

    @property
    def dictionary(self):
        return self._owner._col(self._idx).dictionary

    @property
    def capacity(self) -> int:
        return self._owner.num_rows

    def to_numpy(self, num_rows: int):
        return self._owner._col(self._idx).to_numpy(num_rows)


class LazyCsvTable(Table):
    """A CSV-backed Table whose columns parse on demand: registration runs
    only the row-count pass, and the compiler's projection push-down calls
    `ensure_columns` with exactly the columns a query scans, so a column
    that no query reads is never parsed. It carries its device and parses
    straight onto it: `device` and `to` touch no column."""

    def __init__(self, path: str, schema: Schema, has_header: bool = True, *, device=None):
        n = count_csv_rows(path, has_header)
        for name, value in (("schema", schema), ("num_rows", n), ("_path", path), ("_has_header", has_header),
                            ("_device", resolve_device(device)), ("_real", {})):
            object.__setattr__(self, name, value)
        object.__setattr__(self, "columns", tuple(_LazyColumn(self, i, f.dtype) for i, f in enumerate(schema.fields)))

    @property
    def device(self) -> torch.device:
        return self._device

    def to(self, device) -> "LazyCsvTable":
        """The same file, unparsed, on another device."""
        dev = resolve_device(device)
        return self if dev == self._device else LazyCsvTable(self._path, self.schema, self._has_header, device=dev)

    def ensure_columns(self, indices) -> None:
        """Parse the given (table) column indices in one pass over the file."""
        todo = sorted(i for i in set(indices) if i not in self._real)
        if not todo:
            return
        arrays, validity, n = read_csv_columns(self._path, self.schema, self._has_header, todo)
        if n != self.num_rows:
            raise ExecutionError(f"CSV changed between registration and parse: {n} rows vs {self.num_rows}")
        sub = Table.from_arrays(self.schema.project(todo), [arrays[i] for i in todo],
                                validity=[validity[i] for i in todo], device=self._device)
        for j, i in enumerate(todo):
            self._real[i] = sub.columns[j]

    def materialized_columns(self) -> list[int]:
        return sorted(self._real)

    def _col(self, i: int) -> Column:
        if i not in self._real:
            self.ensure_columns([i])
        return self._real[i]
