"""Result materialization and reference-compatible rendering.

`result_str` reproduces the reference's tab-delimited golden format
byte-for-byte (reference: tests/sql.rs:107-137): Debug-formatted floats,
double-quoted Utf8, one row per line.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from datafusion_tpu_torch.schema import Schema
from datafusion_tpu_torch.types import DataType
from datafusion_tpu_torch.utils.fmt import format_cell


@dataclass
class ResultTable:
    """Host-side query result: numpy columns in output order."""

    schema: Schema
    cols: list[tuple[np.ndarray, Optional[np.ndarray]]]
    dicts: list[Optional[tuple[str, ...]]]
    raw_text: Optional[str] = None  # EXPLAIN and other plain-text results
    routes: tuple[str, ...] = ()  # the run-time route of each join (exec/compiler.py CompiledQuery.run)

    @property
    def num_rows(self) -> int:
        return len(self.cols[0][0]) if self.cols else 0

    @property
    def num_columns(self) -> int:
        return len(self.cols)

    def column_values(self, j: int):
        """Decoded python-friendly values for column j (None for NULL)."""
        data, valid = self.cols[j]
        dt = self.schema.field(j).dtype
        if dt is DataType.Utf8 and self.dicts[j] is not None:
            vocab = np.asarray(self.dicts[j], dtype=object)
            vals = vocab[np.clip(data, 0, max(len(vocab) - 1, 0))]
        elif dt is DataType.Date32:
            from datafusion_tpu_torch.utils.dates import date_of_days

            vals = [date_of_days(int(v)) for v in data]
        elif dt is DataType.Timestamp:
            from datafusion_tpu_torch.utils.dates import datetime_of_seconds

            vals = [datetime_of_seconds(int(v)) for v in data]
        else:
            # numeric / Struct / host-produced raw Utf8 (object array)
            vals = data
        out = list(vals)
        if valid is not None:
            out = [v if ok else None for v, ok in zip(out, valid)]
        return out

    def to_pylist(self) -> list[dict]:
        names = self.schema.names()
        colvals = [self.column_values(j) for j in range(self.num_columns)]
        return [
            {names[j]: colvals[j][i] for j in range(self.num_columns)}
            for i in range(self.num_rows)
        ]

    def result_str(self) -> str:
        """Tab-delimited rendering identical to the reference's result_str
        (tests/sql.rs:107-137)."""
        if self.raw_text is not None:
            return self.raw_text
        colvals = [self.column_values(j) for j in range(self.num_columns)]
        dtypes = [f.dtype for f in self.schema.fields]
        lines = []
        for i in range(self.num_rows):
            cells = []
            for j in range(self.num_columns):
                v = colvals[j][i]
                cells.append("NULL" if v is None else format_cell(dtypes[j], v))
            lines.append("\t".join(cells))
        return "".join(line + "\n" for line in lines)

    def display_str(self) -> str:
        """Tab-delimited rendering with Rust `{}` Display semantics
        (strings unquoted) — the reference POC console's output format
        (reference: test/data/smoketest-expected.txt)."""
        from datafusion_tpu_torch.utils.fmt import display_cell

        if self.raw_text is not None:
            return self.raw_text
        colvals = [self.column_values(j) for j in range(self.num_columns)]
        dtypes = [f.dtype for f in self.schema.fields]
        lines = []
        for i in range(self.num_rows):
            cells = [
                "NULL" if colvals[j][i] is None else display_cell(dtypes[j], colvals[j][i])
                for j in range(self.num_columns)
            ]
            lines.append("\t".join(cells))
        return "".join(line + "\n" for line in lines)

    def to_table(self, device=None):
        """Re-materialize this host result as a table on `device` (the
        card unless the caller names another; CREATE TABLE ... AS SELECT,
        beyond the reference)."""
        from datafusion_tpu_torch.columnar.table import Table
        from datafusion_tpu_torch.types import DataType as _DT

        arrays = []
        validity = []
        for j, f in enumerate(self.schema.fields):
            data, valid = self.cols[j]
            if f.dtype is _DT.Utf8:
                if self.dicts[j] is not None:
                    arrays.append((np.asarray(data, np.int32), tuple(self.dicts[j])))
                else:
                    arrays.append([str(x) for x in data])
            else:
                arrays.append(np.asarray(data))
            validity.append(None if valid is None else np.asarray(valid, bool))
        return Table.from_arrays(self.schema, arrays, validity=validity, device=device)

    def to_csv(self, path: str, *, header: bool = True) -> None:
        """Write the result as CSV — realizes the reference's never-executed
        PhysicalPlan::Write{filename} (physicalplan.rs:25-29)."""
        import csv as _csv

        colvals = [self.column_values(j) for j in range(self.num_columns)]
        with open(path, "w", newline="") as f:
            w = _csv.writer(f)
            if header:
                w.writerow(self.schema.names())
            for i in range(self.num_rows):
                w.writerow(
                    ["" if colvals[j][i] is None else colvals[j][i] for j in range(self.num_columns)]
                )

    def __repr__(self) -> str:
        return f"ResultTable({self.num_rows} rows × {self.num_columns} cols)\n" + self.result_str()
