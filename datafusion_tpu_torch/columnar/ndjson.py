"""NDJSON (newline-delimited JSON) ingest -> device Table.

Port of datafusion_tpu/columnar/ndjson.py.

The reference parsed `STORED AS NDJSON` DDL but never implemented the
source (reference: dfparser.rs:33 FileType::NdJson; test fixture
test/data/example1.ndjson; no reader exists). Implemented here: one JSON
object per line, fields extracted per the declared schema, missing
fields / nulls tracked in validity.
"""

from __future__ import annotations

import json

import numpy as np

from datafusion_tpu_torch.columnar.table import Table
from datafusion_tpu_torch.schema import Schema
from datafusion_tpu_torch.types import DataType


def read_ndjson(path: str, schema: Schema, *, device=None) -> Table:
    """One JSON object per line, read onto `device` (default: the card)."""
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    n = len(records)
    arrays = []
    validity = []
    any_nulls = False
    for field in schema.fields:
        vals = [r.get(field.name) for r in records]
        valid = np.array([v is not None for v in vals], dtype=np.bool_)
        if field.dtype is DataType.Utf8:
            arrays.append([v if v is not None else "" for v in vals])
        elif field.dtype is DataType.Boolean:
            arrays.append(np.array([bool(v) for v in vals]))
        else:
            np_dt = field.dtype.to_np()
            arr = np.zeros((n,), dtype=np_dt)
            for i, v in enumerate(vals):
                if v is not None:
                    arr[i] = np_dt.type(v)
            arrays.append(arr)
        if valid.all():
            validity.append(None)
        else:
            validity.append(valid)
            any_nulls = True
    return Table.from_arrays(
        schema, arrays, validity=validity if any_nulls else None, device=device
    )
