"""datafusion_tpu_torch — the PyTorch / CUDA port of datafusion_tpu.

The same SQL engine (SQL parsing and planning, projection, selection,
CAST, MIN/MAX/SUM/COUNT/AVG, STDDEV/VARIANCE, MEDIAN and percentiles,
the DISTINCT aggregates and aggregate UDFs with GROUP BY, ORDER BY,
LIMIT, joins, windows, UNION, the date functions, the catalog statements
and DML) running eagerly in PyTorch on an NVIDIA GPU, with hand-written
Hopper (sm_90a) CUDA kernels where the JAX package had Pallas kernels:
the fused scan/filter/project stage, the segmented reduce, the slab
partition and windowed reduce, and the ragged exchange with and without
its fold. The JAX package `datafusion_tpu` is the reference this package
is tested against; this package imports nothing from it, and never
imports jax.

Tables come from memory, CSV (`register_csv`: lazy on one device, a
column parsed by the native C++ loader when a query first scans it),
NDJSON and Parquet (`CREATE EXTERNAL TABLE ... STORED AS CSV | NDJSON |
PARQUET`, `register_parquet`). `serialize_plan` / `execute_plan_json`
ship a plan with its tables' sources; `last_stats` times the last query;
`python -m datafusion_tpu_torch.console` is the SQL console.

Entry points run on the card: `ExecutionContext()` means
`device="cuda"` and raises on a machine without one unless the caller
passes `device="cpu"` (the console: `--device cpu`).
`ExecutionContext(mesh=make_mesh(8))` runs every query over 8 logical
shards of its tables on one device, with the distributed engine's
shuffle kernels (ragged exchange, exchange + fold). Over several
processes, each calls `initialize_multihost(address, world, rank)` and
runs the same statements in `ExecutionContext(mesh=global_mesh())`: each
process holds its block of the shards on its own device, and
`register_csv_shards` reads one CSV file per process into one table.
`make_mesh(8, devices=...)` spreads one process's shards over several
cards, and `initialize_multihost(..., cards_per_process=2)` with
`global_mesh(4, devices=...)` gives each process several cards of one
mesh, as a TPU host holds several chips of the JAX package's global mesh.
"""

from datafusion_tpu_torch.columnar.csv import CsvDataSource, read_csv
from datafusion_tpu_torch.columnar.table import Column, Table
from datafusion_tpu_torch.errors import (
    ExecutionError,
    InvalidColumnError,
    NotImplementedError_,
    ParserError,
    PlanError,
)
from datafusion_tpu_torch.exec.context import ExecutionContext
from datafusion_tpu_torch.ops.functions import AggregateUDF, HostFunction
from datafusion_tpu_torch.parallel.mesh import Mesh, make_mesh
from datafusion_tpu_torch.parallel.multihost import (
    global_mesh,
    initialize_multihost,
    register_csv_shards,
    register_table_shards,
    to_host,
)
from datafusion_tpu_torch.plan.logical import Expr, LogicalPlan
from datafusion_tpu_torch.plan.planner import FunctionMeta, FunctionType
from datafusion_tpu_torch.schema import Field, Schema
from datafusion_tpu_torch.types import DataType, ScalarValue, can_coerce_from, get_supertype

__all__ = [
    "AggregateUDF",
    "Column",
    "CsvDataSource",
    "DataType",
    "ExecutionContext",
    "ExecutionError",
    "Expr",
    "Field",
    "FunctionMeta",
    "FunctionType",
    "HostFunction",
    "InvalidColumnError",
    "LogicalPlan",
    "Mesh",
    "NotImplementedError_",
    "ParserError",
    "PlanError",
    "ScalarValue",
    "Schema",
    "Table",
    "can_coerce_from",
    "get_supertype",
    "global_mesh",
    "initialize_multihost",
    "make_mesh",
    "read_csv",
    "register_csv_shards",
    "register_table_shards",
    "to_host",
]
