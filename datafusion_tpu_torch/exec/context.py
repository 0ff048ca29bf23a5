"""ExecutionContext — the session/API layer of the torch port.

Port of datafusion_tpu/exec/context.py for the main path (reference:
src/execution/context.rs: register_datasource :100, sql :44, execute
:104): tables registered on one device, SQL parsed and planned by the
port's copies of the JAX package's host layers, plans compiled to eager
torch pipelines (exec/compiler.py) with a per-(plan, tables) compile
cache. `CREATE EXTERNAL TABLE ... STORED AS CSV` executes, and so do the
catalog statements and DML: CREATE TABLE AS SELECT, INSERT INTO, DROP
TABLE [IF EXISTS], SHOW TABLES and DESCRIBE. The context runs on the card
unless the caller asks for the CPU. With a mesh
(parallel/mesh.py) every query runs over the tables' row blocks, one per
logical shard, through the distributed compiler (parallel/dist.py).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np

from datafusion_tpu_torch.columnar.csv import CsvDataSource, read_csv
from datafusion_tpu_torch.columnar.table import Table, resolve_device
from datafusion_tpu_torch.errors import ExecutionError, NotImplementedError_, PlanError
from datafusion_tpu_torch.exec.compiler import PlanCompiler, compile_plan, split_host_projection
from datafusion_tpu_torch.exec.result import ResultTable
from datafusion_tpu_torch.ops.functions import AggregateUDF
from datafusion_tpu_torch.parallel.dist import DistCompiler, compile_plan_distributed
from datafusion_tpu_torch.parallel.mesh import Mesh
from datafusion_tpu_torch.plan.logical import Column, LogicalPlan, Projection, TableScan
from datafusion_tpu_torch.plan.optimizer import push_down_filters, push_down_projection
from datafusion_tpu_torch.plan.planner import FunctionMeta, FunctionType, SqlToRel, convert_data_type
from datafusion_tpu_torch.schema import Field, Schema
from datafusion_tpu_torch.sql import ast as A
from datafusion_tpu_torch.sql.parser import parse_sql
from datafusion_tpu_torch.types import DataType

_DDL_NODES = (
    A.SQLCreateExternalTable,
    A.SQLCreateTableAs,
    A.SQLDropTable,
    A.SQLShowTables,
    A.SQLDescribeTable,
    A.SQLInsert,
)


def _table_from_results(schema: Schema, rts, device) -> Table:
    """Concatenate host ResultTables of one schema into a table on
    `device` (INSERT's old rows + new rows); NULL slots hold a fill."""
    arrays, validity = [], []
    for j, f in enumerate(schema.fields):
        vals = [v for rt in rts for v in rt.column_values(j)]
        mask = np.array([v is not None for v in vals], dtype=bool)
        if f.dtype is DataType.Utf8:
            arrays.append(["" if v is None else str(v) for v in vals])
        elif f.dtype is DataType.Date32:
            arrays.append([datetime.date(1970, 1, 1) if v is None else v for v in vals])
        elif f.dtype is DataType.Timestamp:
            arrays.append([datetime.datetime(1970, 1, 1) if v is None else v for v in vals])
        else:
            arrays.append(np.array([0 if v is None else v for v in vals], f.dtype.to_np()))
        validity.append(None if mask.all() else mask)
    return Table.from_arrays(schema, arrays, validity=validity, device=device)


def _text_result(names: tuple[str, ...], rows: list[tuple[str, ...]]) -> ResultTable:
    """A host result of Utf8 columns (SHOW TABLES, DESCRIBE)."""
    schema = Schema([Field(n, DataType.Utf8) for n in names])
    cols = [(np.array([r[j] for r in rows], dtype=object), None) for j in range(len(names))]
    return ResultTable(schema, cols, [None] * len(names))


@dataclass
class _Catalog:
    """SchemaProvider over the registered tables/functions
    (reference: ExecutionContextSchemaProvider, context.rs:244-258)."""

    ctx: "ExecutionContext"

    def get_table_meta(self, name: str) -> Optional[Schema]:
        t = self.ctx._tables.get(name)
        return t.schema if t is not None else None

    def get_function_meta(self, name: str) -> Optional[FunctionMeta]:
        entry = self.ctx._functions.get(name.lower())
        return entry[0] if entry else None

    def get_aggregate_udf(self, name: str):
        """The AggregateUDF registered under `name` (None for scalar UDFs
        and unknown names): the planner's UDAF desugar reads it."""
        entry = self.ctx._functions.get(name.lower())
        if entry and isinstance(entry[1], AggregateUDF):
            return entry[1]
        return None


class ExecutionContext:
    """Session object: table registry + SQL entry point, on one device."""

    def __init__(self, device=None, bigdense: Optional[bool] = None, mesh: Optional[Mesh] = None):
        """`device`: where tables live and queries run. None means the
        card ("cuda"), and raises on a machine without one; pass "cpu"
        to run on the CPU. `bigdense`: route GROUP BYs of 2,048 to 16,383
        slots to the radix-partition path (K3 + K4). None reads
        DFTPU_BIGDENSE once, here: unset or "0" is off, any other value
        on. Every plan of this context, executed or EXPLAINed, uses it.
        `mesh`: run every query over the mesh's logical shards
        (`make_mesh`); its device is the context's, and a `device` that
        names another raises. The mesh does not route to bigdense."""
        self.mesh = mesh
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ExecutionError(f"device {device} differs from the mesh's device {mesh.device}")
            self.device = mesh.device
            if bigdense:
                raise ExecutionError("a mesh context has no bigdense route")
            bigdense = False
        else:
            self.device = resolve_device(device)
        if bigdense is None:
            bigdense = os.environ.get("DFTPU_BIGDENSE", "0") not in ("", "0")
        self.bigdense = bigdense
        self._tables: dict[str, Table] = {}
        self._functions: dict[str, tuple[FunctionMeta, Optional[Callable]]] = {}
        self._compile_cache: dict = {}
        self._catalog = _Catalog(self)
        from datafusion_tpu_torch.ops.expr_eval import SCALAR_FUNCTIONS

        for name in SCALAR_FUNCTIONS:
            self._functions[name] = (
                FunctionMeta(name, (Field("n", DataType.Float64, False),), DataType.Float64, FunctionType.Scalar),
                None,  # the compiler falls back to the built-in implementation
            )

    # ------------------------------------------------------------------
    def register_datasource(self, name: str, ds: Union[CsvDataSource, Table]) -> None:
        """Register a data source (reference: context.rs:100): a Table,
        or a CsvDataSource read onto this context's device."""
        if isinstance(ds, Table):
            self.register_table(name, ds)
        elif isinstance(ds, CsvDataSource):
            self.register_table(name, ds.table(self.device))
        else:
            raise ExecutionError(f"unsupported datasource {type(ds).__name__}")

    def register_table(self, name: str, table: Table) -> None:
        """Register a table, moving it to this context's device. With a
        mesh, each query partitions it into row-block views, one per
        shard (`partition_table`)."""
        if table.columns and table.device != self.device:
            table = table.to(self.device)
        self._tables[name] = table

    def register_csv(self, name: str, path: str, schema: Schema, *, has_header: bool = True) -> None:
        """Read a CSV file onto this context's device and register it."""
        self.register_table(name, read_csv(path, schema, has_header=has_header, device=self.device))

    def register_function(self, meta: FunctionMeta, fn: Optional[Callable] = None) -> None:
        """Register a UDF. Scalar: `fn` maps torch tensors to a tensor, or
        is a HostFunction run on the host at result time. Aggregate: `fn`
        must be an AggregateUDF (map/combine/finalize, ops/functions.py),
        whose map and finalize become the scalar hooks `<name>__map` and
        `<name>__finalize` that the planner's desugar calls; a plain
        callable is refused here rather than at execution."""
        low = meta.name.lower()
        if meta.function_type is FunctionType.Aggregate:
            if not isinstance(fn, AggregateUDF):
                raise PlanError(
                    f"aggregate UDF '{meta.name}' must be registered with an "
                    "AggregateUDF(map=..., combine=..., finalize=...) (datafusion_tpu_torch.AggregateUDF)"
                )
            if fn.map_fn is not None:
                self._functions[f"{low}__map"] = (
                    FunctionMeta(f"{low}__map", meta.args, DataType.Float64, FunctionType.Scalar), fn.map_fn)
            if fn.finalize_fn is not None:
                self._functions[f"{low}__finalize"] = (
                    FunctionMeta(f"{low}__finalize", (Field("agg", DataType.Float64, False),
                                                      Field("n", DataType.Float64, False)),
                                 meta.return_type, FunctionType.Scalar),
                    fn.finalize_fn,
                )
        self._functions[low] = (meta, fn)

    def table(self, name: str) -> Table:
        return self._tables[name]

    def _fn_registry(self) -> dict:
        return {n: f for n, (m, f) in self._functions.items() if f is not None}

    # ------------------------------------------------------------------
    def plan(self, sql: str) -> LogicalPlan:
        """Parse + plan without executing."""
        node = parse_sql(sql)
        if isinstance(node, _DDL_NODES):
            raise PlanError("DDL statements have no logical plan")
        return SqlToRel(self._catalog).sql_to_rel(node)

    def sql(self, sql: str) -> ResultTable:
        """Parse, plan, compile, and execute a SQL statement
        (reference: context.rs:44-98)."""
        node = parse_sql(sql)
        if isinstance(node, A.SQLExplain):
            inner = node.stmt
            if isinstance(inner, _DDL_NODES):
                raise PlanError("cannot EXPLAIN a DDL statement")
            plan = push_down_projection(push_down_filters(SqlToRel(self._catalog).sql_to_rel(inner)))
            text = repr(plan) + "\n"
            if node.verbose:
                # lower (no execution) to record the physical choices
                fn_reg = self._fn_registry()
                plan, _ = split_host_projection(plan, fn_reg)
                if self.mesh is not None:
                    pc = DistCompiler(self._tables, self.mesh, fn_reg)
                else:
                    pc = PlanCompiler(self._tables, fn_reg, self.device, self.bigdense)
                pc.lower(plan)
                for note in pc.notes + pc.sticky_notes:
                    text += f"physical: {note}\n"
            return ResultTable(Schema.empty(), [], [], raw_text=text)
        if isinstance(node, _DDL_NODES):
            return self._execute_statement(node)
        return self.execute(SqlToRel(self._catalog).sql_to_rel(node))

    def execute(self, plan: LogicalPlan) -> ResultTable:
        """Compile (with caching) and run a logical plan. The filter and
        projection push-down optimizers run here (the reference disabled
        its optimizer at this exact point, context.rs:89)."""
        plan = push_down_projection(push_down_filters(plan))
        key = (repr(plan), tuple(sorted((n, id(t)) for n, t in self._tables.items())))
        compiled = self._compile_cache.get(key)
        if compiled is None:
            if self.mesh is not None:
                compiled = compile_plan_distributed(plan, self._tables, self.mesh, self._fn_registry())
            else:
                compiled = compile_plan(plan, self._tables, self._fn_registry(), self.device, self.bigdense)
            self._compile_cache[key] = compiled
        return compiled.run()

    # ------------------------------------------------------------------
    def _execute_statement(self, node) -> ResultTable:
        """The catalog statements and DML (the JAX package's
        exec/context.py:281-330): tables are immutable on the device, so
        CTAS registers its query's result and INSERT rebuilds the table."""
        done = ResultTable(Schema.empty(), [], [])
        if isinstance(node, A.SQLCreateExternalTable):
            self._execute_ddl(node)
        elif isinstance(node, A.SQLCreateTableAs):
            result = self.execute(SqlToRel(self._catalog).sql_to_rel(node.select))
            self.register_table(node.name, result.to_table(self.device))
        elif isinstance(node, A.SQLInsert):
            self._execute_insert(node)
        elif isinstance(node, A.SQLDropTable):
            if node.name not in self._tables:
                if not node.if_exists:
                    raise PlanError(f"no table named {node.name} to drop")
            else:
                del self._tables[node.name]
        elif isinstance(node, A.SQLShowTables):
            return _text_result(("table",), [(n,) for n in sorted(self._tables)])
        elif isinstance(node, A.SQLDescribeTable):
            t = self._tables.get(node.name)
            if t is None:
                raise PlanError(f"no table named {node.name}")
            return _text_result(("column_name", "data_type", "nullable"),
                                [(f.name, f.dtype.value, "YES" if f.nullable else "NO") for f in t.schema.fields])
        return done

    def _execute_insert(self, node: A.SQLInsert) -> None:
        """INSERT INTO: run the source query, cast each column to the
        target's type (a column list reorders and must name every column),
        and rebuild the table as its rows followed by the new ones."""
        target = self._tables.get(node.table)
        if target is None:
            raise PlanError(f"no table named {node.table} to insert into")
        tschema = target.schema
        src_plan = SqlToRel(self._catalog).sql_to_rel(node.source)
        sschema = src_plan.schema
        order = list(range(len(tschema)))
        if node.columns is not None:
            if sorted(node.columns) != sorted(tschema.names()):
                raise PlanError(
                    "INSERT column list must name every target column "
                    f"exactly once (target: {tschema.names()})"
                )
            pos = {c: i for i, c in enumerate(node.columns)}
            order = [pos[f.name] for f in tschema.fields]
        if len(sschema) != len(tschema):
            raise PlanError(f"INSERT source has {len(sschema)} columns, table {node.table} has {len(tschema)}")
        casts = []
        for f, i in zip(tschema.fields, order):
            col = Column(i)
            casts.append(col if sschema.field(i).dtype is f.dtype else col.cast_to(f.dtype, sschema))
        new_rt = self.execute(Projection(tuple(casts), src_plan, tschema))
        old_rt = self.execute(TableScan("default", node.table, tschema, None))
        self.register_table(node.table, _table_from_results(tschema, [old_rt, new_rt], self.device))

    def _execute_ddl(self, node: A.SQLCreateExternalTable) -> None:
        schema = Schema(
            [Field(c.name, convert_data_type(c.type_name), c.allow_null) for c in node.columns]
        )
        if node.file_type is not A.FileType.CSV:
            raise NotImplementedError_(
                f"STORED AS {node.file_type.value} is not part of the torch port yet"
            )
        self.register_csv(node.name, node.location, schema, has_header=node.header_row)
