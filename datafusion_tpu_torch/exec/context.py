"""ExecutionContext — the session/API layer of the torch port.

Port of datafusion_tpu/exec/context.py (reference:
src/execution/context.rs: register_datasource :100, sql :44, execute
:104): tables registered on one device, SQL parsed and planned by the
port's copies of the JAX package's host layers, plans compiled to eager
torch pipelines (exec/compiler.py) with a per-(plan, tables) compile
cache. Tables come from memory, CSV (lazy on one device: a column is
parsed when a query first scans it), NDJSON and Parquet files, and
`CREATE EXTERNAL TABLE ... STORED AS CSV | NDJSON | PARQUET` registers
them. The catalog statements and DML execute: CREATE TABLE AS SELECT,
INSERT INTO, DROP TABLE [IF EXISTS], SHOW TABLES and DESCRIBE. A plan
serializes with its file-backed tables' sources (`serialize_plan`) and
runs in a fresh context (`execute_plan_json`); `last_stats` holds the
parse, plan and execute seconds of the last query. The context runs on
the card unless the caller asks for the CPU. With a mesh
(parallel/mesh.py) every query runs over the tables' row blocks, one per
logical shard, through the distributed compiler (parallel/dist.py). A
mesh may span processes (parallel/multihost.py `global_mesh`), with one
card or several in each: each process then keeps its own shards' rows of
every table, on their cards, and every process runs the same statements
in the same order.
"""

from __future__ import annotations

import copy
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from datafusion_tpu_torch.columnar.csv import CsvDataSource, LazyCsvTable, read_csv
from datafusion_tpu_torch.columnar.ndjson import read_ndjson
from datafusion_tpu_torch.columnar.parquet import read_parquet
from datafusion_tpu_torch.columnar.table import Column as TableColumn, Table, resolve_device
from datafusion_tpu_torch.errors import ExecutionError, NotImplementedError_, PlanError
from datafusion_tpu_torch.exec.compiler import PlanCompiler, compile_plan, split_host_projection
from datafusion_tpu_torch.exec.result import ResultTable
from datafusion_tpu_torch.ops.functions import AggregateUDF
from datafusion_tpu_torch.parallel.dist import DistCompiler, compile_plan_distributed
from datafusion_tpu_torch.parallel.mesh import Mesh, RankTable, ShardTable, local_blocks, place_shards
from datafusion_tpu_torch.plan.logical import Column, LogicalPlan, Projection, TableScan, plan_from_json, plan_to_json
from datafusion_tpu_torch.plan.optimizer import push_down_filters, push_down_projection
from datafusion_tpu_torch.plan.planner import FunctionMeta, FunctionType, SqlToRel, convert_data_type
from datafusion_tpu_torch.schema import Field, Schema
from datafusion_tpu_torch.sql import ast as A
from datafusion_tpu_torch.sql.parser import parse_sql
from datafusion_tpu_torch.types import DataType
from datafusion_tpu_torch.utils.trace import span

_DDL_NODES = (
    A.SQLCreateExternalTable,
    A.SQLCreateTableAs,
    A.SQLDropTable,
    A.SQLShowTables,
    A.SQLDescribeTable,
    A.SQLInsert,
)


def _concat_tables(old: Table, new: Table) -> Table:
    """`old`'s rows followed by `new`'s (INSERT), concatenated on the
    device with no decode, so every value the types hold survives (days
    and seconds outside Python's `datetime` range too). Utf8 codes map
    onto the merged sorted vocabulary. NULL slots hold the fill the JAX
    package gives them (0, or the code of "")."""
    cols = []
    for f, a, b in zip(old.schema.fields, old.columns, new.columns):
        parts = [(c.data, c.validity) for c in (a, b)]
        valid = None
        if any(v is not None for _, v in parts):
            valid = torch.cat([torch.ones_like(d, dtype=torch.bool) if v is None else v for d, v in parts])
        vocab = None
        if f.dtype is DataType.Utf8:
            words = set(a.dictionary) | set(b.dictionary)
            if valid is not None and not bool(valid.all()):
                words.add("")
            vocab = tuple(sorted(words))
            parts = [(torch.as_tensor(np.searchsorted(vocab, np.asarray(c.dictionary, dtype=object).astype(str)),
                                      dtype=torch.int32, device=d.device)[d.long()] if d.numel() else d, v)
                     for c, (d, v) in zip((a, b), parts)]
        data = torch.cat([d for d, _ in parts])
        if valid is not None:
            fill = vocab.index("") if vocab is not None else 0
            data = torch.where(valid, data, torch.full_like(data, fill))
            if bool(valid.all()):
                valid = None
        cols.append(TableColumn(f.dtype, data, valid, vocab))
    return Table(old.schema, tuple(cols), old.num_rows + new.num_rows)


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
        (`make_mesh`, or `global_mesh` over several processes); its first
        card is the context's device, and a `device` that names none of
        the mesh's cards raises. The mesh does not route to bigdense."""
        self.mesh = mesh
        if mesh is not None:
            if device is not None and resolve_device(device) not in mesh.devices:
                raise ExecutionError(f"device {device} is none of the mesh's cards {[str(d) for d in mesh.devices]}")
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
        # table name -> {file_type, path, has_header} of a file-backed
        # table: serialize_plan stamps it onto the plan's scans
        self._table_sources: dict[str, dict] = {}
        self.last_stats: dict = {}
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
        shard (`partition_table`). On a mesh that spans processes, where
        every process registers the same table, this process keeps only
        its shards' row blocks (`local_blocks`); a RankTable
        (`register_table_shards`) is kept as it is. On a mesh of several
        cards each of this process's shards is placed on its card now,
        once (`place_shards`: of a whole table, a RankTable, or a
        ShardTable again)."""
        mesh = self.mesh
        if mesh is not None and mesh.n_cards > 1:
            self._tables[name] = place_shards(table, mesh)
            return
        if mesh is not None and mesh.spans and not isinstance(table, RankTable):
            table = local_blocks(table, mesh)
        if table.columns and table.device != self.device:
            table = table.to(self.device)
        self._tables[name] = table

    def register_csv(
        self, name: str, path: str, schema: Schema, *, has_header: bool = True, lazy: Optional[bool] = None
    ) -> None:
        """Register a CSV file. `lazy` (default: on for a one-device
        context, off on a mesh, where partitioning reads every column)
        defers parsing: registration only counts the rows, and each query
        parses the columns it scans that are not parsed yet, onto this
        context's device. Eager reads the whole file now."""
        if lazy is None:
            lazy = self.mesh is None
        if lazy and self.mesh is None:
            table = LazyCsvTable(path, schema, has_header, device=self.device)
        else:
            table = read_csv(path, schema, has_header=has_header, device=self.device)
        self.register_table(name, table)
        self._table_sources[name] = {"file_type": "csv", "path": path, "has_header": has_header}

    def register_parquet(self, name: str, path: str, schema: Optional[Schema] = None) -> None:
        """Read a Parquet file onto this context's device and register it;
        without `schema` the types are inferred from the file's."""
        self.register_table(name, read_parquet(path, schema, device=self.device))
        self._table_sources[name] = {"file_type": "parquet", "path": path, "has_header": True}

    def _register_ndjson(self, name: str, path: str, schema: Schema) -> None:
        """Read an NDJSON file (one JSON object per line) onto this
        context's device and register it (STORED AS NDJSON)."""
        self.register_table(name, read_ndjson(path, schema, device=self.device))
        self._table_sources[name] = {"file_type": "ndjson", "path": path, "has_header": False}

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
        (reference: context.rs:44-98). A query (not EXPLAIN, DDL or DML)
        sets `last_stats`: its parse, plan and execute seconds and its
        row count. On a CUDA device the execute time ends with a
        `torch.cuda.synchronize()`, so it holds the device's work too."""
        with span("dft.sql"):
            return self._sql(sql)

    def _sql(self, sql: str) -> ResultTable:
        with span("dft.parse"):  # stamped inside the span: `last_stats` leaves out its cost
            t0 = time.perf_counter()
            node = parse_sql(sql)
            t_parse = time.perf_counter()
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
        with span("dft.plan"):
            t_plan0 = time.perf_counter()
            plan = SqlToRel(self._catalog).sql_to_rel(node)
            t_plan = time.perf_counter()
        result = self.execute(plan)
        if self.device.type == "cuda":
            with span("dft.synchronize"):
                torch.cuda.synchronize(self.device)
        self.last_stats = {"parse_s": t_parse - t0, "plan_s": t_plan - t_plan0,
                           "execute_s": time.perf_counter() - t_plan, "rows": result.num_rows}
        return result

    def serialize_plan(self, sql_or_plan: Union[str, LogicalPlan]) -> str:
        """The plan as JSON, with each scan of a file-backed table stamped
        with its source ({file_type, path, has_header}), so a context with
        no tables registered can run it (`execute_plan_json`). The
        reference's serializable DataSourceMeta and PhysicalPlan were never
        constructed (datasource.rs:78-93, physicalplan.rs:18-34)."""
        plan = self.plan(sql_or_plan) if isinstance(sql_or_plan, str) else copy.deepcopy(sql_or_plan)

        def stamp(p) -> None:
            if isinstance(p, TableScan) and p.source is None:
                p.source = self._table_sources.get(p.table_name)
            for c in p.children():
                stamp(c)

        stamp(plan)
        return json.dumps(plan_to_json(plan))

    def execute_plan_json(self, text: str) -> ResultTable:
        """Run a serialized plan. A scan of a table this context lacks is
        registered first from the source stamped on it."""
        plan = plan_from_json(json.loads(text))
        loaders = {
            "csv": lambda name, src, schema: self.register_csv(
                name, src["path"], schema, has_header=bool(src.get("has_header", True))),
            "parquet": lambda name, src, schema: self.register_parquet(name, src["path"], schema),
            "ndjson": lambda name, src, schema: self._register_ndjson(name, src["path"], schema),
        }

        def load(p) -> None:
            if isinstance(p, TableScan) and p.table_name not in self._tables and p.source is not None:
                kind = p.source.get("file_type")
                if kind not in loaders:
                    raise ExecutionError(
                        f"serialized TableScan of '{p.table_name}' has unknown source file_type {kind!r}")
                loaders[kind](p.table_name, p.source, p.schema)
            for c in p.children():
                load(c)

        load(plan)
        return self.execute(plan)

    def execute(self, plan: LogicalPlan) -> ResultTable:
        """Compile (with caching) and run a logical plan. The filter and
        projection push-down optimizers run here (the reference disabled
        its optimizer at this exact point, context.rs:89)."""
        with span("dft.optimize"):
            plan = push_down_projection(push_down_filters(plan))
            key = (repr(plan), tuple(sorted((n, id(t)) for n, t in self._tables.items())))
            compiled = self._compile_cache.get(key)
        if compiled is None:
            with span("dft.lower"):
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
                self._table_sources.pop(node.name, None)
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
        and rebuild the table as its rows followed by the new ones. A
        table on a mesh's shards (a RankTable or a ShardTable) is read
        whole by a scan first, as every process reads the new rows whole,
        and the rebuilt table is registered as any whole table is."""
        target = self._tables.get(node.table)
        if target is None:
            raise PlanError(f"no table named {node.table} to insert into")
        if isinstance(target, (RankTable, ShardTable)):
            # its rows, every shard's in shard order (every process's on a
            # spanning mesh), read as the JAX package reads them: by a scan
            target = self.execute(TableScan("default", node.table, target.schema, None)).to_table(self.device)
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
        new = self.execute(Projection(tuple(casts), src_plan, tschema)).to_table(self.device)
        self.register_table(node.table, _concat_tables(target, new))

    def _execute_ddl(self, node: A.SQLCreateExternalTable) -> None:
        schema = Schema(
            [Field(c.name, convert_data_type(c.type_name), c.allow_null) for c in node.columns]
        )
        if node.file_type is A.FileType.CSV:
            self.register_csv(node.name, node.location, schema, has_header=node.header_row)
        elif node.file_type is A.FileType.NdJson:
            self._register_ndjson(node.name, node.location, schema)
        elif node.file_type is A.FileType.Parquet:
            self.register_parquet(node.name, node.location, schema if node.columns else None)
        else:
            raise NotImplementedError_(f"STORED AS {node.file_type.value} is not supported")
