"""Physical compiler: LogicalPlan -> an eager torch pipeline.

Port of datafusion_tpu/exec/compiler.py for the main path: TableScan,
Selection, Projection (with the fused scan/filter/project stage, kernel
K1), Aggregate (dense and packed/sorted GROUP BY over kernel K2, the
opt-in bigdense GROUP BY over kernels K3 and K4, and ungrouped), Sort,
Limit and ORDER BY ... LIMIT as a top-k selection, Join (inner, left,
right, full and cross; ops/join.py), Window (ops/window.py) and Union.

Each plan node lowers once, at plan time, to a function over the scanned
tables' columns; torch runs it eagerly on the tables' device. Selection
stays a mask, as in the JAX package; compaction happens where a shape
depends on the data (sort, GROUP BY, top-k, materialization), which in
eager torch is simply computed — the JAX package's whole-plan `jit` and
its fixed-capacity overflow retry (CompiledQuery.run) have no
counterpart. Routing is decided at plan time and recorded in `notes`:
the `_elementwise_safe` whitelist and K1's opcode set for the fused
stage, the DENSE_MAX_GROUPS gate for K2's dense mode, and the bigdense
gate (`_bigdense_ok`). A join's strategy is the one choice made at run
time (`_join_runner`): the JAX package's retry ladder, decided by a count
of repeated build keys; CompiledQuery.run reports it in `routes`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from datafusion_tpu_torch.columnar.table import Table, resolve_device
from datafusion_tpu_torch.errors import ExecutionError, NotImplementedError_
from datafusion_tpu_torch.ops import aggregate as agg_ops
from datafusion_tpu_torch.ops import join as join_ops
from datafusion_tpu_torch.ops import sort as sort_ops
from datafusion_tpu_torch.ops import window as window_ops
from datafusion_tpu_torch.ops.expr_eval import (
    SCALAR_FUNCTIONS,
    ColVal,
    broadcast_col,
    compile_expr,
    is_date_function,
)
from datafusion_tpu_torch.ops.pallas import fused_stage as fs
from datafusion_tpu_torch.ops.pallas import partition as part
from datafusion_tpu_torch.plan import logical as L
from datafusion_tpu_torch.schema import Schema
from datafusion_tpu_torch.types import DataType, torch_dtype
from datafusion_tpu_torch.utils.trace import span, spanned


@dataclass
class Batch:
    """Intermediate: columns + selection mask."""

    cols: list[ColVal]
    sel: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.sel.shape[0])


@dataclass
class ShardedBatch:
    """A batch over a mesh's logical shards (parallel/): one Batch per
    shard of this process. "partitioned": the shards' rows together, in
    shard order, are the result; "replicated": every shard holds the
    whole result."""

    shards: list[Batch]
    layout: str

    def merged(self, mesh=None) -> Batch:
        """The result as one Batch: the shards concatenated in shard order
        (partitioned), or shard 0 (replicated). Shards on other cards than
        shard 0's come there by one peer copy each (collectives.to_card),
        as an all_gather brings them to the mesh's first card. On a `mesh`
        that spans processes the partitioned rows of every process meet,
        in rank order (an all_gather), and every process gets the same
        Batch."""
        if self.layout == "replicated":
            return self.shards[0]
        with span("dft.merge"):
            return self._concatenated(mesh)

    def _concatenated(self, mesh) -> Batch:
        from datafusion_tpu_torch.parallel.collectives import to_card

        dev = self.shards[0].sel.device
        caps = [b.capacity for b in self.shards]
        cols = []
        for j in range(len(self.shards[0].cols)):
            parts = [broadcast_col(b.cols[j], n) for b, n in zip(self.shards, caps)]
            data = torch.cat([to_card(d, dev) for d, _ in parts])
            if all(v is None for _, v in parts):
                cols.append((data, None))
            else:
                cols.append((data, torch.cat([torch.ones(d.shape[0], dtype=torch.bool, device=dev) if v is None
                                              else to_card(v, dev) for d, v in parts])))
        local = Batch(cols, torch.cat([to_card(b.sel, dev) for b in self.shards]))
        return local if mesh is None or not mesh.spans else gather_batch(local, mesh)


def gather_batch(b: Batch, mesh) -> Batch:
    """Every process's Batch `b`, in rank order (parallel/collectives.py
    `gather_rows`: one exchange of lengths, one of bytes); a column has a
    validity where some process's has one."""
    from datafusion_tpu_torch.parallel.collectives import gather_rows

    cols = [broadcast_col(c, b.capacity) for c in b.cols]
    g = gather_rows(mesh, [b.sel] + [d for d, _ in cols] + [v for _, v in cols])
    n = len(cols)
    return Batch(list(zip(g[1:1 + n], g[1 + n:])), g[0])


@dataclass
class Lowered:
    """A lowered plan node: static metadata + stage function.
    `sources[j]` is (scan_slot, column_index) when output column j is a
    pass-through of a scanned column (only row masks applied), which the
    GROUP BY domain probe reads; None for computed columns. `layout` is
    None for a stage that maps one env (or one shard's env) to a Batch,
    and "partitioned" / "replicated" for a distributed stage, which maps
    the shards' envs to a ShardedBatch (parallel/dist.py). `capacity` is
    the JAX package's static row capacity of the node (see
    `ref_capacity`), which gates the direct join as it does there.
    `bounds[j]` is a (lo, hi) bound on column j's selected, valid values
    that a join proved (`_lower_join`); None where none is known. `span`
    is the node's span name (`PlanCompiler._named`); `route` is the route
    its lowering picked, which the name ends with."""

    schema: Schema
    dicts: list[Optional[tuple[str, ...]]]
    fn: Callable[[list], Batch]
    sources: Optional[list[Optional[tuple[int, int]]]] = None
    layout: Optional[str] = None
    capacity: int = 0
    bounds: Optional[list[Optional[tuple[int, int]]]] = None
    span: str = ""
    route: str = ""

    def src(self) -> list[Optional[tuple[int, int]]]:
        return self.sources if self.sources is not None else [None] * len(self.schema)

    def bnd(self) -> list[Optional[tuple[int, int]]]:
        return list(self.bounds) if self.bounds is not None else [None] * len(self.schema)


def _key_dtype(c) -> torch.dtype:
    """The device dtype of a compiled expression's data: dictionary codes
    are int32."""
    if c.dictionary is not None or c.dtype is DataType.Utf8:
        return torch.int32
    try:
        return torch_dtype(c.dtype)
    except ValueError:
        return torch.int64


REF_PAD_UNIT = 1024  # the JAX package pads every table to a multiple of this (its columnar/table.py PAD_UNIT)


def ref_capacity(rows: int) -> int:
    """The JAX package's capacity of a table of `rows` rows: `rows`
    rounded up to REF_PAD_UNIT, at least one unit. The port sizes nothing
    by it; it only reproduces the direct join's domain gate."""
    return max(REF_PAD_UNIT, -(-rows // REF_PAD_UNIT) * REF_PAD_UNIT)


@dataclass
class HostCall:
    """A host-stage function call in the output projection: `fn` runs on
    the materialized result columns (ops/functions.py). Args are nested
    HostCalls or indices of device columns in the inner projection."""

    fn: Callable
    args: list  # HostCall | int


_WIDENED = (DataType.UInt16, DataType.UInt32, DataType.UInt64)


@dataclass
class CompiledQuery:
    schema: Schema
    dicts: list[Optional[tuple[str, ...]]]
    _fn: Callable[[list], Batch]
    _scan_tables: list[Table]
    _host_post: Optional[tuple] = None
    notes: tuple[str, ...] = ()
    _mesh: Optional[object] = None  # parallel.mesh.Mesh of a distributed plan
    _routes: Optional[list] = None  # filled by the stages that choose a route at run time (joins)
    # per scan slot, the table columns the pipeline reads; the others go
    # into a one-card env as (None, None), so a lazy table never parses
    # them. None: every column.
    _used_cols: Optional[list[set]] = None

    def run(self):
        """Execute and materialize the selected rows on the host. A
        distributed plan runs over the scanned tables' row-block shards
        and materializes its ShardedBatch merged. The result's `routes`
        lists what the run-time choices took: each join's strategy."""
        routes = self._routes if self._routes is not None else []
        routes.clear()
        res = self._run()
        res.routes = tuple(routes)
        return res

    def device_result(self):
        """Run the pipeline and return its result on the device, before
        materialization: a Batch, or on a mesh this process's
        ShardedBatch."""
        if self._mesh is None:
            used = self._used_cols or [None] * len(self._scan_tables)
            env = [[(c.data, c.validity) if u is None or i in u else (None, None) for i, c in enumerate(t.columns)]
                   for t, u in zip(self._scan_tables, used)]
            return self._fn(env)
        from datafusion_tpu_torch.parallel.mesh import partition_table

        per_table = [partition_table(t, self._mesh) for t in self._scan_tables]
        envs = [[[(c.data, c.validity) for c in shards[i].columns] for shards in per_table]
                for i in range(self._mesh.n_local)]
        return self._fn(envs)

    def host_columns(self, out) -> list[tuple]:
        """`device_result`'s selected rows on the host, one (data,
        validity) pair of numpy arrays per column, through
        parallel/multihost.py `to_host`: one compaction and one
        synchronize for the whole result. A partitioned result on a mesh
        that spans processes gathers every process's rows, in rank order,
        so every process materializes the same rows; on a mesh of several
        cards the shards first meet on the first card (`merged`)."""
        from datafusion_tpu_torch.parallel.multihost import to_host

        mesh = None
        if isinstance(out, ShardedBatch):
            mesh = self._mesh if out.layout == "partitioned" else None
            out = out.merged()
        cols = [broadcast_col(c, out.capacity) for c in out.cols]
        host = to_host([d for d, _ in cols] + [v for _, v in cols], out.sel, mesh=mesh)
        n = len(cols)
        host_cols = []
        for j, f in enumerate(self.schema.fields):
            dd = host[j]
            if f.dtype in _WIDENED:
                dd = dd.astype(f.dtype.to_np())  # back to the logical unsigned dtype
            host_cols.append((dd, host[n + j]))
        return host_cols

    def _run(self):
        from datafusion_tpu_torch.exec.result import ResultTable

        out = self.device_result()
        with span("dft.materialize"):
            cols = self.host_columns(out)
        with span("dft.result"):
            inner = ResultTable(self.schema, cols, self.dicts)
            if self._host_post is None:
                return inner
            return apply_host_post(inner, self._host_post)


# ---------------------------------------------------------------------------
# Host-stage projection split (ops/functions.py HostFunction)
# ---------------------------------------------------------------------------


def _expr_children(e: L.Expr) -> tuple:
    if isinstance(e, (L.Alias, L.Cast, L.IsNull, L.IsNotNull, L.SortExpr)):
        return (e.expr,)
    if isinstance(e, L.BinaryExpr):
        return (e.left, e.right)
    if isinstance(e, (L.ScalarFunction, L.AggregateFunction)):
        return tuple(e.args)
    if isinstance(e, L.Case):
        kids = [x for b in e.branches for x in b]
        if e.else_expr is not None:
            kids.append(e.else_expr)
        return tuple(kids)
    return ()


def split_host_projection(plan: L.LogicalPlan, fn_registry: dict):
    """If the top-level projection calls host-stage functions, split it:
    the returned plan computes their device arguments as ordinary
    projection columns and the host_post descriptor re-assembles the
    final columns on the host at materialization (apply_host_post).
    Returns (plan, None) when nothing to split."""
    from datafusion_tpu_torch.ops.functions import HostFunction

    def is_host_call(e) -> bool:
        return isinstance(e, L.ScalarFunction) and isinstance(
            fn_registry.get(e.name.lower()), HostFunction
        )

    def is_host_cast(e, schema) -> bool:
        # CAST(<non-string> AS VARCHAR): the device computes the argument,
        # the host renders the text (ops/functions.py CastRenderHost)
        if not (isinstance(e, L.Cast) and e.data_type is DataType.Utf8):
            return False
        try:
            st = e.expr.get_type(schema)
        except Exception:
            return False
        return st not in (DataType.Utf8, DataType.Null)

    def contains_host(e, schema=None) -> bool:
        if is_host_call(e):
            return True
        if schema is not None and is_host_cast(e, schema):
            return True
        return any(contains_host(c, schema) for c in _expr_children(e))

    # push the split through Limit/Sort wrappers: the host stage runs
    # after materialization, which preserves their row set and order
    if isinstance(plan, L.Limit):
        inner, post = split_host_projection(plan.input, fn_registry)
        if post is None:
            return plan, None
        return L.Limit(plan.limit, inner, inner.schema, plan.offset), post
    if isinstance(plan, L.Sort):
        inner, post = split_host_projection(plan.input, fn_registry)
        if post is None:
            return plan, None
        _, outmap = post

        def remap(e: L.Expr) -> L.Expr:
            if isinstance(e, L.Column):
                entry = outmap[e.index]
                if entry[0] != "dev":
                    raise NotImplementedError_("cannot ORDER BY a host function result")
                return L.Column(entry[1])
            if isinstance(e, L.SortExpr):
                return L.SortExpr(remap(e.expr), e.asc, e.nulls_first)
            if isinstance(e, L.Alias):
                return L.Alias(remap(e.expr), e.name)
            if isinstance(e, L.Cast):
                return L.Cast(remap(e.expr), e.data_type)
            if isinstance(e, L.IsNull):
                return L.IsNull(remap(e.expr))
            if isinstance(e, L.IsNotNull):
                return L.IsNotNull(remap(e.expr))
            if isinstance(e, L.BinaryExpr):
                return L.BinaryExpr(remap(e.left), e.op, remap(e.right))
            if isinstance(e, L.ScalarFunction):
                return L.ScalarFunction(e.name, tuple(remap(a) for a in e.args), e.return_type)
            if isinstance(e, L.Case):
                return L.Case(
                    tuple((remap(c), remap(r)) for c, r in e.branches),
                    None if e.else_expr is None else remap(e.else_expr),
                )
            return e

        keys = tuple(remap(se) for se in plan.exprs)
        return L.Sort(keys, inner, inner.schema), post

    if not isinstance(plan, L.Projection):
        return plan, None
    from datafusion_tpu_torch.plan.optimizer import out_schema

    ischema = out_schema(plan.input)
    if not any(contains_host(e, ischema) for e in plan.exprs):
        return plan, None

    device_exprs: list[L.Expr] = []

    def decompose(e) -> HostCall:
        if isinstance(e, L.Cast):
            from datafusion_tpu_torch.ops.functions import CastRenderHost

            a_ = e.expr.expr if isinstance(e.expr, L.Alias) else e.expr
            if contains_host(a_, ischema):
                raise NotImplementedError_("CAST AS VARCHAR of a host function result is not supported")
            idx = len(device_exprs)
            device_exprs.append(a_)
            return HostCall(CastRenderHost(a_.get_type(ischema)), [idx])
        fn = fn_registry[e.name.lower()]
        args = []
        for a in e.args:
            a_ = a.expr if isinstance(a, L.Alias) else a
            if contains_host(a_, ischema):
                if not is_host_call(a_):
                    raise NotImplementedError_(
                        "a host function result can only feed another host "
                        "function, not a device expression"
                    )
                args.append(decompose(a_))
            else:
                args.append(len(device_exprs))
                device_exprs.append(a_)
        return HostCall(fn, args)

    outmap: list[tuple] = []
    for e in plan.exprs:
        if contains_host(e, ischema):
            stripped = e.expr if isinstance(e, L.Alias) else e
            if not (is_host_call(stripped) or is_host_cast(stripped, ischema)):
                raise NotImplementedError_("host functions must be the outermost call of a SELECT item")
            outmap.append(("host", decompose(stripped)))
        else:
            outmap.append(("dev", len(device_exprs)))
            device_exprs.append(e)
    # typed against the pushed-down input schema (plan.input.schema can be
    # the pre-push-down one)
    inner_schema = Schema(L.exprlist_to_fields(device_exprs, ischema))
    inner = L.Projection(tuple(device_exprs), plan.input, inner_schema)
    return inner, (plan.schema, outmap)


def apply_host_post(inner, host_post):
    """Evaluate the host-stage calls over the materialized inner result
    and assemble the final ResultTable."""
    from datafusion_tpu_torch.exec.result import ResultTable

    final_schema, outmap = host_post

    def decoded(j):
        data, valid = inner.cols[j]
        dt = inner.schema.field(j).dtype
        if dt is DataType.Utf8 and inner.dicts[j] is not None:
            vocab = np.asarray(inner.dicts[j], dtype=object)
            data = vocab[np.clip(data, 0, max(len(vocab) - 1, 0))]
        return data, valid

    def eval_call(call):
        arrs, valid = [], None
        for a in call.args:
            d, v = eval_call(a) if isinstance(a, HostCall) else decoded(a)
            arrs.append(d)
            if v is not None:
                valid = v if valid is None else np.logical_and(valid, v)
        return call.fn(*arrs), valid

    cols, dicts = [], []
    for entry, fld in zip(outmap, final_schema.fields):
        if entry[0] == "dev":
            j = entry[1]
            cols.append(inner.cols[j])
            dicts.append(inner.dicts[j])
        else:
            data, valid = eval_call(entry[1])
            if fld.dtype.is_numeric or fld.dtype is DataType.Boolean:
                data = np.asarray(data, dtype=fld.dtype.to_np())
            cols.append((data, valid))
            dicts.append(None)  # host Utf8 stays a raw object column
    return ResultTable(final_schema, cols, dicts)


# ---------------------------------------------------------------------------
# top-k ranks
# ---------------------------------------------------------------------------


TOPK_FLOOR = 4096  # ORDER BY ... LIMIT k takes the top-k up to this k over any input
TOPK_SHARE = 8  # above it, while k is at most a shard's row capacity over this


def topk_fits(k: int, capacity: int) -> bool:
    """Whether ORDER BY ... LIMIT k (k counting the OFFSET's rows) takes
    the top-k selection over an input of `capacity` rows a shard: up to
    TOPK_FLOOR whatever the input, above it while k is at most a
    TOPK_SHARE-th of the capacity. On an H100 the selection beats the
    sort up to a whole shard, so the share bounds memory: on a mesh the
    candidates of every shard, k each, meet on the first card, at most
    a TOPK_SHARE-th of the table's rows."""
    return 0 < k <= max(TOPK_FLOOR, capacity // TOPK_SHARE)


def topk_rank(kd: torch.Tensor, kv, sel: torch.Tensor, asc: bool) -> torch.Tensor:
    """int64 rank where the top-k LARGEST ranks are the LIMIT result.
    Tiers (ties break by lowest index = original row order): real keys
    >= min+2 > NULL keys (min+1) > unselected rows (min). The low clamp
    can merge the two most-extreme key values — only observable when both
    land in the result's very tail (as in the JAX package)."""
    from datafusion_tpu_torch.ops.pallas.segreduce import to_sortable_int

    key = kd.to(torch.int8) if kd.dtype == torch.bool else kd
    rank = to_sortable_int(key).to(torch.int64)
    lo = torch.iinfo(torch.int64).min
    # top-k returns the LARGEST first; ascending wants the smallest first —
    # bitwise-not reverses signed-int order exactly
    rank = torch.bitwise_not(rank) if asc else rank
    rank = rank.clamp(min=lo + 2)
    if kv is not None:
        rank = torch.where(kv, rank, lo + 1)  # NULLs last
    return torch.where(sel, rank, lo)


class PlanCompiler:
    DEFAULT_GROUP_CAPACITY = 64 * 1024  # the JAX package's co-sort group capacity (`capacity` only)
    # the direct join's largest domain, as in the JAX package: a small
    # multiple of the build side's capacity, and an absolute guard
    DIRECT_JOIN_DOM_FACTOR = 4
    DIRECT_JOIN_DOM_MAX = 1 << 26

    def __init__(self, tables: dict[str, Table], fn_registry=None, device=None, bigdense: bool = False):
        """`bigdense`: route GROUP BYs of 2,048 to 16,383 slots to the
        radix-partition path (K3 + K4) rather than the packed co-sort."""
        self.tables = tables
        self.fn_registry = fn_registry or {}
        self.device = resolve_device(device)
        self.bigdense = bigdense
        self.scan_tables: list[Table] = []
        self.scan_used: list[set] = []  # per scan slot: the table columns the plan reads
        self.notes: list[str] = []  # physical choices, for EXPLAIN VERBOSE
        self.routes: list[str] = []  # run-time choices of the last run (CompiledQuery.run)
        # decline diagnostics survive speculative rollbacks
        self.sticky_notes: list[str] = []

    def note_decline(self, msg: str) -> None:
        if msg not in self.sticky_notes:
            self.sticky_notes.append(msg)

    def compile(self, e: L.Expr, child: Lowered):
        return compile_expr(e, child.schema, child.dicts, self.fn_registry, self.device)

    def _speculative(self, attempt):
        """Run a lowering attempt that may return None; on None, roll back
        its notes and scan slots so the fallback starts clean."""
        marks = (len(self.notes), len(self.scan_tables))
        res = attempt()
        if res is None:
            del self.notes[marks[0]:]
            del self.scan_tables[marks[1]:]
            del self.scan_used[marks[1]:]
        return res

    # ------------------------------------------------------------------
    def lower(self, plan: L.LogicalPlan) -> Lowered:
        """`plan` lowered, its stage function run inside its span."""
        low = self._named(plan)
        return replace(low, fn=spanned(low.span)(low.fn))

    def _named(self, plan: L.LogicalPlan) -> Lowered:
        """`plan` lowered, with its span's name in `Lowered.span`:
        `dft.node.<Kind>`, and `.<route>` after it where the lowering
        picked a route (`Lowered.route`)."""
        low = self._lower_node(plan)
        kind = f"dft.node.{type(plan).__name__}"
        return replace(low, span=f"{kind}.{low.route}" if low.route else kind, route="")

    def _lower_node(self, plan: L.LogicalPlan) -> Lowered:
        if isinstance(plan, L.TableScan):
            return self._lower_scan(plan)
        if isinstance(plan, L.Selection):
            return self._lower_selection(plan)
        if isinstance(plan, L.Projection):
            return self._lower_projection(plan)
        if isinstance(plan, L.Aggregate):
            return self._aggregate_over(plan, self.lower(plan.input))
        if isinstance(plan, L.Sort):
            return self._lower_sort(plan)
        if isinstance(plan, L.Limit):
            return self._lower_limit(plan)
        if isinstance(plan, L.EmptyRelation):
            return self._lower_empty(plan)
        if isinstance(plan, L.Join):
            return self._lower_join(plan)
        if isinstance(plan, L.Union):
            return self._lower_union(plan)
        if isinstance(plan, L.Window):
            return self._lower_window(plan)
        raise NotImplementedError_(
            f"plan node {type(plan).__name__} is not part of the torch port yet"
        )

    def _lower_empty(self, plan: L.EmptyRelation) -> Lowered:
        # one synthetic row so literal-only projections emit one row
        dev = self.device
        return Lowered(plan.schema, [], lambda env: Batch([], torch.ones(1, dtype=torch.bool, device=dev)), capacity=8)

    def _lower_scan(self, plan: L.TableScan) -> Lowered:
        table = self.tables.get(plan.table_name)
        if table is None:
            raise ExecutionError(f"no table registered as '{plan.table_name}'")
        slot = len(self.scan_tables)
        self.scan_tables.append(table)
        indices = list(range(len(table.schema))) if plan.projection is None else list(plan.projection)
        # a lazy file-backed table (columnar/csv.py LazyCsvTable) parses
        # the scanned columns, in one pass, before any dictionary is read
        ensure = getattr(table, "ensure_columns", None)
        if ensure is not None:
            ensure(indices)
        self.scan_used.append(set(indices))
        n, dev = table.num_rows, self.device

        def fn(env) -> Batch:
            # a shard's env holds its row block only
            rows = next((d.shape[0] for d, _ in env[slot] if d is not None), n)
            return Batch([env[slot][i] for i in indices], torch.ones(rows, dtype=torch.bool, device=dev))

        return Lowered(
            table.schema.project(indices),
            [table.columns[i].dictionary for i in indices],
            fn,
            sources=[(slot, i) for i in indices],
            capacity=ref_capacity(n),
        )

    def _lower_selection(self, plan: L.Selection) -> Lowered:
        return self._selection_over(plan, self.lower(plan.input))

    def _selection_over(self, plan: L.Selection, child: Lowered) -> Lowered:
        pred = self.compile(plan.expr, child)
        if pred.dtype is not DataType.Boolean:
            raise ExecutionError("selection predicate must be boolean")

        def fn(env) -> Batch:
            b = child.fn(env)
            pd, pv = broadcast_col(pred.fn(b.cols), b.capacity)
            keep = pd if pv is None else torch.logical_and(pd, pv)  # NULL -> drop
            return Batch(b.cols, torch.logical_and(b.sel, keep))

        return Lowered(child.schema, child.dicts, fn, child.sources, capacity=child.capacity, bounds=child.bounds)

    # ------------------------------------------------------------------
    @staticmethod
    def _elementwise_safe(e: L.Expr) -> bool:
        """Is this expression a pure per-row map? Dictionary transforms
        (LIKE LUTs, string functions) and UDFs are excluded; K1's opcode
        set (fused_stage.compile_program) is checked after this."""
        if isinstance(e, L.Alias):
            return PlanCompiler._elementwise_safe(e.expr)
        if isinstance(e, L.Column):
            return True
        if isinstance(e, L.Literal):
            return e.value.dtype is not DataType.Utf8
        if isinstance(e, L.BinaryExpr):
            if e.op in (L.Operator.Like, L.Operator.NotLike):
                return False  # a dictionary LUT gather
            cmp_ops = (
                L.Operator.Eq, L.Operator.NotEq, L.Operator.Lt,
                L.Operator.LtEq, L.Operator.Gt, L.Operator.GtEq,
            )

            def side_ok(x: L.Expr) -> bool:
                # a Utf8 literal inside a comparison is a code compare
                if isinstance(x, L.Literal) and x.value.dtype is DataType.Utf8:
                    return e.op in cmp_ops
                return PlanCompiler._elementwise_safe(x)

            return side_ok(e.left) and side_ok(e.right)
        if isinstance(e, (L.Cast, L.IsNull, L.IsNotNull)):
            return PlanCompiler._elementwise_safe(e.expr)
        if isinstance(e, L.Case):
            ok = all(
                PlanCompiler._elementwise_safe(c) and PlanCompiler._elementwise_safe(r)
                for c, r in e.branches
            )
            if e.else_expr is not None:
                ok = ok and PlanCompiler._elementwise_safe(e.else_expr)
            return ok
        if isinstance(e, L.ScalarFunction):
            if e.name.lower() not in SCALAR_FUNCTIONS and not is_date_function(e.name):
                return False
            return all(PlanCompiler._elementwise_safe(a) for a in e.args)
        return False

    def _try_fused_stage(self, plan: L.Projection) -> Optional[Lowered]:
        """Projection[+Selection] directly over a TableScan with only
        elementwise expressions -> ONE kernel pass over the referenced
        input columns (K1, ops/pallas/fused_stage.py). None when the
        pattern, the whitelist or K1's opcode set does not hold."""
        inner = plan.input
        pred_expr: Optional[L.Expr] = None
        if isinstance(inner, L.Selection) and isinstance(inner.input, L.TableScan):
            scan, pred_expr = inner.input, inner.expr
        elif isinstance(inner, L.TableScan):
            scan = inner
        else:
            return None
        exprs = list(plan.exprs)
        computed = [(j, e) for j, e in enumerate(exprs) if not isinstance(e, L.Column)]
        if pred_expr is None and not computed:
            return None  # pure pass-through: nothing to fuse
        checks = [e for _, e in computed] + ([pred_expr] if pred_expr is not None else [])
        if not all(self._elementwise_safe(e) for e in checks):
            return None
        table = self.tables.get(scan.table_name)
        if table is None:
            return None
        child = self._lower_scan(scan)
        schema, dicts = child.schema, child.dicts
        if any(e.get_type(schema) is DataType.Utf8 for _, e in computed):
            return None  # computed Utf8 outputs would need dictionary plumbing
        scanned = [table.columns[i] for i in (
            range(len(table.schema)) if scan.projection is None else scan.projection
        )]
        try:
            program = fs.compile_program(
                schema, dicts, [c.validity is not None for c in scanned],
                pred_expr, [e for _, e in computed], self.fn_registry,
            )
        except fs.Unsupported as why:
            self.note_decline(f"scan+filter+project: fused stage declined ({why})")
            return None
        dev = self.device
        self.notes.append(
            f"scan+filter+project: fused CUDA stage ({len(computed)} computed expr(s)"
            + (", predicate" if pred_expr is not None else "")
            + f", {len(program.inputs)} input col(s) read once, "
            f"{len(program.code)} instructions)"
        )

        def fn(env) -> Batch:
            b = child.fn(env)
            ins = [b.cols[i] for i in program.inputs]
            sel, outs = fs.run_fused(program, [d for d, _ in ins], [v for _, v in ins], b.capacity, dev)
            it = iter(outs)
            cols = [b.cols[e.index] if isinstance(e, L.Column) else next(it) for e in exprs]
            return Batch(cols, b.sel if sel is None else sel)

        child_src = child.src()
        sources = [child_src[e.index] if isinstance(e, L.Column) else None for e in exprs]
        out_dicts = [dicts[e.index] if isinstance(e, L.Column) else None for e in exprs]
        return Lowered(plan.schema, out_dicts, fn, sources, capacity=child.capacity)

    def _lower_projection(self, plan: L.Projection) -> Lowered:
        fused = self._speculative(lambda: self._try_fused_stage(plan))
        if fused is not None:
            return fused
        return self._projection_over(plan, self.lower(plan.input))

    def _projection_over(self, plan: L.Projection, child: Lowered) -> Lowered:
        compiled = [self.compile(e, child) for e in plan.exprs]

        def fn(env) -> Batch:
            b = child.fn(env)
            return Batch([c.fn(b.cols) for c in compiled], b.sel)

        child_src, child_bnd = child.src(), child.bnd()
        sources = [child_src[e.index] if isinstance(e, L.Column) else None for e in plan.exprs]
        bounds = [child_bnd[e.index] if isinstance(e, L.Column) else None for e in plan.exprs]
        return Lowered(plan.schema, [c.dictionary for c in compiled], fn, sources, capacity=child.capacity,
                       bounds=bounds)

    # ------------------------------------------------------------------
    @staticmethod
    def _agg_function(e: L.AggregateFunction) -> tuple[str, float]:
        """An aggregate's function and percentile fraction, as the JAX
        package names them (its compiler.py:1041-1054): DISTINCT COUNT /
        SUM / AVG become `*_distinct`; the planner's
        `percentile[_disc[_desc]]_<q>` carry the fraction."""
        fname = e.name.lower()
        if e.distinct and fname in ("count", "sum", "avg"):
            return f"{fname}_distinct", 0.5
        for base in ("percentile_disc_desc", "percentile_disc", "percentile"):
            if fname.startswith(base + "_"):
                return base, float(fname[len(base) + 1:])
        return fname, 0.5

    def _aggregate_meta(self, plan: L.Aggregate, child: Lowered):
        """The compiled group keys, (function, compiled argument, return
        type, fraction) per aggregate, and the output dictionaries."""
        group_c = [self.compile(e, child) for e in plan.group_exprs]
        agg_meta = []
        for e in plan.aggr_exprs:
            if not isinstance(e, L.AggregateFunction):
                raise ExecutionError(f"expected aggregate function, got {e!r}")
            if len(e.args) != 1:
                raise ExecutionError("aggregate functions take exactly one argument")
            fname, q = self._agg_function(e)
            if fname not in agg_ops.FUNCS:
                raise ExecutionError(f"unknown aggregate function {e.name}")
            agg_meta.append((fname, self.compile(e.args[0], child), e.return_type, q))
        out_dicts = [c.dictionary for c in group_c] + [
            (arg.dictionary if rt is DataType.Utf8 else None) for (_, arg, rt, _) in agg_meta
        ]
        return group_c, agg_meta, out_dicts

    @staticmethod
    def _specs_of(agg_meta, b: Batch) -> list:
        return [agg_ops.AggSpec(name, broadcast_col(arg.fn(b.cols), b.capacity), rt, q)
                for (name, arg, rt, q) in agg_meta]

    @staticmethod
    def _sorted_route_notes(plan: L.Aggregate) -> str:
        """What the sorted route adds for the aggregate family, for EXPLAIN."""
        funcs = [(PlanCompiler._agg_function(e)[0], repr(e.args[0])) for e in plan.aggr_exprs]
        out = ""
        if any(f in agg_ops.PCT_FUNCS for f, _ in funcs):
            out += "; the percentile argument rides the co-sort"
        n_distinct = len({a for f, a in funcs if f in agg_ops.DISTINCT_FUNCS})
        if n_distinct:
            out += f"; {n_distinct} DISTINCT argument(s), one sort within the groups each"
        if any(f in agg_ops.VAR_FUNCS for f, _ in funcs):
            out += "; VAR/STDDEV squared deviations in a second K2 sorted pass"
        return out

    def _aggregate_over(self, plan: L.Aggregate, child: Lowered) -> Lowered:
        group_c, agg_meta, out_dicts = self._aggregate_meta(plan, child)
        dev = self.device

        def specs_of(b: Batch):
            return self._specs_of(agg_meta, b)

        if not group_c:
            def fn0(env) -> Batch:
                b = child.fn(env)
                outs = agg_ops.ungrouped_aggregate(specs_of(b), b.sel)
                cols = [(d.reshape(1), None if v is None else v.reshape(1)) for d, v in outs]
                return Batch(cols, torch.ones(1, dtype=torch.bool, device=dev))

            return Lowered(plan.schema, out_dicts, fn0, capacity=8)

        probe = self._probe_key_domains(group_c, plan.group_exprs, child)
        doms, offs, notes = probe if probe is not None else ([], [], [])
        prod = 0
        if doms:
            prod = 1
            for d in doms:
                prod *= d + 1  # +1 radix per key covers a NULL slot
        dense = 1 <= prod <= agg_ops.DENSE_MAX_GROUPS
        sorted_only = [name for name, _, _, _ in agg_meta if name not in agg_ops.DENSE_FUNCS]
        if dense and sorted_only:
            self.note_decline(f"aggregate: dense sort-free declined ({sorted_only[0].upper()} needs the sorted path)")
            dense = False
        if dense or self._bigdense_ok(plan, prod, agg_meta):
            if dense:
                two = any(name in agg_ops.VAR_FUNCS for name, _, _, _ in agg_meta)
                self.notes.append(f"aggregate: dense sort-free group-by ({' x '.join(notes)})"
                                  + ("; VAR/STDDEV squared deviations in a second K2 dense pass" if two else ""))
                slots_fn = agg_ops.grouped_aggregate_dense
            else:
                self.notes.append(
                    f"aggregate: bigdense radix-partition sort-free group-by ({' x '.join(notes)}, {prod + 1} slots)"
                )
                slots_fn = agg_ops.grouped_aggregate_bigdense

            def fn_slots(env) -> Batch:
                b = child.fn(env)
                keys = [broadcast_col(c.fn(b.cols), b.capacity) for c in group_c]
                okeys, oaggs, ng = slots_fn(keys, specs_of(b), b.sel, doms, offs)
                return Batch(list(okeys) + list(oaggs), torch.ones(ng, dtype=torch.bool, device=dev))

            return Lowered(plan.schema, out_dicts, fn_slots, capacity=min(child.capacity, prod + 1),
                           route="dense" if dense else "bigdense")

        packed = 1 <= prod <= agg_ops.PACKED_MAX_GROUPS
        family = self._sorted_route_notes(plan)
        if packed:
            self.notes.append(f"aggregate: packed-gid co-sort ({' x '.join(notes)}) + segmented reduce{family}")
        else:
            if prod > agg_ops.PACKED_MAX_GROUPS:
                self.note_decline(
                    f"aggregate: packed-gid declined (domain product {prod} > {agg_ops.PACKED_MAX_GROUPS})"
                )
            self.notes.append(f"aggregate: co-sort + segmented reduce{family}")

        def fn(env) -> Batch:
            b = child.fn(env)
            keys = [broadcast_col(c.fn(b.cols), b.capacity) for c in group_c]
            okeys, oaggs, ng = agg_ops.grouped_aggregate(
                keys, specs_of(b), b.sel,
                dense_domain=doms if packed else None, dense_offset=offs if packed else None,
            )
            return Batch(list(okeys) + list(oaggs), torch.ones(ng, dtype=torch.bool, device=dev))

        cap = min(child.capacity, prod + 1 if packed else self.DEFAULT_GROUP_CAPACITY)
        return Lowered(plan.schema, out_dicts, fn, capacity=cap, route="packed" if packed else "cosort")

    def _bigdense_ok(self, plan: L.Aggregate, prod: int, agg_meta) -> bool:
        """The opt-in bigdense gate (`self.bigdense`, fixed when the
        compiler is made). Every key must be probed (`prod` > 0), with
        DENSE_MAX_GROUPS < prod <= BIGDENSE_MAX_GROUPS, and the functions
        are SUM, AVG, COUNT, MIN and MAX. The runtime needs its mask bits
        below SENTINEL and its ops within K4's shared memory; both are
        bounded here, so nothing falls back after this. A decline is
        noted."""
        if not self.bigdense or not agg_ops.DENSE_MAX_GROUPS < prod <= agg_ops.BIGDENSE_MAX_GROUPS:
            return False
        n_ops, n_masks = self._reduce_op_bound(plan)
        id_mod = 1 << prod.bit_length()
        family = [name for name, _, _, _ in agg_meta if name in agg_ops.HOLISTIC_FUNCS]
        why = None
        if family:
            why = f"{family[0].upper()} is not on K3 + K4"
        elif n_ops > part.MAX_OPS:
            why = f"up to {n_ops} reduce ops, K4's shared memory holds {part.MAX_OPS} windows"
        elif id_mod << n_masks > part.SENTINEL:
            why = f"{n_masks} mask bits above id_mod {id_mod} reach SENTINEL"
        if why is not None:
            self.note_decline(f"aggregate: bigdense declined ({why})")
            return False
        return True

    @staticmethod
    def _reduce_op_bound(plan: L.Aggregate) -> tuple[int, int]:
        """Upper bounds, from the plan alone, on the reduce ops and the
        distinct masks of one reduce call of a GROUP BY (`agg_ops._op_list`)."""
        funcs = [PlanCompiler._agg_function(e)[0] for e in plan.aggr_exprs]
        # a column argument is one tensor however often it is used; any
        # other argument is a new tensor (and validity) per aggregate
        args = [e.args[0] if isinstance(e.args[0], L.Column) else i for i, e in enumerate(plan.aggr_exprs)]
        distinct = {a for f, a in zip(funcs, args) if f in agg_ops.DISTINCT_FUNCS}
        n_masks = len(set(args)) + len(distinct)  # DISTINCT counts take their run flags as masks
        ops = set()
        for f, a in zip(funcs, args):
            if f in agg_ops.DISTINCT_FUNCS:
                ops.add(("count_distinct", a))
                if f != "count_distinct":
                    ops.add(("sum_distinct", a))
            elif f not in ("count",) + agg_ops.PCT_FUNCS:
                ops.add(("sum" if f in ("avg",) + agg_ops.VAR_FUNCS else f, a))
        # exists-count + one COUNT per mask + one op per (function, argument)
        return 1 + n_masks + len(ops), n_masks

    def _probe_key_domains(self, group_c, group_exprs, child: Lowered):
        """Per-key (domains, offsets, notes) for the dense/packed GROUP BY
        paths: dictionary vocab sizes, or min/max probes of scanned int
        columns. None when any key fails (the reason is noted)."""
        doms, offs, notes = [], [], []
        for gi, gc in enumerate(group_c):
            if gc.dictionary is not None:
                if len(gc.dictionary) < 1:
                    self.note_decline(f"aggregate: dense/packed declined (key #{gi} has an empty dictionary)")
                    return None
                doms.append(len(gc.dictionary))
                offs.append(0)
                notes.append(f"dict={len(gc.dictionary)}")
                continue
            rng = self._int_key_range(group_exprs[gi], child)
            if rng is None:
                self.note_decline(
                    f"aggregate: dense/packed declined (key #{gi} {gc.dtype.value}: "
                    "no static domain — not a scanned int column)"
                )
                return None
            kmin, kmax = rng
            doms.append(kmax - kmin + 1)
            offs.append(kmin)
            notes.append(f"int[{kmin},{kmax}]")
        return doms, offs, notes

    def _int_key_range(self, gexpr, child: Lowered):
        """min/max of a GROUP BY key that is a pure pass-through of a
        scanned integer column, or that a join bounded
        (`_scanned_int_range`)."""
        e = gexpr.expr if isinstance(gexpr, L.Alias) else gexpr
        if not isinstance(e, L.Column):
            return None
        return self._scanned_int_range(child, e.index)

    def _scanned_int_range(self, child: Lowered, col_idx: int):
        """min/max of the integer column `col_idx` of `child`: the scanned
        column it passes through, read at plan time from the table (a
        filtered-out extreme only widens the range), intersected with the
        bound a join proved for it; the bound alone where the column has
        no scan source. None when neither is known."""
        if not child.schema.fields[col_idx].dtype.is_integer:
            return None
        bound = child.bnd()[col_idx]
        src = child.src()[col_idx]
        if src is None:
            return bound
        tbl = self.scan_tables[src[0]]
        if tbl.num_rows <= 0:
            return None
        kmin, kmax = self._column_range(tbl, src[1])
        if bound is not None:
            kmin, kmax = max(kmin, bound[0]), min(kmax, bound[1])
            if kmax < kmin:
                return None
        return kmin, kmax

    def _column_range(self, tbl, ci: int) -> tuple[int, int]:
        """min and max of column `ci` of a scanned table with rows (two
        host reads); the distributed compiler takes them over every
        process's rows."""
        data = tbl.columns[ci].data
        return int(data.min()), int(data.max())

    def _agreed(self, value: int) -> int:
        """A run-time host decision's value; on a mesh that spans
        processes, the one every process agrees on (parallel/dist.py)."""
        return value

    # ------------------------------------------------------------------
    def _lower_sort(self, plan: L.Sort) -> Lowered:
        return self._sort_over(plan, self.lower(plan.input))

    def _sort_over(self, plan: L.Sort, child: Lowered) -> Lowered:
        keys = [(self.compile(se.expr, child), se.asc, se.nulls_first is True) for se in plan.exprs]
        dev = self.device

        def fn(env) -> Batch:
            b = child.fn(env)
            key_vals = [(c.fn(b.cols), asc, nf) for c, asc, nf in keys]
            cols = sort_ops.sort_batch(key_vals, b.cols, b.sel)
            return Batch(cols, torch.ones(int(b.sel.sum()), dtype=torch.bool, device=dev))

        return Lowered(child.schema, child.dicts, fn, capacity=child.capacity)

    def _lower_limit(self, plan: L.Limit) -> Lowered:
        """LIMIT / OFFSET. Over ORDER BY (NULLS LAST on every key) whose
        k + offset fits the input (`topk_fits`), a top-k selection of the
        first k + offset rows of the sort's order (`_topk_over`) in place
        of the full sort, then the offset's rows masked; else the rows'
        first k after the offset, in their order."""
        off = plan.offset
        if (
            isinstance(plan.input, L.Sort)
            and all(se.nulls_first is not True for se in plan.input.exprs)
            and plan.limit is not None
        ):
            lowered = self._speculative(lambda: self._lower_topk(plan.input, plan.limit + off))
            if lowered is not None:
                nk = len(plan.input.exprs)
                how = "first-key threshold, " if lowered.route == "threshold" else ""
                self.notes.append(
                    f"sort+limit: top-k selection ({how}k={plan.limit + off}, "
                    f"{nk} key{'s' if nk > 1 else ''}, no full sort)"
                )
                return replace(self._skip_rows(lowered, off), route="topk")
        return self._limit_over(self.lower(plan.input), plan.limit, off)

    @staticmethod
    def _limit_over(child: Lowered, k, off: int) -> Lowered:
        def fn(env) -> Batch:
            b = child.fn(env)
            return Batch(b.cols, sort_ops.limit_mask(b.sel, k, off))

        return Lowered(child.schema, child.dicts, fn, capacity=child.capacity)

    @staticmethod
    def _skip_rows(lowered: Lowered, offset: int) -> Lowered:
        """Mask out the first `offset` rows of a compacted (top-k) batch."""
        if not offset:
            return lowered

        def fn(env) -> Batch:
            b = lowered.fn(env)
            iota = torch.arange(b.capacity, device=b.sel.device)
            return Batch(b.cols, torch.logical_and(b.sel, iota >= offset))

        return Lowered(lowered.schema, lowered.dicts, fn, capacity=lowered.capacity)

    def _lower_topk(self, plan: L.Sort, k: int) -> Optional[Lowered]:
        child = self.lower(plan.input)
        return self._topk_over(plan, child, k) if topk_fits(k, child.capacity) else None

    def _topk_over(self, plan: L.Sort, child: Lowered, k: int) -> Lowered:
        """The first k rows of `plan`'s order over `child`'s selected rows,
        compacted: exactly the rows of the full sort (`_sort_over`), in
        its order, ties by the lowest row index.

        One key, or several that pack into one rank (`_packed_rank`): one
        top-k of the rank (`sort_ops.topk_indices`). Otherwise the first
        key's threshold: the k-th smallest of its sort image
        (`sort_ops.sort_operands`, NULLs and unselected rows after every
        value) by one `torch.topk`; the candidates are the selected rows
        whose image is at or before it, every tie of the threshold among
        them, or all selected rows where the threshold is not a value;
        the full sort's own order of the candidates (`sorted_rows`) gives
        the first k. A row left out has an image after the threshold, so
        at least k rows precede it in the full sort; the image ties
        whatever the sort ties (-0.0 and 0.0, every NaN), so no group of
        equal first keys is split. The route is marked "threshold"."""
        dev = self.device
        if len(plan.exprs) == 1:
            se = plan.exprs[0]
            keyc = self.compile(se.expr, child)

            def rank_fn(b: Batch) -> torch.Tensor:
                kd, kv = broadcast_col(keyc.fn(b.cols), b.capacity)
                return topk_rank(kd, kv, b.sel, se.asc)
        else:
            rank_fn = self._packed_rank(plan, child)
        counter = PlanCompiler._topk_over
        if rank_fn is not None:
            def fn(env) -> Batch:
                b = child.fn(env)
                kk = min(k, int(b.sel.sum()))
                idx = sort_ops.topk_indices(rank_fn(b), kk)
                counter.calls += 1
                counter.candidates += kk
                return Batch(sort_ops.gather_rows(b.cols, idx, b.capacity),
                             torch.ones(kk, dtype=torch.bool, device=dev))

            return Lowered(child.schema, child.dicts, fn, capacity=min(k, child.capacity))

        keys = [(self.compile(se.expr, child), se.asc) for se in plan.exprs]
        first, first_asc = keys[0]
        top = torch.iinfo(torch.int64).max

        def fn(env) -> Batch:
            b = child.fn(env)
            n = b.capacity
            cand = b.sel
            if n:
                kd, kv = broadcast_col(first.fn(b.cols), n)
                img = sort_ops.sort_operands(kd, None, first_asc)[0].to(torch.int64)
                live = b.sel if kv is None else torch.logical_and(b.sel, kv)
                img = torch.where(live, img, top)
                thr = torch.topk(img, min(k, n), largest=False, sorted=False).values.max()
                cand = torch.logical_and(b.sel, img <= thr)
            rows = sort_ops.sorted_rows([(c.fn(b.cols), asc) for c, asc in keys], cand)
            counter.calls += 1
            counter.candidates += rows.shape[0]
            rows = rows[:k]
            return Batch(sort_ops.gather_rows(b.cols, rows, n),
                         torch.ones(rows.shape[0], dtype=torch.bool, device=dev))

        return Lowered(child.schema, child.dicts, fn, capacity=min(k, child.capacity), route="threshold")

    def _packed_rank(self, plan: L.Sort, child: Lowered):
        """Multi-key ORDER BY ... LIMIT k via one packed lexicographic
        int64 rank, when every key has a small static domain: dictionary
        codes, probed scanned ints, or narrow fixed-width integers. Each
        key takes ceil(log2(domain+1)) bits holding a code in [1, domain]
        oriented so LARGER = earlier; NULLs take code 0 (NULLS LAST);
        unselected rows rank -1. 62 payload bits."""
        fields = []
        total = 0
        narrow = {
            DataType.Boolean: (2, 0), DataType.Int8: (256, -128), DataType.UInt8: (256, 0),
            DataType.Int16: (65536, -32768), DataType.UInt16: (65536, 0),
        }
        for se in plan.exprs:
            keyc = self.compile(se.expr, child)
            dom_off = None
            if keyc.dictionary is not None:
                if len(keyc.dictionary) >= 1:
                    dom_off = (len(keyc.dictionary), 0)
            else:
                rng = self._int_key_range(se.expr, child)
                if rng is not None and rng[1] >= rng[0]:
                    dom_off = (rng[1] - rng[0] + 1, rng[0])
                else:
                    dom_off = narrow.get(keyc.dtype)
            if dom_off is None:
                return None
            domain, off = dom_off
            w = domain.bit_length()
            total += w
            if total > 62:
                return None
            fields.append((keyc, se.asc, domain, off, w))

        def rank_fn(b: Batch) -> torch.Tensor:
            packed = torch.zeros(b.capacity, dtype=torch.int64, device=b.sel.device)
            shift = total
            for keyc, asc, domain, off, w in fields:
                kd, kv = broadcast_col(keyc.fn(b.cols), b.capacity)
                v = kd.to(torch.int64) - off
                code = ((domain - v) if asc else (v + 1)).clamp(0, domain)
                if kv is not None:
                    code = torch.where(kv, code, 0)  # NULLS LAST
                shift -= w
                packed = packed + (code << shift)
            return torch.where(b.sel, packed, -1)

        return rank_fn

    # ------------------------------------------------------------------
    def _lower_window(self, plan: L.Window) -> Lowered:
        return self._window_over(plan, self.lower(plan.input))

    def _window_key_domain(self, e: L.Expr, c, child: Lowered) -> Optional[tuple[int, int]]:
        """An inclusive range of a window key's selected, valid values, which
        lets the spec sort pack the key into that range's bits: dictionary
        codes, or an integer key's scanned or bounded range
        (`_int_key_range`). None where none is known."""
        if c.dictionary is not None:
            return 0, max(len(c.dictionary) - 1, 0)
        return self._int_key_range(e, child)

    def _window_over(self, plan: L.Window, child: Lowered) -> Lowered:
        """Append one column per window expression (ops/window.py): one
        spec sort per distinct (PARTITION BY, ORDER BY), shared by every
        function over it. Like the JAX package's, the output keeps the
        child's capacity and carries no sources or bounds."""
        specs: list[dict] = []
        spec_index: dict = {}
        metas: list[tuple[int, int]] = []  # per window expr: (spec, call)
        for wf in plan.window_exprs:
            skey = (wf.partition_by, tuple((o.expr, o.asc, o.nulls_first) for o in wf.order_by))
            if skey not in spec_index:
                spec_index[skey] = len(specs)
                part = [self.compile(e, child) for e in wf.partition_by]
                order = [(self.compile(o.expr, child), o.asc, o.nulls_first is True) for o in wf.order_by]
                exprs = list(wf.partition_by) + [o.expr for o in wf.order_by]
                keys = part + [c for c, _, _ in order]
                specs.append({
                    "part": part, "order": order, "calls": [],
                    "domains": [self._window_key_domain(e, c, child) for e, c in zip(exprs, keys)],
                })
            si = spec_index[skey]
            arg_c = self.compile(wf.args[0], child) if wf.args else None
            specs[si]["calls"].append((wf, arg_c))
            metas.append((si, len(specs[si]["calls"]) - 1))

        out_dicts = list(child.dicts)
        for wf, (si, ci) in zip(plan.window_exprs, metas):
            arg_c = specs[si]["calls"][ci][1]
            out_dicts.append(arg_c.dictionary if (wf.return_type is DataType.Utf8 and arg_c is not None) else None)
        passes, folded = [], 0
        for spec in specs:
            keys = spec["part"] + [c for c, _, _ in spec["order"]]
            widths = [window_ops.key_width(_key_dtype(c), dom) for c, dom in zip(keys, spec["domains"])]
            passes.append(len(window_ops.sort_layout(widths)))
            has_order = bool(spec["order"])
            folded += sum(window_ops.whole_partition(window_ops.WindowCall(wf.name, frame=wf.frame), has_order)
                          for wf, _ in spec["calls"])
        self.notes.append(
            f"window: {len(plan.window_exprs)} function(s) over {len(specs)} spec sort(s) "
            f"(stable sort passes per spec: {', '.join(map(str, passes))}"
            + (f"; {folded} whole-partition aggregate(s) on K2 sorted" if folded else "") + ")"
        )

        def fn(env) -> Batch:
            b = child.fn(env)
            results = []
            for spec in specs:
                calls = [
                    window_ops.WindowCall(wf.name, None if arg_c is None else arg_c.fn(b.cols), wf.offset, wf.frame)
                    for wf, arg_c in spec["calls"]
                ]
                results.append(window_ops.window_spec(
                    [c.fn(b.cols) for c in spec["part"]],
                    [(c.fn(b.cols), asc, nf) for c, asc, nf in spec["order"]],
                    calls, b.sel, spec["domains"],
                ))
            new_cols = [results[si][ci] for si, ci in metas]
            return Batch(list(b.cols) + new_cols, b.sel)

        return Lowered(plan.schema, out_dicts, fn, capacity=child.capacity)

    # ------------------------------------------------------------------
    def _lower_union(self, plan: L.Union) -> Lowered:
        return self._union_over(plan, [self.lower(c) for c in plan.inputs])

    def _union_over(self, plan: L.Union, children: list[Lowered]) -> Lowered:
        dicts, concat = self._union_parts(plan, children)

        def fn(env) -> Batch:
            return concat([c.fn(env) for c in children])

        return Lowered(plan.schema, dicts, fn, capacity=sum(c.capacity for c in children))

    def _union_parts(self, plan: L.Union, children: list[Lowered]):
        """UNION ALL: (the output dictionaries, `concat(batches)`), which
        concatenates the children's columns and selections in child order.
        Utf8 columns whose dictionaries differ remap into the sorted merged
        vocabulary; a 0-row child's empty vocabulary maps nothing, its rows
        are padding."""
        ncols = len(plan.schema)
        out_dicts: list[Optional[tuple[str, ...]]] = []
        remaps: list[list[Optional[torch.Tensor]]] = []  # [col][child]
        for j in range(ncols):
            ds = [c.dicts[j] for c in children]
            for_col = [None] * len(children)
            if all(d is None for d in ds):
                out_dicts.append(None)
            elif any(d is None for d in ds):
                raise ExecutionError(f"UNION column {j} mixes Utf8 and numeric")
            elif all(d == ds[0] for d in ds):
                out_dicts.append(ds[0])
            else:
                merged = tuple(sorted(set().union(*ds)))
                out_dicts.append(merged)
                for_col = [
                    torch.as_tensor(np.searchsorted(merged, np.asarray(d, dtype=object).astype(str)),
                                    dtype=torch.int32, device=self.device)
                    for d in ds
                ]
            remaps.append(for_col)

        def concat(bs: list[Batch]) -> Batch:
            cols: list[ColVal] = []
            for j in range(ncols):
                any_valid = any(b.cols[j][1] is not None for b in bs)
                parts_d, parts_v = [], []
                for b, r in zip(bs, remaps[j]):
                    d, v = broadcast_col(b.cols[j], b.capacity)
                    if r is not None:
                        d = torch.zeros_like(d) if r.shape[0] == 0 else r[d.to(torch.int64).clamp(0, r.shape[0] - 1)]
                    parts_d.append(d)
                    if any_valid:
                        parts_v.append(torch.ones(b.capacity, dtype=torch.bool, device=b.sel.device) if v is None
                                       else v)
                cols.append((torch.cat(parts_d), torch.cat(parts_v) if any_valid else None))
            return Batch(cols, torch.cat([b.sel for b in bs]))

        return out_dicts, concat

    # ------------------------------------------------------------------
    def _lower_join(self, plan: L.Join) -> Lowered:
        swapped = self._right_as_left(plan)
        if swapped is not None:
            return self._swap_back(plan, self._lower_join(swapped))
        left, right = self.lower(plan.left), self.lower(plan.right)
        run, meta = self._join_runner(plan, left, right)

        def fn(env) -> Batch:
            return run(left.fn(env), right.fn(env))

        return Lowered(plan.schema, left.dicts + right.dicts, fn, **meta)

    @staticmethod
    def _right_as_left(plan: L.Join) -> Optional[L.Join]:
        """A RIGHT join as the LEFT join with the sides swapped (its
        output columns come right side first); None for other joins."""
        if plan.join_type is not L.JoinType.Right:
            return None
        return L.Join(plan.right, plan.left, tuple((r, l) for l, r in plan.on), L.JoinType.Left,
                      plan.right.schema.join(plan.left.schema))

    @staticmethod
    def _swap_back(plan: L.Join, inner: Lowered) -> Lowered:
        """The swapped LEFT join's columns permuted back to (left...,
        right...)."""
        n_right = len(plan.right.schema)

        def fn(env) -> Batch:
            b = inner.fn(env)
            return Batch(b.cols[n_right:] + b.cols[:n_right], b.sel)

        return Lowered(plan.schema, inner.dicts[n_right:] + inner.dicts[:n_right], fn, capacity=inner.capacity)

    def _direct_join_domain(self, li: int, ri: int, left: Lowered, right: Lowered):
        """(kmin, domain) of the direct join when the build key's value
        domain is known at plan time and small: dictionary codes (the
        merged vocabulary) or a scanned or bounded integer column
        (`_scanned_int_range`). `right` / `ri` name the build side, which
        may be the plan's left side (the swapped direct join). The domain
        is at most DIRECT_JOIN_DOM_FACTOR times the build side's JAX
        capacity and DIRECT_JOIN_DOM_MAX: the JAX package's gate, so the
        port takes the direct join where the JAX package does."""
        ld, rd = left.dicts[li], right.dicts[ri]
        if ld is not None and rd is not None:
            dom = len(ld) if ld == rd else len(set(ld) | set(rd))
            rng = (0, dom - 1) if dom > 0 else None
        elif ld is None and rd is None:
            rng = self._scanned_int_range(right, ri)
        else:
            return None
        if rng is None:
            return None
        dom = rng[1] - rng[0] + 1
        if dom < 1 or dom > min(self.DIRECT_JOIN_DOM_FACTOR * right.capacity, self.DIRECT_JOIN_DOM_MAX):
            return None
        return rng[0], dom

    def _join_key_remaps(self, plan: L.Join, left: Lowered, right: Lowered) -> list:
        """Per key pair: None, or (left map, right map) from each side's
        dictionary codes onto the merged sorted vocabulary, for Utf8 keys
        whose dictionaries differ."""
        remaps = []
        for li, ri in plan.on:
            ld, rd = left.dicts[li], right.dicts[ri]
            if (ld is None) != (rd is None):
                raise ExecutionError("join key type mismatch (Utf8 vs numeric)")
            if ld is None or ld == rd:
                remaps.append(None)
                continue
            merged = sorted(set(ld) | set(rd))
            remaps.append(tuple(
                torch.as_tensor(np.searchsorted(merged, np.asarray(d, dtype=object).astype(str)),
                                dtype=torch.int64, device=self.device)
                for d in (ld, rd)
            ))
        return remaps

    def _join_runner(self, plan: L.Join, left: Lowered, right: Lowered, *, swap_ok: bool = True,
                     direct_ok: bool = True, how: str = ""):
        """The plan-time half of an INNER / LEFT / FULL / cross join: the
        strategy ladder, the note, and the output's metadata. Returns
        (run, meta): `run(lb, rb)` joins a left and a right Batch at run
        time, and `meta` holds the Lowered's sources, bounds and capacity.

        The ladder is the JAX package's retry ladder taken as a decision:
        (1) the direct join, build = right side, when its key domain is
        known (`_direct_join_domain`) and its selected keys are unique;
        (2) for INNER joins (`swap_ok`), the direct join with the left side
        as the build; (3) the sort join. The swapped direct join emits rows
        in the right side's order, every other strategy in the left side's,
        as in the JAX package. The distributed joins (parallel/dist.py)
        take the ladder without (2) or, after a shuffle, only (3), and put
        `how` before it in the note. `run(lb, rb, tail=False)` leaves a
        FULL join's unmatched build rows out and returns (head Batch,
        matched, build_matched) for a caller that appends them itself;
        `run.keys(batch, side)` are the key columns of a left (0) or right
        (1) batch, Utf8 codes mapped onto the merged vocabulary."""
        jt = plan.join_type
        inner, is_full = jt is L.JoinType.Inner, jt is L.JoinType.Full
        keep_unmatched = not inner  # LEFT and FULL; RIGHT arrives swapped
        cross = not plan.on
        dom_u = dom_s = None
        if direct_ok and not is_full and len(plan.on) == 1:
            li0, ri0 = plan.on[0]
            dom_u = self._direct_join_domain(li0, ri0, left, right)
            if inner and swap_ok:
                dom_s = self._direct_join_domain(ri0, li0, right, left)
        remaps = self._join_key_remaps(plan, left, right)
        ladder = [
            f"direct{' (swapped: build=left side)' if swapped else ''} (dense build domain "
            f"[{dom[0]}, {dom[0] + dom[1]}), one scatter + per-column gather)"
            for dom, swapped in ((dom_u, False), (dom_s, True)) if dom is not None
        ]
        ladder.append(
            "sort (" + ("cross join, one constant key; " if cross else "")
            + "stable build sort, searchsorted ranges, repeat_interleave expand"
            + (", unmatched build rows appended" if is_full else "") + ")"
        )
        self.notes.append("join: " + how + "; if build keys repeat, ".join(ladder))
        dev, routes, agreed = self.device, self.routes, self._agreed

        def keys(b: Batch, side: int) -> list:
            out = []
            for pair, remap in zip(plan.on, remaps):
                d, v = broadcast_col(b.cols[pair[side]], b.capacity)
                if remap is not None:
                    m = remap[side]
                    d = m[d.to(torch.int64).clamp(0, max(m.shape[0] - 1, 0))] if m.numel() else d.to(torch.int64)
                out.append((d, v))
            return out

        def run(lb: Batch, rb: Batch, tail: bool = True):
            lk, rk = keys(lb, 0), keys(rb, 1)
            if dom_u is not None:
                bcols, matched, dups = join_ops.direct_index_join(
                    lk[0], lb.sel, rk[0], rb.sel, rb.cols, *dom_u, matched_validity=keep_unmatched
                )
                if not agreed(dups):
                    routes.append("join: direct")
                    return Batch(list(lb.cols) + bcols, lb.sel if keep_unmatched else lb.sel & matched)
            if dom_s is not None:
                lcols, matched, dups = join_ops.direct_index_join(
                    rk[0], rb.sel, lk[0], lb.sel, lb.cols, *dom_s, matched_validity=False
                )
                if not agreed(dups):
                    routes.append("join: direct (swapped: build=left side)")
                    return Batch(lcols + list(rb.cols), rb.sel & matched)
            if cross:  # one shared constant key: every pair matches
                lk = [(torch.zeros(lb.capacity, dtype=torch.int32, device=dev), None)]
                rk = [(torch.zeros(rb.capacity, dtype=torch.int32, device=dev), None)]
            res = join_ops.join_indices(lk, lb.sel, rk, rb.sel, keep_unmatched_probe=keep_unmatched,
                                        want_build_matched=is_full)
            p_idx, b_idx, matched = res[:3]
            routes.append("join: sort")
            pcols = join_ops.gather_columns(lb.cols, p_idx, lb.capacity)
            bcols = join_ops.gather_columns(rb.cols, b_idx, rb.capacity)
            if keep_unmatched:
                bcols = [(d, matched if v is None else v & matched) for d, v in bcols]
            n_out = p_idx.shape[0]
            if is_full:
                if not tail:
                    return Batch(pcols + bcols, torch.ones(n_out, dtype=torch.bool, device=dev)), matched, res[3]
                pcols, bcols, n_out = join_ops.full_merge_tail(pcols, bcols, matched, rb.cols, rb.sel & ~res[3])
            return Batch(pcols + bcols, torch.ones(n_out, dtype=torch.bool, device=dev))

        run.keys = keys
        nl, nr = len(left.schema), len(right.schema)
        if dom_u is not None or dom_s is not None:
            # the first candidate is direct: probe rows stay in place, so
            # the probe side's columns keep their scan sources, and an
            # INNER join's surviving keys lie in the build domain
            dom, swapped = (dom_u, False) if dom_u is not None else (dom_s, True)
            bounds = left.bnd() + (right.bnd() if inner else [None] * nr)
            if inner and remaps[0] is None:
                kb = (dom[0], dom[0] + dom[1] - 1)
                lb0 = bounds[li0]
                bounds[li0] = kb if lb0 is None else (max(kb[0], lb0[0]), min(kb[1], lb0[1]))
                bounds[nl + ri0] = kb
            sources = [None] * nl + right.src() if swapped else left.src() + [None] * nr
            return run, dict(sources=sources, bounds=bounds,
                             capacity=right.capacity if swapped else left.capacity)
        bounds = None
        if inner and not cross:
            # an INNER join's rows are a subset of each side's: the sides'
            # bounds carry over, and a key lies in both sides' ranges
            bounds = left.bnd() + right.bnd()
            for li, ri in plan.on:
                lr, rr = self._scanned_int_range(left, li), self._scanned_int_range(right, ri)
                cand = rr if lr is None else lr if rr is None else (max(lr[0], rr[0]), min(lr[1], rr[1]))
                if cand is not None and cand[0] <= cand[1]:
                    bounds[li] = bounds[nl + ri] = cand
        cap = left.capacity + right.capacity if is_full else max(left.capacity, right.capacity)
        return run, dict(bounds=bounds, capacity=cap)


# ORDER BY ... LIMIT's top-k selections run (on a mesh, one a shard and one
# over the gathered candidates) and the candidate rows they kept, counted
# on the host from shapes it already holds
PlanCompiler._topk_over.calls = 0
PlanCompiler._topk_over.candidates = 0


def compile_plan(
    plan: L.LogicalPlan, tables: dict[str, Table], fn_registry=None, device=None, bigdense: bool = False
) -> CompiledQuery:
    device_plan, host_post = split_host_projection(plan, fn_registry or {})
    pc = PlanCompiler(tables, fn_registry, device, bigdense)
    top = pc.lower(device_plan)
    return CompiledQuery(
        schema=top.schema,
        dicts=top.dicts,
        _fn=top.fn,
        _scan_tables=pc.scan_tables,
        _host_post=host_post,
        notes=tuple(pc.notes + pc.sticky_notes),
        _routes=pc.routes,
        _used_cols=pc.scan_used,
    )
