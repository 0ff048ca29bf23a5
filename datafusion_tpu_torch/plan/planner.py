"""Query planner: SQL AST → LogicalPlan.

Reproduces the reference's planning semantics exactly — clause order,
aggregate detection, supertype coercion, COUNT(1)/COUNT(*) rewrite, UDF
argument coercion (reference: src/sqlplanner.rs:46-375) — and extends it
with JOIN planning and ORDER BY/LIMIT over aggregates, which the
reference left as roadmap items.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Protocol

from datafusion_tpu_torch.errors import InvalidColumnError, PlanError
from datafusion_tpu_torch.schema import Field, Schema
from datafusion_tpu_torch.sql import ast as A
from datafusion_tpu_torch.types import DataType, ScalarValue, can_coerce_from, get_supertype
from datafusion_tpu_torch.plan.logical import (
    Aggregate,
    AggregateFunction,
    Alias,
    BinaryExpr,
    Case,
    Cast,
    Column,
    EmptyRelation,
    Expr,
    IsNotNull,
    IsNull,
    Join,
    JoinType,
    Limit,
    Literal,
    LogicalPlan,
    Operator,
    Projection,
    ScalarFunction,
    Selection,
    Sort,
    SortExpr,
    TableScan,
    Union,
    Window,
    WindowFunction,
    exprlist_to_fields,
)


class FunctionType(enum.Enum):
    Scalar = "Scalar"
    Aggregate = "Aggregate"


@dataclass(frozen=True)
class FunctionMeta:
    """UDF registry entry (reference: logicalplan.rs:25-64)."""

    name: str
    args: tuple[Field, ...]
    return_type: DataType
    function_type: FunctionType


class SchemaProvider(Protocol):
    """Catalog interface the planner resolves against
    (reference: sqlplanner.rs:29-32)."""

    def get_table_meta(self, name: str) -> Optional[Schema]: ...

    def get_function_meta(self, name: str) -> Optional[FunctionMeta]: ...


_AGG_NAMES = {"min", "max", "sum", "avg"}

# sentinel base for HAVING scalar-subquery placeholder columns, remapped
# to real post-aggregate indices once the aggregate schema is known
_HAVING_SUB_BASE = 1_000_000


def _iter_scalar_subs(node):
    """Yield SQLScalarSubquery nodes in an expression tree, NOT
    descending into nested SELECT scopes (they plan their own)."""
    import dataclasses

    if isinstance(node, A.SQLScalarSubquery):
        yield node
        return
    if isinstance(
        node,
        (A.SQLSelect, A.SQLUnion, A.SQLSetOp, A.SQLWith, A.SQLDerivedTable),
    ):
        return
    if isinstance(node, A.SQLInSubquery):
        yield from _iter_scalar_subs(node.expr)
        return
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            vals = getattr(node, f.name)
            vals = vals if isinstance(vals, tuple) else (vals,)
            for v in vals:
                if isinstance(v, A.AstNode):
                    yield from _iter_scalar_subs(v)
                elif isinstance(v, tuple):
                    for w in v:
                        if isinstance(w, A.AstNode):
                            yield from _iter_scalar_subs(w)


def _expr_children_rex(e: Expr) -> tuple:
    """Children of a planned (relational) expression node."""
    if isinstance(e, (Alias, Cast, IsNull, IsNotNull, SortExpr)):
        return (e.expr,)
    if isinstance(e, BinaryExpr):
        return (e.left, e.right)
    if isinstance(e, (ScalarFunction, AggregateFunction, WindowFunction)):
        return tuple(e.args)
    if isinstance(e, Case):
        kids = [x for b in e.branches for x in b]
        if e.else_expr is not None:
            kids.append(e.else_expr)
        return tuple(kids)
    return ()


def _expr_rebuild_rex(e: Expr, f) -> Expr:
    """Rebuild one expression node with children mapped through `f`."""
    if isinstance(e, Alias):
        return Alias(f(e.expr), e.name)
    if isinstance(e, Cast):
        return Cast(f(e.expr), e.data_type)
    if isinstance(e, IsNull):
        return IsNull(f(e.expr))
    if isinstance(e, IsNotNull):
        return IsNotNull(f(e.expr))
    if isinstance(e, BinaryExpr):
        return BinaryExpr(f(e.left), e.op, f(e.right))
    if isinstance(e, ScalarFunction):
        return ScalarFunction(e.name, tuple(f(a) for a in e.args), e.return_type)
    if isinstance(e, Case):
        return Case(
            tuple((f(c), f(r)) for c, r in e.branches),
            None if e.else_expr is None else f(e.else_expr),
        )
    return e

# String functions (beyond the reference): evaluated as host-side
# dictionary-vocabulary transforms + device code-remap LUTs
# (ops/expr_eval.py _compile_string_fn)
_STRING_FN_TYPES = {
    "upper": DataType.Utf8,
    "lower": DataType.Utf8,
    "trim": DataType.Utf8,
    "ltrim": DataType.Utf8,
    "rtrim": DataType.Utf8,
    "reverse": DataType.Utf8,
    "substr": DataType.Utf8,
    "substring": DataType.Utf8,
    "replace": DataType.Utf8,
    "concat": DataType.Utf8,
    "lpad": DataType.Utf8,
    "rpad": DataType.Utf8,
    "left": DataType.Utf8,
    "right": DataType.Utf8,
    "initcap": DataType.Utf8,
    "repeat": DataType.Utf8,
    "split_part": DataType.Utf8,
    "length": DataType.Int32,
    "char_length": DataType.Int32,
    "character_length": DataType.Int32,
    "strpos": DataType.Int32,
    "ascii": DataType.Int32,
}
_STRING_FN_ARITY = {
    "upper": (1, 1), "lower": (1, 1), "trim": (1, 1), "ltrim": (1, 1),
    "rtrim": (1, 1), "reverse": (1, 1), "length": (1, 1),
    "char_length": (1, 1), "character_length": (1, 1),
    "substr": (2, 3), "substring": (2, 3), "replace": (3, 3),
    "concat": (1, 99),
    "lpad": (2, 3), "rpad": (2, 3), "left": (2, 2), "right": (2, 2),
    "initcap": (1, 1), "repeat": (2, 2), "split_part": (3, 3),
    "strpos": (2, 2), "ascii": (1, 1),
}

# multi-argument math built-ins (the generic registry path assumes one
# Float64 argument; these coerce every argument to Float64)
_MATH_FN_ARITY = {
    "power": (2, 2), "pow": (2, 2), "mod": (2, 2), "atan2": (2, 2),
    "round": (1, 2), "trunc": (1, 2),
}


def _aggregates_in(e: Expr) -> list:
    """All AggregateFunction nodes within an expression tree."""
    out: list = []

    def walk(x: Expr) -> None:
        if isinstance(x, AggregateFunction):
            out.append(x)
            return
        if isinstance(x, Alias):
            walk(x.expr)
        elif isinstance(x, BinaryExpr):
            walk(x.left)
            walk(x.right)
        elif isinstance(x, Cast):
            walk(x.expr)
        elif isinstance(x, (IsNull, IsNotNull)):
            walk(x.expr)
        elif isinstance(x, ScalarFunction):
            for a in x.args:
                walk(a)
        elif isinstance(x, Case):
            for c, r in x.branches:
                walk(c)
                walk(r)
            if x.else_expr is not None:
                walk(x.else_expr)

    walk(e)
    return out


def _rewrite_over_aggregate(
    e: Expr, group_exprs, agg_list, n_group: int
) -> Expr:
    """Rewrite an expression planned against the INPUT schema into one
    over the aggregate output: aggregates → their output column, group
    expressions → their group column."""

    def rw(x: Expr) -> Expr:
        if isinstance(x, Column) and x.index >= _HAVING_SUB_BASE:
            return x  # HAVING scalar-subquery placeholder, remapped later
        if isinstance(x, AggregateFunction):
            return Column(n_group + agg_list.index(x))
        for gi, g in enumerate(group_exprs):
            if x == g or x == (g.expr if isinstance(g, Alias) else g):
                return Column(gi)
        if isinstance(x, Alias):
            return Alias(rw(x.expr), x.name)
        if isinstance(x, BinaryExpr):
            return BinaryExpr(rw(x.left), x.op, rw(x.right))
        if isinstance(x, Cast):
            return Cast(rw(x.expr), x.data_type)
        if isinstance(x, ScalarFunction):
            return ScalarFunction(
                x.name, tuple(rw(a) for a in x.args), x.return_type
            )
        if isinstance(x, IsNull):
            return IsNull(rw(x.expr))
        if isinstance(x, IsNotNull):
            return IsNotNull(rw(x.expr))
        if isinstance(x, Case):
            return Case(
                tuple((rw(c), rw(r)) for c, r in x.branches),
                None if x.else_expr is None else rw(x.else_expr),
            )
        if isinstance(x, Literal):
            return x
        if isinstance(x, Column):
            raise PlanError(
                "column reference in an aggregate query must be a "
                "GROUP BY expression"
            )
        return x

    return rw(e)


def _contains_aggregate(e: Expr) -> bool:
    return bool(_aggregates_in(e))


def convert_data_type(type_name: str) -> DataType:
    """SQL type name → logical type (reference: sqlplanner.rs:379-393)."""
    up = type_name.upper()
    mapping = {
        "BOOLEAN": DataType.Boolean,
        "BOOL": DataType.Boolean,
        "TINYINT": DataType.Int8,
        "SMALLINT": DataType.Int16,
        "INT": DataType.Int32,
        "INTEGER": DataType.Int32,
        "BIGINT": DataType.Int64,
        "FLOAT": DataType.Float64,
        "REAL": DataType.Float64,
        "DOUBLE": DataType.Float64,
        "DATE": DataType.Date32,
        "TIMESTAMP": DataType.Timestamp,
        "DATETIME": DataType.Timestamp,
        "CHAR": DataType.Utf8,
        "VARCHAR": DataType.Utf8,
        "TEXT": DataType.Utf8,
        "STRING": DataType.Utf8,
    }
    if up not in mapping:
        raise PlanError(f"Unsupported SQL type {type_name}")
    return mapping[up]


class _CteDef:
    """One WITH-clause entry: its AST, the CTE environment visible at
    its definition point (earlier CTEs only — non-recursive), and a
    schema cache so qualifier resolution doesn't re-plan the body."""

    __slots__ = ("ast", "env", "schema")

    def __init__(self, ast: A.AstNode, env: dict):
        self.ast = ast
        self.env = env
        self.schema: Optional[Schema] = None


class SqlToRel:
    """AST → LogicalPlan translator (reference: SqlToRel, sqlplanner.rs:34)."""

    def __init__(self, schema_provider: SchemaProvider):
        self.schema_provider = schema_provider
        # CTE scope: name → _CteDef (beyond the reference's grammar)
        self._ctes: dict[str, _CteDef] = {}

    # ------------------------------------------------------------------
    def sql_to_rel(self, node: A.AstNode) -> LogicalPlan:
        if isinstance(node, A.SQLSelect):
            return self._plan_select(node)
        if isinstance(node, (A.SQLIdentifier, A.SQLAliasedTable)):
            cte = self._ctes.get(node.name)
            if cte is not None:
                return self._plan_cte(cte)
            schema = self.schema_provider.get_table_meta(node.name)
            if schema is None:
                raise PlanError(f"no schema found for table {node.name}")
            return TableScan("default", node.name, schema, None)
        if isinstance(node, A.SQLDerivedTable):
            return self.sql_to_rel(node.select)
        if isinstance(node, A.SQLJoin):
            return self._plan_join(node)
        if isinstance(node, A.SQLUnion):
            return self._plan_union(node)
        if isinstance(node, A.SQLSetOp):
            return self._plan_setop(node)
        if isinstance(node, A.SQLWith):
            return self._plan_with(node)
        raise PlanError(f"sql_to_rel does not support this relation: {node!r}")

    # ------------------------------------------------------------------
    def _plan_interval_arith(self, node, schema, qualifiers) -> Expr:
        """expr ± INTERVAL 'n' UNIT (beyond the reference).

        Fixed-width units add a constant on the integer image (days for
        DATE, seconds for TIMESTAMP; a sub-day unit promotes DATE to
        TIMESTAMP). YEAR/MONTH are calendar-aware device functions with
        end-of-month clamping (utils/dates.py add_months_*)."""
        if isinstance(node.right, A.SQLInterval):
            base_ast, iv = node.left, node.right
        else:
            if node.op == "Minus":
                raise PlanError("INTERVAL - expr is not defined")
            base_ast, iv = node.right, node.left
        base = self.sql_to_rex(base_ast, schema, qualifiers)
        bt = base.get_type(schema)
        if bt not in (DataType.Date32, DataType.Timestamp):
            raise PlanError(
                "INTERVAL arithmetic requires a DATE or TIMESTAMP operand, "
                f"got {bt!r}"
            )
        n = iv.value if node.op == "Plus" else -iv.value
        if iv.unit in ("YEAR", "MONTH"):
            months = n * 12 if iv.unit == "YEAR" else n
            fname = (
                "add_months_days" if bt is DataType.Date32 else "add_months_seconds"
            )
            return ScalarFunction(
                fname, (base, Literal(ScalarValue.int64(months))), bt
            )
        if bt is DataType.Date32 and iv.unit in ("WEEK", "DAY"):
            days = n * 7 if iv.unit == "WEEK" else n
            return ScalarFunction(
                "date_add_days", (base, Literal(ScalarValue.int64(days))), bt
            )
        # sub-day units promote DATE to TIMESTAMP (midnight base)
        secs_per = {
            "WEEK": 7 * 86400, "DAY": 86400, "HOUR": 3600,
            "MINUTE": 60, "SECOND": 1,
        }[iv.unit]
        if bt is DataType.Date32:
            base = Cast(base, DataType.Timestamp)
        return ScalarFunction(
            "ts_add_seconds",
            (base, Literal(ScalarValue.int64(n * secs_per))),
            DataType.Timestamp,
        )

    def _plan_with(self, node: A.SQLWith) -> LogicalPlan:
        """WITH a AS (...), b AS (...) body — register each CTE with a
        snapshot of the scope at its definition (so b sees a, a does
        not see b; inner WITHs shadow outer names), then plan the body.
        CTE bodies are planned lazily at each reference and inlined —
        a CTE referenced twice appears twice in the plan."""
        saved = self._ctes
        env = dict(saved)
        for name, sub in node.ctes:
            env[name] = _CteDef(sub, dict(env))
        self._ctes = env
        try:
            return self.sql_to_rel(node.body)
        finally:
            self._ctes = saved

    def _plan_cte(self, cte: _CteDef) -> LogicalPlan:
        saved = self._ctes
        self._ctes = cte.env
        try:
            plan = self.sql_to_rel(cte.ast)
        finally:
            self._ctes = saved
        cte.schema = plan.schema
        return plan

    def _cte_schema(self, cte: _CteDef) -> Schema:
        if cte.schema is None:
            self._plan_cte(cte)
        assert cte.schema is not None
        return cte.schema

    # ------------------------------------------------------------------
    def _coerce_setop_sides(
        self, node_left: A.AstNode, node_right: A.AstNode, opname: str
    ) -> tuple[LogicalPlan, LogicalPlan, Schema]:
        """Plan both sides of a set operation and coerce each column
        pair to its supertype; output names come from the left side."""
        left = self.sql_to_rel(node_left)
        right = self.sql_to_rel(node_right)
        ls, rs = left.schema, right.schema
        if len(ls) != len(rs):
            raise PlanError(
                f"{opname} sides have different column counts "
                f"({len(ls)} vs {len(rs)})"
            )
        fields = []
        lcasts: list[Expr] = []
        rcasts: list[Expr] = []
        need_l = need_r = False
        for i in range(len(ls)):
            lt, rt = ls.field(i).dtype, rs.field(i).dtype
            st = get_supertype(lt, rt)
            if st is None:
                raise PlanError(
                    f"{opname} column {i} has no common supertype ({lt!r} vs {rt!r})"
                )
            fields.append(Field(ls.field(i).name, st, True))
            lcasts.append(Column(i).cast_to(st, ls))
            rcasts.append(Column(i).cast_to(st, rs))
            need_l = need_l or st != lt
            need_r = need_r or st != rt
        schema = Schema(fields)
        if need_l:
            left = Projection(tuple(lcasts), left, schema)
        if need_r:
            right = Projection(tuple(rcasts), right, schema)
        return left, right, schema

    def _plan_union(self, node: A.SQLUnion) -> LogicalPlan:
        """UNION [ALL] (beyond the reference). Sides must have equal column
        counts; each column pair coerces to its supertype. Output names
        come from the left side. Plain UNION adds a distinct Aggregate."""
        left, right, schema = self._coerce_setop_sides(node.left, node.right, "UNION")
        plan: LogicalPlan = Union((left, right), schema)
        if not node.all:
            # plain UNION = distinct over all columns (same desugaring as
            # SELECT DISTINCT)
            plan = Aggregate(
                plan, tuple(Column(i) for i in range(len(schema))), (), schema
            )
        return plan

    def _plan_setop(self, node: A.SQLSetOp) -> LogicalPlan:
        """INTERSECT / EXCEPT (beyond the reference), desugared onto
        existing plan nodes:

        * INTERSECT = DISTINCT(left) equi-joined (INNER) to
          DISTINCT(right) on every column, projecting the left columns.
        * EXCEPT = DISTINCT(left) LEFT-joined to DISTINCT(right)
          extended with a constant __setop_mark column; rows whose mark
          is NULL (no match) survive.

        Documented deviation: ANSI treats NULLs as not-distinct in set
        ops (NULL INTERSECT NULL = NULL); our equi-join does not match
        NULL keys, so NULL rows never intersect and always survive
        EXCEPT."""
        left, right, schema = self._coerce_setop_sides(node.left, node.right, node.op)
        n = len(schema)
        allcols = tuple(Column(i) for i in range(n))
        if node.all:
            # bag semantics: number each side's duplicates 1..count via
            # ROW_NUMBER() OVER (PARTITION BY every column), then run the
            # SET operation on (columns..., __rn): INTERSECT ALL keeps
            # min(count_l, count_r) copies, EXCEPT ALL keeps
            # max(count_l - count_r, 0)
            rn = WindowFunction(
                "row_number", (), allcols, (), DataType.Int64
            )
            ext = Schema(
                list(schema.fields) + [Field("__rn", DataType.Int64, False)]
            )
            left = Window(left, (rn,), ext)
            right = Window(right, (rn,), ext)
            schema = ext
            n = n + 1
            allcols = tuple(Column(i) for i in range(n))
        else:
            left = Aggregate(left, allcols, (), schema)
            right = Aggregate(right, allcols, (), schema)
        vis = len(node_vis_schema := Schema(schema.fields[: n - 1]) if node.all else schema)
        vis_cols = tuple(Column(i) for i in range(vis))
        if node.op == "INTERSECT":
            plan: LogicalPlan = Join(
                left,
                right,
                tuple((i, i) for i in range(n)),
                JoinType.Inner,
                schema.join(schema),
            )
            return Projection(vis_cols, plan, node_vis_schema)
        # EXCEPT: mark matched rows via a non-null constant on the right
        mark = Field("__setop_mark", DataType.Int64, True)
        rschema = Schema(list(schema.fields) + [mark])
        right = Projection(
            allcols + (Literal(ScalarValue.int64(1)),), right, rschema
        )
        plan = Join(
            left,
            right,
            tuple((i, i) for i in range(n)),
            JoinType.Left,
            schema.join(rschema),
        )
        plan = Selection(IsNull(Column(2 * n)), plan)
        return Projection(vis_cols, plan, node_vis_schema)

    # ------------------------------------------------------------------
    def _plan_select(self, sel: A.SQLSelect) -> LogicalPlan:
        # each SELECT scope owns its scalar-subquery column map; nested
        # sql_to_rel recursion (derived tables, IN/scalar subqueries)
        # must not clobber the enclosing scope's map
        saved = getattr(self, "_scalar_subs", {})
        saved_w = getattr(self, "_window_cols", {})
        try:
            return self._plan_select_impl(sel)
        finally:
            self._scalar_subs = saved
            self._window_cols = saved_w

    _AGG_FN_NAMES = frozenset(
        {"min", "max", "sum", "avg", "count",
         "stddev", "stddev_samp", "stddev_pop",
         "variance", "var_samp", "var_pop",
         "median", "percentile", "percentile_cont", "percentile_disc",
         "percentile_disc_desc"}
    )

    def _is_agg_fn(self, low: str) -> bool:
        """Is `low` an aggregate function name? Built-ins plus registered
        aggregate UDFs (resolved through the schema provider)."""
        if low in self._AGG_FN_NAMES:
            return True
        fm = self.schema_provider.get_function_meta(low)
        return fm is not None and fm.function_type is FunctionType.Aggregate

    def _plan_select_impl(self, sel: A.SQLSelect) -> LogicalPlan:
        gs = self._rewrite_grouping_sets(sel)
        if gs is not None:
            return self.sql_to_rel(gs)
        rewritten = self._rewrite_grouped_windows(sel)
        if rewritten is not None:
            return self._plan_select(rewritten)
        if sel.relation is not None:
            input_plan = self.sql_to_rel(sel.relation)
            qualifiers = self._relation_qualifiers(sel.relation)
        else:
            input_plan = EmptyRelation(Schema.empty())
            qualifiers = {}
        # `SELECT *` expands to the FROM schema, BEFORE any helper
        # columns appended by subquery rewrites
        star_width = len(input_plan.schema)
        input_plan = self._attach_scalar_subqueries(sel, input_plan, qualifiers)
        input_schema = input_plan.schema

        # WHERE is planned against the scan schema first
        # (reference: sqlplanner.rs:66-73). [NOT] IN (SELECT ...) conjuncts
        # rewrite the FROM relation into semi/anti joins first.
        selection_plan: Optional[LogicalPlan] = None
        if sel.selection is not None:
            extended, residual, extra = self._rewrite_in_subqueries(
                sel.selection, input_plan, input_schema, qualifiers
            )
            pred: Optional[Expr] = (
                self.sql_to_rex(residual, input_schema, qualifiers)
                if residual is not None
                else None
            )
            for e in extra:
                pred = e if pred is None else BinaryExpr(pred, Operator.And, e)
            if pred is not None:
                selection_plan = Selection(pred, extended)
            else:
                # a bare EXISTS(...) lowers entirely to its semi join
                selection_plan = extended

        # window functions evaluate over the WHERE-filtered rows and
        # append helper columns (beyond the reference)
        base_plan = selection_plan if selection_plan is not None else input_plan
        win_plan = self._attach_windows(sel, base_plan, qualifiers)
        if win_plan is not base_plan:
            input_schema = win_plan.schema

        # projection expressions, expanding `*` (reference leaves wildcard
        # unimplemented, sqlplanner.rs:235-239; we expand it)
        proj_exprs: list[Expr] = []
        for e in sel.projection:
            if isinstance(e, A.SQLWildcard):
                proj_exprs.extend(Column(i) for i in range(star_width))
            elif isinstance(e, A.SQLAliasedExpr):
                proj_exprs.append(
                    Alias(self.sql_to_rex(e.expr, input_schema, qualifiers), e.alias)
                )
            else:
                proj_exprs.append(self.sql_to_rex(e, input_schema, qualifiers))

        def _unwrap(e: Expr) -> Expr:
            return e.expr if isinstance(e, Alias) else e

        aggr_aliased = [
            e for e in proj_exprs if isinstance(_unwrap(e), AggregateFunction)
        ]
        aggr_exprs = [_unwrap(e) for e in aggr_aliased]
        if aggr_exprs and getattr(self, "_window_cols", {}):
            raise PlanError(
                "window functions cannot be combined with aggregate "
                "queries yet; aggregate in a derived table first"
            )

        # expressions OVER aggregates (SELECT MAX(b)-MIN(b), ...) take the
        # projection-over-aggregate path — beyond both engines' bare-
        # aggregate handling
        composite = [
            e
            for e in proj_exprs
            if not isinstance(_unwrap(e), AggregateFunction)
            and _contains_aggregate(e)
        ]
        if composite:
            return self._plan_composite_aggregates(
                sel, proj_exprs, input_plan, selection_plan, input_schema, qualifiers
            )

        if sel.having is not None and not aggr_exprs and not sel.group_by:
            # the reference erred here too (sqlplanner.rs:136-140)
            raise PlanError("HAVING requires aggregate functions")

        # GROUP BY without aggregates still groups (dedupes) — and HAVING
        # over it may introduce hidden aggregate columns
        if aggr_exprs or sel.group_by:
            agg_input = selection_plan if selection_plan is not None else input_plan
            group_exprs = [
                self._group_expr(e, proj_exprs, input_schema, qualifiers)
                for e in sel.group_by
            ]
            # output schema = group fields then aggregate fields, in that
            # order regardless of SELECT order (reference: sqlplanner.rs:105-110);
            # aliases keep their names in the schema
            # HAVING may re-state aggregates against the INPUT schema
            # (`HAVING COUNT(v) > 3`) — matching aggregates rewrite to
            # their output column, unmatched ones become hidden extra
            # aggregate columns projected away afterwards. Fallback:
            # resolve against the aggregate output schema (aliases /
            # output names).
            # UNCORRELATED scalar subqueries in HAVING (TPC-H q11's
            # `HAVING SUM(x) > (SELECT SUM(x) * f FROM t)`): plan each
            # standalone, LEFT-join its single row onto the aggregate
            # output, and resolve the subquery node to the appended
            # column (projected away afterwards)
            having_subs: list[tuple] = []
            if sel.having is not None:
                if not hasattr(self, "_scalar_subs"):
                    self._scalar_subs = {}
                for nd in _iter_scalar_subs(sel.having):
                    try:
                        sp = self.sql_to_rel(nd.select)
                    except (PlanError, InvalidColumnError):
                        raise PlanError(
                            "correlated scalar subqueries are not supported "
                            "in HAVING (only self-contained ones)"
                        )
                    if len(sp.schema) != 1:
                        raise PlanError(
                            "scalar subquery must return exactly one column"
                        )
                    # typed sentinel: Cast.get_type never consults the
                    # schema, so planning/coercion of the HAVING expr
                    # works before the final column index is known
                    self._scalar_subs[id(nd)] = Cast(
                        Column(_HAVING_SUB_BASE + len(having_subs)),
                        sp.schema.field(0).dtype,
                    )
                    having_subs.append((nd, Limit(1, sp, sp.schema)))
            having_raw: Optional[Expr] = None
            if sel.having is not None:
                try:
                    cand = self.sql_to_rex(sel.having, input_schema, qualifiers)
                    if _contains_aggregate(cand):
                        having_raw = cand
                except (PlanError, InvalidColumnError):
                    pass
            agg_all = list(aggr_exprs)
            if having_raw is not None:
                for a in _aggregates_in(having_raw):
                    if a not in agg_all:
                        agg_all.append(a)
            hidden = agg_all[len(aggr_exprs):]
            all_fields = list(group_exprs) + list(aggr_aliased) + hidden
            agg_schema = Schema(exprlist_to_fields(all_fields, input_schema))
            plan: LogicalPlan = Aggregate(
                agg_input, tuple(group_exprs), tuple(agg_all), agg_schema
            )
            for k, (_, sp) in enumerate(having_subs):
                plan = Join(
                    plan, sp, (), JoinType.Left, plan.schema.join(sp.schema)
                )

            def _fix_having_subs(e: Expr) -> Expr:
                if isinstance(e, Column) and e.index >= _HAVING_SUB_BASE:
                    return Column(
                        len(agg_schema) + (e.index - _HAVING_SUB_BASE)
                    )
                return _expr_rebuild_rex(e, _fix_having_subs)

            if having_raw is not None:
                plan = Selection(
                    _fix_having_subs(
                        _rewrite_over_aggregate(
                            having_raw, group_exprs, agg_all, len(group_exprs)
                        )
                    ),
                    plan,
                )
            elif sel.having is not None:
                # HAVING = selection over the aggregate output (beyond the
                # reference, which always errored); identifiers resolve
                # against the aggregate schema
                plan = Selection(
                    _fix_having_subs(
                        self.sql_to_rex(sel.having, agg_schema, None)
                    ),
                    plan,
                )
            if hidden or having_subs:
                vis = len(group_exprs) + len(aggr_exprs)
                plan = Projection(
                    tuple(Column(i) for i in range(vis)),
                    plan,
                    Schema(agg_schema.fields[:vis]),
                )
            # ORDER BY / LIMIT over aggregates — beyond the reference, which
            # silently dropped them on this path
            plan = self._plan_order_limit(sel, plan, qualifiers)
            return plan

        proj_input = win_plan
        proj_schema = Schema(exprlist_to_fields(proj_exprs, input_schema))
        if sel.order_by and not sel.distinct:
            # ORDER BY keys prefer the projection output schema
            # (reference: sqlplanner.rs:141); keys NOT in the output plan
            # against the FROM schema as hidden helper columns, sorted,
            # then projected away (beyond the reference — most engines
            # allow ORDER BY over non-selected columns)
            sort_exprs: list[SortExpr] = []
            hidden: list[Expr] = []
            for ob in sel.order_by:
                if isinstance(ob.expr, A.SQLLong):
                    i = ob.expr.value
                    if not 1 <= i <= len(proj_schema):
                        raise PlanError(
                            f"ORDER BY position {i} is out of range "
                            f"(1..{len(proj_schema)})"
                        )
                    key: Expr = Column(i - 1)
                else:
                    # window keys resolve via _window_cols against the
                    # window-extended INPUT schema — always hidden
                    has_win = any(
                        isinstance(n, A.SQLWindowExpr)
                        for n in self._iter_ast(ob.expr)
                    )
                    try:
                        if has_win:
                            raise PlanError("window sort key is hidden")
                        key = self.sql_to_rex(ob.expr, proj_schema, None)
                    except (PlanError, InvalidColumnError):
                        e = self.sql_to_rex(ob.expr, input_schema, qualifiers)
                        key = Column(len(proj_exprs) + len(hidden))
                        hidden.append(e)
                sort_exprs.append(SortExpr(key, ob.asc, ob.nulls_first))
            def apply_limit(p: LogicalPlan) -> LogicalPlan:
                if sel.limit is None and sel.offset is None:
                    return p
                off = 0
                if sel.offset is not None:
                    if not isinstance(sel.offset, A.SQLLong):
                        raise PlanError("OFFSET parameter is not a number")
                    off = sel.offset.value
                lim = None
                if sel.limit is not None:
                    if not isinstance(sel.limit, A.SQLLong):
                        raise PlanError("LIMIT parameter is not a number")
                    lim = sel.limit.value
                return Limit(lim, p, p.schema, off)

            if hidden:
                ext = list(proj_exprs) + hidden
                ext_schema = Schema(exprlist_to_fields(ext, input_schema))
                plan = Projection(tuple(ext), proj_input, ext_schema)
                plan = Sort(tuple(sort_exprs), plan, ext_schema)
                # LIMIT sits directly over the Sort (top-k fusion fires);
                # the hidden sort keys drop afterwards
                plan = apply_limit(plan)
                plan = Projection(
                    tuple(Column(i) for i in range(len(proj_exprs))),
                    plan,
                    proj_schema,
                )
            else:
                plan = Projection(tuple(proj_exprs), proj_input, proj_schema)
                plan = Sort(tuple(sort_exprs), plan, proj_schema)
                plan = apply_limit(plan)
            return plan
        plan = Projection(tuple(proj_exprs), proj_input, proj_schema)
        if sel.distinct:
            # SELECT DISTINCT = group by every output column (beyond the
            # reference; its sqlparser accepted no DISTINCT)
            plan = Aggregate(
                plan,
                tuple(Column(i) for i in range(len(proj_schema))),
                (),
                proj_schema,
            )
        return self._plan_order_limit(sel, plan, qualifiers)

    # scope boundaries: AST walks/transforms never descend into these
    _SCOPE_NODES = (
        A.SQLSelect, A.SQLUnion, A.SQLSetOp, A.SQLWith,
        A.SQLDerivedTable, A.SQLScalarSubquery, A.SQLInSubquery, A.SQLExists,
    )

    def _ast_transform(self, node, fn):
        """Bottom-free structural rewrite: fn(node) may replace a node
        wholesale; otherwise children rebuild recursively. Nested SELECT
        scopes are left untouched."""
        import dataclasses

        new = fn(node)
        if new is not node:
            return new
        if isinstance(node, self._SCOPE_NODES) or not dataclasses.is_dataclass(node):
            return node

        def walk_val(v):
            if isinstance(v, A.AstNode):
                return self._ast_transform(v, fn)
            if isinstance(v, tuple):
                return tuple(walk_val(x) for x in v)
            return v

        kwargs = {
            f.name: walk_val(getattr(node, f.name))
            for f in dataclasses.fields(node)
        }
        return type(node)(**kwargs)

    def _iter_ast(self, node):
        """All nodes in the current SELECT scope (window internals
        included; nested scopes excluded)."""
        import dataclasses

        yield node
        if isinstance(node, self._SCOPE_NODES):
            return

        def walk_val(v):
            if isinstance(v, A.AstNode):
                yield from self._iter_ast(v)
            elif isinstance(v, tuple):
                for x in v:
                    yield from walk_val(x)

        if dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                yield from walk_val(getattr(node, f.name))

    def _rewrite_grouping_sets(self, sel: A.SQLSelect) -> Optional[A.AstNode]:
        """GROUP BY GROUPING SETS / ROLLUP / CUBE (beyond the reference):
        desugar into a UNION ALL of one aggregate leaf per grouping set,

            SELECT <items: in-set group→__gi, out-of-set group→NULL,
                    GROUPING(g)→0/1, agg→__aj>
            FROM (SELECT g AS __gi..., agg AS __aj... FROM ... WHERE ...
                  GROUP BY __gi... HAVING ...) __gs

        wrapped with the original ORDER BY/LIMIT/DISTINCT when present.
        NULL columns unify through the union's supertype (Null, X) = X."""
        if sel.group_sets is None:
            return None
        roots = list(sel.projection) + [ob.expr for ob in sel.order_by]
        for r in roots:
            for n in self._iter_ast(r):
                if isinstance(n, A.SQLWindowExpr):
                    raise PlanError(
                        "window functions cannot be combined with GROUPING "
                        "SETS/ROLLUP/CUBE; aggregate in a derived table first"
                    )
        aggs: list[A.SQLFunction] = []

        def collect(n) -> None:
            if (
                isinstance(n, A.SQLFunction)
                and self._is_agg_fn(n.name.lower())
            ):
                if n not in aggs:
                    aggs.append(n)
                return
            if isinstance(n, self._SCOPE_NODES):
                return
            import dataclasses

            if dataclasses.is_dataclass(n):
                for f in dataclasses.fields(n):
                    v = getattr(n, f.name)
                    vs = v if isinstance(v, tuple) else (v,)
                    for x in vs:
                        if isinstance(x, A.AstNode):
                            collect(x)
                        elif isinstance(x, tuple):
                            for y in x:
                                if isinstance(y, A.AstNode):
                                    collect(y)

        for r in roots:
            collect(r)
        group_alias = {g: f"__g{i}" for i, g in enumerate(sel.group_by)}
        agg_alias = {a: f"__a{j}" for j, a in enumerate(aggs)}

        leaves: list[A.AstNode] = []
        for subset in sel.group_sets:
            inner = A.SQLSelect(
                projection=tuple(
                    A.SQLAliasedExpr(g, group_alias[g]) for g in subset
                )
                + tuple(A.SQLAliasedExpr(a, nm) for a, nm in agg_alias.items()),
                distinct=False,
                relation=sel.relation,
                selection=sel.selection,
                group_by=tuple(
                    A.SQLIdentifier(group_alias[g]) for g in subset
                ),
                having=sel.having,
                order_by=(),
                limit=None,
            )
            in_set = set(group_alias[g] for g in subset)

            def sub(n, in_set=in_set):
                if isinstance(n, A.SQLFunction):
                    if n in agg_alias:
                        return A.SQLIdentifier(agg_alias[n])
                    if n.name.lower() == "grouping" and len(n.args) == 1:
                        g = n.args[0]
                        if g not in group_alias:
                            raise PlanError(
                                "GROUPING() argument must be a GROUP BY "
                                "expression"
                            )
                        return A.SQLLong(
                            0 if group_alias[g] in in_set else 1
                        )
                if n in group_alias:
                    nm = group_alias[n]
                    return (
                        A.SQLIdentifier(nm)
                        if nm in in_set
                        else A.SQLIdentifier("NULL")
                    )
                return n

            def outer_item(e):
                t = self._ast_transform(e, sub)
                if isinstance(e, (A.SQLIdentifier, A.SQLCompoundIdentifier)):
                    return A.SQLAliasedExpr(t, e.name)
                return t

            leaves.append(
                A.SQLSelect(
                    projection=tuple(outer_item(e) for e in sel.projection),
                    distinct=False,
                    relation=A.SQLDerivedTable(inner, "__gs"),
                    selection=None,
                    group_by=(),
                    having=None,
                    order_by=(),
                    limit=None,
                )
            )
        node: A.AstNode = leaves[0]
        for leaf in leaves[1:]:
            node = A.SQLUnion(node, leaf, True)
        if sel.order_by or sel.limit is not None or sel.offset is not None or sel.distinct:
            # ORDER BY keys that match a SELECT item (structurally or by
            # alias) become position ordinals — robust against the
            # per-leaf renaming; other keys resolve by output name
            def order_key(e: A.AstNode) -> A.AstNode:
                for pos, item in enumerate(sel.projection):
                    bare = item.expr if isinstance(item, A.SQLAliasedExpr) else item
                    if e == bare or (
                        isinstance(item, A.SQLAliasedExpr)
                        and isinstance(e, A.SQLIdentifier)
                        and e.name == item.alias
                    ):
                        return A.SQLLong(pos + 1)
                return e

            outer_order = tuple(
                A.SQLOrderByExpr(order_key(ob.expr), ob.asc, ob.nulls_first)
                for ob in sel.order_by
            )
            node = A.SQLSelect(
                projection=(A.SQLWildcard(),),
                distinct=sel.distinct,
                relation=A.SQLDerivedTable(node, "__sets"),
                selection=None,
                group_by=(),
                having=None,
                order_by=outer_order,
                limit=sel.limit,
                offset=sel.offset,
            )
        return node

    def _rewrite_grouped_windows(self, sel: A.SQLSelect) -> Optional[A.SQLSelect]:
        """Window functions combined with GROUP BY / aggregates (beyond
        the reference): desugar into

            SELECT <items, aggregates→__aj, group exprs→__gi>
            FROM (SELECT g AS __gi, agg AS __aj FROM ... WHERE ...
                  GROUP BY ... HAVING ...) __grp
            [ORDER BY ... LIMIT ...]

        so windows evaluate over the aggregate output rows (ANSI order:
        WHERE → GROUP BY → HAVING → window → ORDER BY). Returns the
        rewritten outer SELECT, or None when the query has no windows or
        no grouping (plain paths handle those)."""
        roots = list(sel.projection) + [ob.expr for ob in sel.order_by]
        has_window = False
        aggs: list[A.SQLFunction] = []

        def scan(n, inside_window: bool) -> None:
            nonlocal has_window
            if isinstance(n, A.SQLWindowExpr):
                has_window = True
                for a in n.func.args:
                    scan_tree(a, True)
                for e in n.partition_by:
                    scan_tree(e, True)
                for ob in n.order_by:
                    scan_tree(ob.expr, True)
                return
            if (
                isinstance(n, A.SQLFunction)
                and self._is_agg_fn(n.name.lower())
            ):
                if n not in aggs:
                    aggs.append(n)
                return  # no nested aggregates

        def scan_tree(root, inside_window: bool) -> None:
            import dataclasses

            stack = [root]
            while stack:
                n = stack.pop()
                if isinstance(n, A.SQLWindowExpr) or (
                    isinstance(n, A.SQLFunction)
                    and self._is_agg_fn(n.name.lower())
                ):
                    scan(n, inside_window)
                    continue
                if isinstance(n, self._SCOPE_NODES):
                    continue
                if dataclasses.is_dataclass(n):
                    for f in dataclasses.fields(n):
                        v = getattr(n, f.name)
                        vs = v if isinstance(v, tuple) else (v,)
                        for x in vs:
                            if isinstance(x, A.AstNode):
                                stack.append(x)
                            elif isinstance(x, tuple):
                                stack.extend(
                                    y for y in x if isinstance(y, A.AstNode)
                                )

        for r in roots:
            scan_tree(r, False)
        if not has_window or (not sel.group_by and not aggs):
            return None

        group_alias = {g: f"__g{i}" for i, g in enumerate(sel.group_by)}
        agg_alias = {a: f"__a{j}" for j, a in enumerate(aggs)}
        # qualified and unqualified spellings of the same key match by
        # terminal name (GROUP BY t.a vs SELECT a and vice versa)
        group_by_name: dict[str, str] = {}
        for g, nm in group_alias.items():
            if isinstance(g, (A.SQLIdentifier,)):
                group_by_name.setdefault(g.name, nm)
            elif isinstance(g, A.SQLCompoundIdentifier):
                group_by_name.setdefault(g.name, nm)
        inner_items = tuple(
            A.SQLAliasedExpr(g, nm) for g, nm in group_alias.items()
        ) + tuple(A.SQLAliasedExpr(a, nm) for a, nm in agg_alias.items())
        inner = A.SQLSelect(
            projection=inner_items,
            distinct=False,
            relation=sel.relation,
            selection=sel.selection,
            # group by the __gi aliases so the aggregate output schema
            # carries them (outer references resolve by those names)
            group_by=tuple(A.SQLIdentifier(nm) for nm in group_alias.values()),
            having=sel.having,
            order_by=(),
            limit=None,
        )

        def sub(n):
            if isinstance(n, A.SQLFunction) and n in agg_alias:
                return A.SQLIdentifier(agg_alias[n])
            if n in group_alias:
                return A.SQLIdentifier(group_alias[n])
            if isinstance(n, (A.SQLIdentifier, A.SQLCompoundIdentifier)):
                nm = group_by_name.get(n.name)
                if nm is not None:
                    return A.SQLIdentifier(nm)
            return n

        def outer_item(e):
            t = self._ast_transform(e, sub)
            if t is e or isinstance(e, A.SQLAliasedExpr):
                return t
            # keep the ORIGINAL output name when the substitution renamed
            # an unaliased item (identifier → __g0, SUM(x) → __a0)
            if isinstance(e, (A.SQLIdentifier, A.SQLCompoundIdentifier)):
                return A.SQLAliasedExpr(t, e.name)
            if isinstance(e, A.SQLFunction):
                return A.SQLAliasedExpr(t, e.name)
            return t

        outer_proj = tuple(outer_item(e) for e in sel.projection)
        outer_order = tuple(
            A.SQLOrderByExpr(
                self._ast_transform(ob.expr, sub), ob.asc, ob.nulls_first
            )
            for ob in sel.order_by
        )
        return A.SQLSelect(
            projection=outer_proj,
            distinct=sel.distinct,
            relation=A.SQLDerivedTable(inner, "__grp"),
            selection=None,
            group_by=(),
            having=None,
            order_by=outer_order,
            limit=sel.limit,
            offset=sel.offset,
        )

    def _attach_correlated_scalar(
        self,
        node: A.SQLScalarSubquery,
        plan: LogicalPlan,
        outer_schema: Schema,
        outer_qualifiers,
    ) -> LogicalPlan:
        """Decorrelate (SELECT agg(x) FROM s WHERE s.k = t.k [AND ...]):
        the subquery aggregates GROUP BY its correlation keys and LEFT
        JOINs the outer plan on them — per outer row the scalar is the
        group's aggregate, or NULL when no inner rows match (documented
        deviation: SQL's COUNT over an empty set is 0, here NULL)."""
        sub_sel = node.select
        inner_plan, inner_schema, inner_quals, corr = self._split_correlation(
            sub_sel, "scalar", outer_schema, outer_qualifiers
        )
        if not corr:
            # not actually correlated — re-raise the original plan error
            return self.sql_to_rel(sub_sel) and plan  # pragma: no cover
        if len(sub_sel.projection) != 1:
            raise PlanError("scalar subquery must return exactly one column")
        item = sub_sel.projection[0]
        item = item.expr if isinstance(item, A.SQLAliasedExpr) else item
        expr = self.sql_to_rex(item, inner_schema, inner_quals)
        expr = expr.expr if isinstance(expr, Alias) else expr
        # the projected item may be an EXPRESSION over aggregates
        # (TPC-H q17's `0.2 * AVG(l_quantity)`): collect the aggregate
        # leaves, aggregate them bare, and rewrite the surrounding
        # expression over the joined aggregate columns
        aggs: list[AggregateFunction] = []

        def collect(e: Expr) -> None:
            if isinstance(e, AggregateFunction):
                if e not in aggs:
                    aggs.append(e)
                return
            for c in _expr_children_rex(e):
                collect(c)

        collect(expr)
        if not aggs:
            raise PlanError(
                "a correlated scalar subquery must select an aggregate "
                "(or an expression over aggregates), e.g. "
                "(SELECT MAX(x) FROM s WHERE s.k = t.k)"
            )

        def bare_cols_outside_aggs(e: Expr) -> bool:
            if isinstance(e, AggregateFunction):
                return False
            if isinstance(e, Column):
                return True
            return any(bare_cols_outside_aggs(c) for c in _expr_children_rex(e))

        if bare_cols_outside_aggs(expr):
            raise PlanError(
                "a correlated scalar subquery's SELECT item may only "
                "reference inner columns inside aggregate functions"
            )
        group_cols = tuple(Column(i) for _, i in corr)
        agg_schema = Schema(
            [inner_schema.fields[i] for _, i in corr]
            + exprlist_to_fields(list(aggs), inner_schema)
        )
        inner_plan = Aggregate(inner_plan, group_cols, tuple(aggs), agg_schema)
        base = len(plan.schema)
        on = tuple((o, j) for j, (o, _) in enumerate(corr))
        plan = Join(
            plan, inner_plan, on, JoinType.Left, plan.schema.join(agg_schema)
        )

        def rewrite(e: Expr) -> Expr:
            if isinstance(e, AggregateFunction):
                return Column(base + len(corr) + aggs.index(e))
            return _expr_rebuild_rex(e, rewrite)

        self._scalar_subs[id(node)] = rewrite(expr)
        return plan

    def _split_correlation(
        self,
        sub: A.AstNode,
        what: str,
        outer_schema: Schema,
        outer_qualifiers,
    ) -> tuple[LogicalPlan, Schema, list[tuple[int, int]]]:
        """Shared decorrelation front half for EXISTS and correlated
        scalar subqueries: plan the inner FROM, split the inner WHERE
        into inner-only predicates (kept as a Selection) and outer=inner
        column equalities (returned as (outer col, inner col) pairs).
        Returns (inner plan, inner FROM schema, inner qualifiers,
        correlation pairs)."""
        if not isinstance(sub, A.SQLSelect):
            raise PlanError(f"{what} subquery must be a plain SELECT")
        if sub.group_by or sub.having:
            raise PlanError(
                f"{what} subqueries with GROUP BY/HAVING are not supported; "
                "use a derived table"
            )
        if sub.relation is None:
            raise PlanError(f"{what} subquery needs a FROM clause")
        inner_from = self.sql_to_rel(sub.relation)
        inner_quals = self._relation_qualifiers(sub.relation)
        inner_schema = inner_from.schema

        def conjuncts_of(node):
            out: list[A.AstNode] = []

            def go(n):
                if isinstance(n, A.SQLBinaryExpr) and n.op == "And":
                    go(n.left)
                    go(n.right)
                else:
                    out.append(n)

            go(node)
            return out

        corr: list[tuple[int, int]] = []  # (outer col, inner col)
        local: list[Expr] = []
        if sub.selection is not None:
            for c in conjuncts_of(sub.selection):
                try:
                    local.append(self.sql_to_rex(c, inner_schema, inner_quals))
                    continue
                except (PlanError, InvalidColumnError):
                    pass
                pair = None
                if isinstance(c, A.SQLBinaryExpr) and c.op == "Eq":
                    sides = []
                    for side in (c.left, c.right):
                        try:
                            e = self.sql_to_rex(side, inner_schema, inner_quals)
                            scope = "inner"
                        except (PlanError, InvalidColumnError):
                            e = self.sql_to_rex(side, outer_schema, outer_qualifiers)
                            scope = "outer"
                        e = e.expr if isinstance(e, Cast) else e
                        sides.append((scope, e))
                    scopes = {s for s, _ in sides}
                    if scopes == {"inner", "outer"} and all(
                        isinstance(e, Column) for _, e in sides
                    ):
                        o = next(e for s, e in sides if s == "outer")
                        i = next(e for s, e in sides if s == "inner")
                        pair = (o.index, i.index)
                if pair is None:
                    raise PlanError(
                        f"{what} subquery predicates must be inner-only or "
                        "outer=inner column equalities"
                    )
                corr.append(pair)

        inner_plan: LogicalPlan = inner_from
        if local:
            pred = local[0]
            for e in local[1:]:
                pred = BinaryExpr(pred, Operator.And, e)
            inner_plan = Selection(pred, inner_plan)
        return inner_plan, inner_schema, inner_quals, corr

    def _apply_exists(
        self,
        sub: A.AstNode,
        negated: bool,
        plan: LogicalPlan,
        outer_schema: Schema,
        outer_qualifiers,
    ):
        """Decorrelate [NOT] EXISTS (SELECT ... WHERE <preds>):

        * inner-only predicates stay a Selection over the inner relation
        * outer=inner column equalities become semi/anti-join keys — the
          inner side projects the DISTINCT key columns and joins the
          outer plan (INNER for EXISTS, LEFT + IS NULL for NOT EXISTS)
        * with no correlation the subquery reduces to LIMIT 1 and a
          zero-key (cross) join: one inner row keeps/kills every outer
          row

        Returns (new_plan, extra_exprs). The subquery's SELECT list is
        irrelevant to EXISTS and ignored, as in standard SQL."""
        inner_plan, inner_schema, _, corr = self._split_correlation(
            sub, "EXISTS", outer_schema, outer_qualifiers
        )
        extra: list[Expr] = []
        mark_idx = len(plan.schema)
        if corr:
            proj = tuple(Column(i) for _, i in corr)
            pschema = Schema([inner_schema.fields[i] for _, i in corr])
            inner_plan = Projection(proj, inner_plan, pschema)
            inner_plan = Aggregate(
                inner_plan,
                tuple(Column(j) for j in range(len(corr))),
                (),
                pschema,
            )
            on = tuple((o, j) for j, (o, _) in enumerate(corr))
        else:
            one = Schema([Field("one", DataType.Int64, False)])
            inner_plan = Projection(
                (Literal(ScalarValue.int64(1)),), inner_plan, one
            )
            inner_plan = Limit(1, inner_plan, one)
            on = ()
        jt = JoinType.Left if negated else JoinType.Inner
        plan = Join(plan, inner_plan, on, jt, plan.schema.join(inner_plan.schema))
        if negated:
            extra.append(IsNull(Column(mark_idx)))
        return plan, extra

    def _attach_scalar_subqueries(
        self, sel: A.SQLSelect, input_plan: LogicalPlan, qualifiers
    ) -> LogicalPlan:
        """Extend the FROM relation with one LEFT cross join per scalar
        subquery appearing in the WHERE clause or the SELECT items:

            (SELECT agg FROM ...)  →  LEFT JOIN (sub LIMIT 1) ON <nothing>

        The LIMIT-1 subquery has at most one row, so the cross join keeps
        the outer row count; zero rows leave the appended column NULL on
        every row (SQL's empty-scalar-subquery semantics). Documented
        deviation: a multi-row subquery is truncated to its first row
        instead of raising. The appended columns register in
        self._scalar_subs for sql_to_rex; scopes save/restore the map in
        _plan_select."""
        import dataclasses

        def iter_subs(node):
            if isinstance(node, A.SQLScalarSubquery):
                yield node
                return
            # nested SELECT scopes plan their own scalar subqueries
            if isinstance(node, (A.SQLSelect, A.SQLUnion, A.SQLSetOp, A.SQLWith, A.SQLDerivedTable)):
                return
            if isinstance(node, A.SQLInSubquery):
                yield from iter_subs(node.expr)
                return
            if dataclasses.is_dataclass(node):
                for f in dataclasses.fields(node):
                    vals = getattr(node, f.name)
                    vals = vals if isinstance(vals, tuple) else (vals,)
                    for v in vals:
                        if isinstance(v, A.AstNode):
                            yield from iter_subs(v)
                        elif isinstance(v, tuple):
                            for w in v:
                                if isinstance(w, A.AstNode):
                                    yield from iter_subs(w)

        nodes: list[A.SQLScalarSubquery] = []
        roots = list(sel.projection)
        if sel.selection is not None:
            roots.append(sel.selection)
        for r in roots:
            nodes.extend(iter_subs(r))
        self._scalar_subs = {}
        if not nodes:
            return input_plan
        plan = input_plan
        for node in nodes:
            if id(node) in self._scalar_subs:
                continue
            try:
                sub = self.sql_to_rel(node.select)
            except (PlanError, InvalidColumnError):
                # references to outer columns fail self-contained
                # planning: decorrelate to GROUP BY + LEFT JOIN
                plan = self._attach_correlated_scalar(
                    node, plan, input_plan.schema, qualifiers
                )
                continue
            if len(sub.schema) != 1:
                raise PlanError(
                    f"scalar subquery must return exactly one column, got "
                    f"{len(sub.schema)}"
                )
            sub = Limit(1, sub, sub.schema)
            self._scalar_subs[id(node)] = Column(len(plan.schema))
            plan = Join(
                plan, sub, (), JoinType.Left, plan.schema.join(sub.schema)
            )
        return plan

    _WINDOW_RET = {
        "row_number": DataType.Int64,
        "rank": DataType.Int64,
        "dense_rank": DataType.Int64,
        "ntile": DataType.Int64,
        "percent_rank": DataType.Float64,
        "cume_dist": DataType.Float64,
        "count": DataType.UInt64,
        "avg": DataType.Float64,
    }
    _WINDOW_NAMES = {
        "row_number", "rank", "dense_rank", "ntile", "lag", "lead",
        "percent_rank", "cume_dist", "nth_value",
        "sum", "count", "avg", "min", "max", "first_value", "last_value",
    }

    def _attach_windows(
        self, sel: A.SQLSelect, base_plan: LogicalPlan, qualifiers
    ) -> LogicalPlan:
        """Collect fn() OVER (...) items from the SELECT list into one
        Window plan node appending a column per distinct window
        expression; sql_to_rex resolves each SQLWindowExpr to its
        appended column via self._window_cols."""
        import dataclasses

        def iter_wins(node):
            if isinstance(node, A.SQLWindowExpr):
                yield node
                return
            if isinstance(node, (A.SQLSelect, A.SQLUnion, A.SQLSetOp, A.SQLWith, A.SQLDerivedTable)):
                return
            if dataclasses.is_dataclass(node):
                for f in dataclasses.fields(node):
                    vals = getattr(node, f.name)
                    vals = vals if isinstance(vals, tuple) else (vals,)
                    for v in vals:
                        if isinstance(v, A.AstNode):
                            yield from iter_wins(v)
                        elif isinstance(v, tuple):
                            for w in v:
                                if isinstance(w, A.AstNode):
                                    yield from iter_wins(w)

        nodes: list[A.SQLWindowExpr] = []
        for r in list(sel.projection) + [ob.expr for ob in sel.order_by]:
            nodes.extend(iter_wins(r))
        self._window_cols = {}
        if not nodes:
            return base_plan
        if sel.group_by:
            raise PlanError(
                "window functions cannot be combined with GROUP BY yet; "
                "aggregate in a derived table first"
            )
        schema = base_plan.schema
        wexprs: list[WindowFunction] = []
        key_map: dict[WindowFunction, int] = {}
        for node in nodes:
            wf = self._plan_window(node, schema, qualifiers)
            if wf not in key_map:
                key_map[wf] = len(schema) + len(wexprs)
                wexprs.append(wf)
            self._window_cols[id(node)] = Column(key_map[wf])
        fields = list(schema.fields) + [
            Field(wf.name.upper(), wf.return_type, True) for wf in wexprs
        ]
        return Window(base_plan, tuple(wexprs), Schema(fields))

    def _plan_window(
        self, node: A.SQLWindowExpr, schema: Schema, qualifiers
    ) -> WindowFunction:
        low = node.func.name.lower()
        if low not in self._WINDOW_NAMES:
            raise PlanError(f"'{node.func.name}' is not a window function")
        raw_args = node.func.args
        offset = 1
        if low in ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist"):
            if raw_args:
                raise PlanError(f"{node.func.name}() takes no arguments")
            args: tuple[Expr, ...] = ()
            ret = self._WINDOW_RET[low]
        elif low == "nth_value":
            if (
                len(raw_args) != 2
                or not isinstance(raw_args[1], A.SQLLong)
                or raw_args[1].value < 1
            ):
                raise PlanError(
                    "NTH_VALUE expects (expr, positive integer literal)"
                )
            offset = int(raw_args[1].value)
            arg = self.sql_to_rex(raw_args[0], schema, qualifiers)
            args = (arg,)
            ret = arg.get_type(schema)
        elif low == "ntile":
            if len(raw_args) != 1 or not isinstance(raw_args[0], A.SQLLong):
                raise PlanError("NTILE expects one integer literal argument")
            if raw_args[0].value < 1:
                raise PlanError("NTILE bucket count must be >= 1")
            offset = int(raw_args[0].value)
            args = ()
            ret = self._WINDOW_RET[low]
        elif low in ("lag", "lead"):
            if not 1 <= len(raw_args) <= 2:
                raise PlanError(f"{node.func.name} expects 1-2 arguments")
            arg = self.sql_to_rex(raw_args[0], schema, qualifiers)
            if len(raw_args) == 2:
                if not isinstance(raw_args[1], A.SQLLong):
                    raise PlanError(
                        f"{node.func.name} offset must be an integer literal"
                    )
                offset = int(raw_args[1].value)
            args = (arg,)
            ret = arg.get_type(schema)
        else:  # sum/count/avg/min/max
            if low == "count" and (
                len(raw_args) == 0
                or isinstance(raw_args[0], A.SQLWildcard)
                or (isinstance(raw_args[0], A.SQLLong) and raw_args[0].value == 1)
            ):
                args = ()
                ret = self._WINDOW_RET["count"]
            else:
                if len(raw_args) != 1:
                    raise PlanError(f"{node.func.name} expects one argument")
                arg = self.sql_to_rex(raw_args[0], schema, qualifiers)
                args = (arg,)
                ret = self._WINDOW_RET.get(low, arg.get_type(schema))
        part = tuple(
            self.sql_to_rex(e, schema, qualifiers) for e in node.partition_by
        )
        order = tuple(
            SortExpr(
                self.sql_to_rex(ob.expr, schema, qualifiers),
                ob.asc,
                ob.nulls_first,
            )
            for ob in node.order_by
        )
        frame = node.frame
        if frame is not None:
            if low in (
                "row_number", "rank", "dense_rank", "ntile", "lag", "lead",
                "percent_rank", "cume_dist", "nth_value",
            ):
                raise PlanError(f"{node.func.name} does not accept a ROWS frame")
            if not order:
                raise PlanError("a ROWS frame requires ORDER BY in the window")
            if low in ("min", "max") and frame not in ((None, 0), (None, None)):
                raise PlanError(
                    f"{node.func.name} supports only ROWS BETWEEN UNBOUNDED "
                    "PRECEDING AND CURRENT ROW (running) or UNBOUNDED "
                    "PRECEDING AND UNBOUNDED FOLLOWING (whole partition) "
                    "frames; bounded sliding extremes are not implemented"
                )
        return WindowFunction(low, args, part, order, ret, offset, frame)

    def _rewrite_in_subqueries(
        self,
        where: A.AstNode,
        input_plan: LogicalPlan,
        input_schema: Schema,
        qualifiers,
    ):
        """Rewrite top-level [NOT] IN (SELECT ...) conjuncts of the WHERE
        clause into semi/anti joins against the DISTINCT subquery result:

            x IN (SELECT c ...)     → INNER JOIN (one match per probe, so
                                      the compact join strategy applies)
            x NOT IN (SELECT c ...) → LEFT JOIN + appended-column IS NULL

        Helper columns appended by the joins sit AFTER the original
        schema, so every existing column index stays valid; the final
        projection never references them. Documented deviation from
        three-valued SQL: a NULL in the subquery result does not veto
        NOT IN (we treat it as "no match"), and NULL probe values are
        excluded on both forms via IS NOT NULL.

        Returns (extended_plan, residual_where_ast | None, extra_exprs).
        """

        def split_and(node: A.AstNode, out: list) -> None:
            if isinstance(node, A.SQLBinaryExpr) and node.op == "And":
                split_and(node.left, out)
                split_and(node.right, out)
            else:
                out.append(node)

        def contains_sub(node: A.AstNode) -> bool:
            if isinstance(node, (A.SQLInSubquery, A.SQLExists)):
                return True
            kids = []
            if isinstance(node, A.SQLBinaryExpr):
                kids = [node.left, node.right]
            elif isinstance(node, A.SQLUnary):
                kids = [node.expr]
            return any(contains_sub(k) for k in kids)

        def exists_of(node: A.AstNode):
            """(subselect, negated) when the conjunct is [NOT] EXISTS."""
            if isinstance(node, A.SQLExists):
                return node.select, False
            if (
                isinstance(node, A.SQLUnary)
                and node.op == "Not"
                and isinstance(node.expr, A.SQLExists)
            ):
                return node.expr.select, True
            return None

        conjuncts: list[A.AstNode] = []
        split_and(where, conjuncts)
        if not any(
            isinstance(c, A.SQLInSubquery) or exists_of(c) is not None
            for c in conjuncts
        ):
            if contains_sub(where):
                raise PlanError(
                    "IN (SELECT ...) / EXISTS is only supported as a "
                    "top-level AND conjunct of WHERE (not under OR/NOT)"
                )
            return input_plan, where, []

        plan = input_plan
        extra: list[Expr] = []
        residual: list[A.AstNode] = []
        for c in conjuncts:
            ex = exists_of(c)
            if ex is not None:
                plan, ex_extra = self._apply_exists(
                    ex[0], ex[1], plan, input_schema, qualifiers
                )
                extra.extend(ex_extra)
                continue
            if not isinstance(c, A.SQLInSubquery):
                if contains_sub(c):
                    raise PlanError(
                        "IN (SELECT ...) / EXISTS is only supported as a "
                        "top-level AND conjunct of WHERE (not under OR/NOT)"
                    )
                residual.append(c)
                continue
            outer = self.sql_to_rex(c.expr, input_schema, qualifiers)
            outer = outer.expr if isinstance(outer, Cast) else outer
            if not isinstance(outer, Column):
                raise PlanError(
                    "the left side of IN (SELECT ...) must be a plain column"
                )
            sub = self.sql_to_rel(c.subquery)
            if len(sub.schema) != 1:
                raise PlanError(
                    f"IN subquery must return exactly one column, got "
                    f"{len(sub.schema)}"
                )
            outer_t = input_schema.fields[outer.index].dtype
            sub_t = sub.schema.fields[0].dtype
            if sub_t is not outer_t:
                if not can_coerce_from(outer_t, sub_t):
                    raise PlanError(
                        f"IN subquery type {sub_t} does not coerce to "
                        f"column type {outer_t}; CAST the subquery column"
                    )
                cast_schema = Schema(
                    [Field(sub.schema.fields[0].name, outer_t, True)]
                )
                sub = Projection(
                    (Cast(Column(0), outer_t),), sub, cast_schema
                )
            # DISTINCT: at most one match per probe row — keeps the
            # compact join strategy optimal and output row counts right
            sub = Aggregate(sub, (Column(0),), (), sub.schema)
            jt = JoinType.Left if c.negated else JoinType.Inner
            mark_idx = len(plan.schema)
            plan = Join(
                plan, sub, ((outer.index, 0),), jt, plan.schema.join(sub.schema)
            )
            extra.append(IsNotNull(Column(outer.index)))
            if c.negated:
                extra.append(IsNull(Column(mark_idx)))

        residual_ast: Optional[A.AstNode] = None
        for r in residual:
            residual_ast = (
                r
                if residual_ast is None
                else A.SQLBinaryExpr(residual_ast, "And", r)
            )
        return plan, residual_ast, extra

    def _plan_composite_aggregates(
        self, sel, proj_exprs, input_plan, selection_plan, input_schema, qualifiers
    ) -> LogicalPlan:
        """Plan SELECT items that compute over aggregate results:
        Aggregate(group, uniq_aggs) → Projection(rewritten exprs).
        Output columns follow SELECT order (no group-first quirk here)."""
        agg_input = selection_plan if selection_plan is not None else input_plan
        group_exprs = [
            self._group_expr(e, proj_exprs, input_schema, qualifiers)
            for e in sel.group_by
        ]
        # collect unique aggregates across projection + HAVING
        agg_list: list[AggregateFunction] = []

        def collect(e: Expr) -> None:
            for a in _aggregates_in(e):
                if a not in agg_list:
                    agg_list.append(a)

        for e in proj_exprs:
            collect(e)
        having_rex = None
        if sel.having is not None:
            having_rex = self.sql_to_rex(sel.having, input_schema, qualifiers)
            collect(having_rex)
        if not agg_list:
            raise PlanError("internal: composite path without aggregates")

        all_fields = list(group_exprs) + list(agg_list)
        agg_schema = Schema(exprlist_to_fields(all_fields, input_schema))
        plan: LogicalPlan = Aggregate(
            agg_input, tuple(group_exprs), tuple(agg_list), agg_schema
        )

        n_group = len(group_exprs)

        def rewrite(e: Expr) -> Expr:
            return _rewrite_over_aggregate(e, group_exprs, agg_list, n_group)

        if having_rex is not None:
            plan = Selection(rewrite(having_rex), plan)

        new_exprs = tuple(rewrite(e) for e in proj_exprs)
        proj_schema = Schema(exprlist_to_fields(new_exprs, agg_schema))
        plan = Projection(new_exprs, plan, proj_schema)
        return self._plan_order_limit(sel, plan, qualifiers)

    def _group_expr(
        self, e: A.AstNode, proj_exprs, input_schema: Schema, qualifiers
    ) -> Expr:
        """Plan one GROUP BY item. Beyond the plain input-schema
        expression, accepts a SELECT-list alias (`GROUP BY c` for
        `... AS c`) or a 1-based ordinal (`GROUP BY 1`) — beyond the
        reference."""
        if isinstance(e, A.SQLLong):
            i = e.value
            if not 1 <= i <= len(proj_exprs):
                raise PlanError(
                    f"GROUP BY position {i} is out of range (1..{len(proj_exprs)})"
                )
            return proj_exprs[i - 1]
        if isinstance(e, A.SQLIdentifier):
            try:
                return self.sql_to_rex(e, input_schema, qualifiers)
            except InvalidColumnError:
                for item in proj_exprs:
                    if isinstance(item, Alias) and item.name == e.name:
                        return item
                raise
        return self.sql_to_rex(e, input_schema, qualifiers)

    def _plan_order_limit(
        self, sel: A.SQLSelect, plan: LogicalPlan, qualifiers
    ) -> LogicalPlan:
        # ORDER BY resolves against the projection/aggregate output schema
        # (reference: sqlplanner.rs:141-165); table qualifiers no longer
        # apply at that point — the output columns are unqualified
        if sel.order_by:

            def key_of(ob: A.SQLOrderByExpr) -> SortExpr:
                # ORDER BY <ordinal> — 1-based output-column position
                # (beyond the reference)
                if isinstance(ob.expr, A.SQLLong):
                    i = ob.expr.value
                    if not 1 <= i <= len(plan.schema):
                        raise PlanError(
                            f"ORDER BY position {i} is out of range "
                            f"(1..{len(plan.schema)})"
                        )
                    return SortExpr(Column(i - 1), ob.asc, ob.nulls_first)
                return SortExpr(
                    self.sql_to_rex(ob.expr, plan.schema, None),
                    ob.asc,
                    ob.nulls_first,
                )

            plan = Sort(tuple(key_of(ob) for ob in sel.order_by), plan, plan.schema)
        if sel.limit is not None or sel.offset is not None:
            off = 0
            if sel.offset is not None:
                if not isinstance(sel.offset, A.SQLLong):
                    raise PlanError("OFFSET parameter is not a number")
                off = sel.offset.value
            lim = None
            if sel.limit is not None:
                if not isinstance(sel.limit, A.SQLLong):
                    raise PlanError("LIMIT parameter is not a number")
                lim = sel.limit.value
            plan = Limit(lim, plan, plan.schema, off)
        return plan

    # ------------------------------------------------------------------
    def _relation_qualifiers(self, rel: A.AstNode) -> dict[str, tuple[int, Schema]]:
        """Map table alias/name → (column offset, schema) for compound
        identifier resolution in JOIN queries."""
        out: dict[str, tuple[int, Schema]] = {}

        def walk(node: A.AstNode, offset: int) -> int:
            if isinstance(node, A.SQLDerivedTable):
                schema = self.sql_to_rel(node.select).schema
                out[node.alias] = (offset, schema)
                return offset + len(schema)
            if isinstance(node, (A.SQLIdentifier, A.SQLAliasedTable)):
                cte = self._ctes.get(node.name)
                if cte is not None:
                    schema = self._cte_schema(cte)
                else:
                    schema = self.schema_provider.get_table_meta(node.name)
                if schema is None:
                    raise PlanError(f"no schema found for table {node.name}")
                key = node.alias if isinstance(node, A.SQLAliasedTable) else node.name
                out[key] = (offset, schema)
                return offset + len(schema)
            if isinstance(node, A.SQLJoin):
                offset = walk(node.left, offset)
                return walk(node.right, offset)
            raise PlanError(f"unsupported relation {node!r}")

        walk(rel, 0)
        return out

    def _plan_join(self, node: A.SQLJoin) -> LogicalPlan:
        left = self.sql_to_rel(node.left)
        right = self.sql_to_rel(node.right)
        qualifiers = self._relation_qualifiers(node)
        joined_schema = left.schema.join(right.schema)

        # extract conjunctive equality pairs from the ON expression;
        # non-equality conjuncts become a post-join filter (INNER only —
        # for outer joins a failed residual must still NULL-extend the
        # row, which a post-filter cannot express)
        on_pairs: list[tuple[int, int]] = []
        residual: list[Expr] = []

        def extract(e: A.AstNode) -> None:
            if isinstance(e, A.SQLBinaryExpr) and e.op == "And":
                extract(e.left)
                extract(e.right)
                return
            if isinstance(e, A.SQLBinaryExpr) and e.op == "Eq":
                l = self.sql_to_rex(e.left, joined_schema, qualifiers)
                r = self.sql_to_rex(e.right, joined_schema, qualifiers)
                l = l.expr if isinstance(l, Cast) else l
                r = r.expr if isinstance(r, Cast) else r
                if isinstance(l, Column) and isinstance(r, Column):
                    li, ri = l.index, r.index
                    nleft = len(left.schema)
                    if li < nleft <= ri:
                        on_pairs.append((li, ri - nleft))
                        return
                    if ri < nleft <= li:
                        on_pairs.append((ri, li - nleft))
                        return
            residual.append(self.sql_to_rex(e, joined_schema, qualifiers))

        if node.on is not None:
            extract(node.on)
        # empty on_pairs = CROSS JOIN (every pair; beyond the reference)
        jt = {
            A.JoinKind.Inner: JoinType.Inner,
            A.JoinKind.Left: JoinType.Left,
            A.JoinKind.Right: JoinType.Right,
            A.JoinKind.Full: JoinType.Full,
        }[node.kind]
        plan: LogicalPlan = Join(left, right, tuple(on_pairs), jt, joined_schema)
        if residual:
            if jt is not JoinType.Inner:
                raise PlanError(
                    "non-equality JOIN ON conditions are only supported for "
                    "INNER joins (outer joins must NULL-extend rows whose "
                    "residual fails)"
                )
            pred = residual[0]
            for e in residual[1:]:
                pred = BinaryExpr(pred, Operator.And, e)
            if pred.get_type(joined_schema) is not DataType.Boolean:
                raise PlanError("JOIN ON condition must be boolean")
            plan = Selection(pred, plan)
        return plan

    # ------------------------------------------------------------------
    def sql_to_rex(
        self,
        node: A.AstNode,
        schema: Schema,
        qualifiers: Optional[dict[str, tuple[int, Schema]]] = None,
    ) -> Expr:
        """SQL expression → relational expression with supertype coercion
        (reference: sqlplanner.rs:212-375)."""
        if isinstance(node, A.SQLLong):
            return Literal(ScalarValue.int64(node.value))
        if isinstance(node, A.SQLDouble):
            return Literal(ScalarValue.float64(node.value))
        if isinstance(node, A.SQLString):
            return Literal(ScalarValue.utf8(node.value))
        if isinstance(node, A.SQLDate):
            from datafusion_tpu_torch.utils.dates import parse_iso_date

            try:
                return Literal(ScalarValue.date32(parse_iso_date(node.value)))
            except ValueError as e:
                raise PlanError(f"invalid DATE literal {node.value!r}: {e}")
        if isinstance(node, A.SQLInterval):
            raise PlanError(
                "INTERVAL is only valid added to / subtracted from a DATE "
                "or TIMESTAMP"
            )
        if (
            isinstance(node, A.SQLBinaryExpr)
            and node.op in ("Plus", "Minus")
            and (
                isinstance(node.right, A.SQLInterval)
                or isinstance(node.left, A.SQLInterval)
            )
        ):
            return self._plan_interval_arith(node, schema, qualifiers)
        if isinstance(node, A.SQLTimestamp):
            from datafusion_tpu_torch.utils.dates import parse_iso_timestamp

            try:
                return Literal(
                    ScalarValue.timestamp(parse_iso_timestamp(node.value))
                )
            except ValueError as e:
                raise PlanError(f"invalid TIMESTAMP literal {node.value!r}: {e}")

        if isinstance(node, A.SQLIdentifier):
            if node.name.upper() == "TRUE":
                return Literal(ScalarValue.boolean(True))
            if node.name.upper() == "FALSE":
                return Literal(ScalarValue.boolean(False))
            if node.name.upper() == "NULL":
                return Literal(ScalarValue.null())
            if node.name.upper() in ("CURRENT_DATE", "CURRENT_TIMESTAMP"):
                # evaluated ONCE at planning time (documented: a cached
                # compiled plan re-executes with its planning-time value)
                import time as _time

                now = int(_time.time())
                if node.name.upper() == "CURRENT_DATE":
                    return Literal(ScalarValue.date32(now // 86400))
                return Literal(ScalarValue.timestamp(now))
            return Column(schema.index_of(node.name))

        if isinstance(node, A.SQLCompoundIdentifier):
            if not qualifiers or node.qualifier not in qualifiers:
                raise PlanError(f"unknown table qualifier '{node.qualifier}'")
            offset, tschema = qualifiers[node.qualifier]
            return Column(offset + tschema.index_of(node.name))

        if isinstance(node, A.SQLWildcard):
            raise PlanError(
                "SQL wildcard operator is not supported in this position"
            )

        if isinstance(node, A.SQLScalarSubquery):
            col = getattr(self, "_scalar_subs", {}).get(id(node))
            if col is None:
                raise PlanError(
                    "scalar subqueries are supported in the WHERE clause "
                    "and SELECT items only"
                )
            return col

        if isinstance(node, A.SQLWindowExpr):
            col = getattr(self, "_window_cols", {}).get(id(node))
            if col is None:
                raise PlanError(
                    "window functions are supported in SELECT items only"
                )
            return col

        if isinstance(node, A.SQLCast):
            return Cast(
                self.sql_to_rex(node.expr, schema, qualifiers),
                convert_data_type(node.type_name),
            )

        if isinstance(node, A.SQLIsNull):
            return IsNull(self.sql_to_rex(node.expr, schema, qualifiers))
        if isinstance(node, A.SQLIsNotNull):
            return IsNotNull(self.sql_to_rex(node.expr, schema, qualifiers))

        if isinstance(node, A.SQLUnary):
            if node.op == "Minus":
                inner = node.expr
                if isinstance(inner, A.SQLLong):
                    return Literal(ScalarValue.int64(-inner.value))
                if isinstance(inner, A.SQLDouble):
                    return Literal(ScalarValue.float64(-inner.value))
                # -x  →  0 - x with coercion
                zero = Literal(ScalarValue.int64(0))
                return self._coerced_binary(
                    zero, Operator.Minus, self.sql_to_rex(inner, schema, qualifiers), schema
                )
            if node.op == "Plus":
                return self.sql_to_rex(node.expr, schema, qualifiers)
            if node.op == "Not":
                inner = self.sql_to_rex(node.expr, schema, qualifiers)
                if inner.get_type(schema) is not DataType.Boolean:
                    raise PlanError("NOT requires a boolean expression")
                # desugar: NOT x ⟺ x = false (the reference parsed
                # Operator::Not but never executed it)
                return BinaryExpr(
                    inner, Operator.Eq, Literal(ScalarValue.boolean(False))
                )
            raise PlanError(f"unsupported unary operator {node.op}")

        if isinstance(node, A.SQLBinaryExpr):
            op = Operator[node.op]
            left = self.sql_to_rex(node.left, schema, qualifiers)
            right = self.sql_to_rex(node.right, schema, qualifiers)
            return self._coerced_binary(left, op, right, schema)

        if isinstance(node, A.SQLCase):
            whens: list[tuple[Expr, Expr]] = []
            for c, r in node.whens:
                if node.operand is not None:
                    # simple form: CASE x WHEN v THEN r → x = v
                    cond = self._coerced_binary(
                        self.sql_to_rex(node.operand, schema, qualifiers),
                        Operator.Eq,
                        self.sql_to_rex(c, schema, qualifiers),
                        schema,
                    )
                else:
                    cond = self.sql_to_rex(c, schema, qualifiers)
                    if cond.get_type(schema) is not DataType.Boolean:
                        raise PlanError("CASE WHEN condition must be boolean")
                whens.append((cond, self.sql_to_rex(r, schema, qualifiers)))
            else_e = (
                self.sql_to_rex(node.else_expr, schema, qualifiers)
                if node.else_expr is not None
                else None
            )
            # every result arm coerces to one common supertype
            st = whens[0][1].get_type(schema)
            arms = [r.get_type(schema) for _, r in whens[1:]]
            if else_e is not None:
                arms.append(else_e.get_type(schema))
            for t in arms:
                st2 = get_supertype(st, t)
                if st2 is None:
                    raise PlanError(
                        f"CASE result arms have no common supertype "
                        f"({st!r} vs {t!r})"
                    )
                st = st2
            whens = [(c, r.cast_to(st, schema)) for c, r in whens]
            if else_e is not None:
                else_e = else_e.cast_to(st, schema)
            return Case(tuple(whens), else_e)

        if isinstance(node, A.SQLFunction):
            return self._plan_function(node, schema, qualifiers)

        raise PlanError(f"Unsupported ast node {node!r} in sqltorel")

    def _coerced_binary(
        self, left: Expr, op: Operator, right: Expr, schema: Schema
    ) -> Expr:
        """Cast both sides to their supertype (reference: sqlplanner.rs:284-299)."""
        lt = left.get_type(schema)
        rt = right.get_type(schema)
        # convenience: a Utf8 literal compared against a Date32 column
        # parses as a DATE literal (d > '2024-01-01')
        if lt is DataType.Date32 and rt is DataType.Utf8 and isinstance(right, Literal):
            from datafusion_tpu_torch.utils.dates import parse_iso_date

            right = Literal(ScalarValue.date32(parse_iso_date(right.value.value)))
            rt = DataType.Date32
        elif rt is DataType.Date32 and lt is DataType.Utf8 and isinstance(left, Literal):
            from datafusion_tpu_torch.utils.dates import parse_iso_date

            left = Literal(ScalarValue.date32(parse_iso_date(left.value.value)))
            lt = DataType.Date32
        st = get_supertype(lt, rt)
        if st is None:
            raise PlanError(
                f"No common supertype found for binary operator {op.value} "
                f"with input types {lt!r} and {rt!r}"
            )
        return BinaryExpr(left.cast_to(st, schema), op, right.cast_to(st, schema))

    def _plan_function(
        self, node: A.SQLFunction, schema: Schema, qualifiers
    ) -> Expr:
        name = node.name
        low = name.lower()
        if node.distinct and low not in ("count", "sum", "avg", "min", "max"):
            raise PlanError(
                f"DISTINCT is not supported with {name} "
                "(COUNT/SUM/AVG/MIN/MAX only)"
            )
        if low == "coalesce":
            # COALESCE(a, b, ...) desugars onto CASE: first non-NULL arg
            # (beyond the reference)
            args = [self.sql_to_rex(a, schema, qualifiers) for a in node.args]
            if not args:
                raise PlanError("COALESCE expects at least one argument")
            st = args[0].get_type(schema)
            for a in args[1:]:
                st2 = get_supertype(st, a.get_type(schema))
                if st2 is None:
                    raise PlanError(
                        f"COALESCE arguments have no common supertype "
                        f"({st!r} vs {a.get_type(schema)!r})"
                    )
                st = st2
            args = [a.cast_to(st, schema) for a in args]
            branches = tuple((IsNotNull(a), a) for a in args[:-1])
            return Case(branches, args[-1]) if branches else args[-1]
        if low == "nullif":
            # NULLIF(a, b): NULL when a = b IS TRUE, else a. Ordered CASE
            # arms keep it null-aware (NULLIF(x, NULL) = x) without
            # three-valued OR (beyond the reference).
            if len(node.args) != 2:
                raise PlanError("NULLIF expects exactly two arguments")
            a = self.sql_to_rex(node.args[0], schema, qualifiers)
            b = self.sql_to_rex(node.args[1], schema, qualifiers)
            neq = self._coerced_binary(a, Operator.NotEq, b, schema)
            return Case(
                ((IsNull(a), a), (IsNull(b), a), (neq, a)), None
            )
        if low in (
            "year", "month", "day", "hour", "minute", "second",
            "dow", "doy", "quarter", "week", "epoch",
        ):
            args = tuple(self.sql_to_rex(a, schema, qualifiers) for a in node.args)
            ok_types = (
                (DataType.Timestamp,)
                if low in ("hour", "minute", "second")
                else (DataType.Date32, DataType.Timestamp)
            )
            if len(args) != 1 or args[0].get_type(schema) not in ok_types:
                want = " or ".join(t.value for t in ok_types)
                raise PlanError(f"{name} expects one {want} argument")
            ret = DataType.Int64 if low == "epoch" else DataType.Int32
            return ScalarFunction(low, args, ret)
        if low == "now" and not node.args:
            import time as _time

            return Literal(ScalarValue.timestamp(int(_time.time())))
        if low == "date_trunc":
            # DATE_TRUNC('unit', expr) — unit resolves at plan time
            if len(node.args) != 2 or not isinstance(node.args[0], A.SQLString):
                raise PlanError(
                    "DATE_TRUNC expects (unit string literal, DATE/TIMESTAMP)"
                )
            unit = node.args[0].value.lower()
            arg = self.sql_to_rex(node.args[1], schema, qualifiers)
            at = arg.get_type(schema)
            day_units = ("year", "quarter", "month", "week", "day")
            ts_units = day_units + ("hour", "minute", "second")
            if at is DataType.Date32:
                if unit not in day_units:
                    raise PlanError(
                        f"DATE_TRUNC unit {unit!r} needs a TIMESTAMP argument"
                    )
            elif at is DataType.Timestamp:
                if unit not in ts_units:
                    raise PlanError(f"unsupported DATE_TRUNC unit {unit!r}")
            else:
                raise PlanError("DATE_TRUNC expects a DATE or TIMESTAMP argument")
            return ScalarFunction(f"date_trunc_{unit}", (arg,), at)
        if low in _STRING_FN_TYPES:
            args = tuple(self.sql_to_rex(a, schema, qualifiers) for a in node.args)
            lo_n, hi_n = _STRING_FN_ARITY[low]
            if not (lo_n <= len(args) <= hi_n):
                raise PlanError(
                    f"function '{name}' expects "
                    + (f"{lo_n}" if lo_n == hi_n else f"{lo_n}-{hi_n}")
                    + f" argument(s), got {len(args)}"
                )
            if not any(a.get_type(schema) is DataType.Utf8 for a in args):
                raise PlanError(f"function '{name}' expects a string argument")
            return ScalarFunction(name, args, _STRING_FN_TYPES[low])
        if low in ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop"):
            # First-class two-pass aggregates (beyond the reference): the
            # kernel computes the per-group mean, then sums squared
            # deviations — numerically stable where the single-pass
            # E[x²]−E[x]² form catastrophically cancels when stddev ≪
            # mean (critical on TPU where f64 physically runs as f32).
            # Sample variants yield NULL for n ≤ 1 (ANSI).
            if len(node.args) != 1:
                raise PlanError(f"{name} expects a single argument")
            x = self.sql_to_rex(node.args[0], schema, qualifiers)
            at = x.get_type(schema)
            if at in (
                DataType.Utf8, DataType.Boolean, DataType.Date32, DataType.Timestamp
            ):
                raise PlanError(f"{name} is not defined for {at!r} values")
            xf = x.cast_to(DataType.Float64, schema)
            canonical = {
                "stddev": "stddev_samp",
                "variance": "var_samp",
            }.get(low, low)
            return AggregateFunction(canonical, (xf,), DataType.Float64)
        if low in _MATH_FN_ARITY:
            lo_n, hi_n = _MATH_FN_ARITY[low]
            raw = [self.sql_to_rex(a, schema, qualifiers) for a in node.args]
            if not (lo_n <= len(raw) <= hi_n):
                raise PlanError(
                    f"function '{name}' expects "
                    + (f"{lo_n}" if lo_n == hi_n else f"{lo_n}-{hi_n}")
                    + f" argument(s), got {len(raw)}"
                )
            args = tuple(a.cast_to(DataType.Float64, schema) for a in raw)
            return ScalarFunction(
                "power" if low == "pow" else low, args, DataType.Float64
            )
        if low in (
            "median", "percentile", "percentile_cont",
            "percentile_disc", "percentile_disc_desc",
        ):
            q = 0.5
            nargs = node.args
            if low != "median":
                if len(nargs) != 2 or not isinstance(nargs[1], (A.SQLDouble, A.SQLLong)):
                    raise PlanError(
                        f"{name} expects (expr, fraction literal)"
                    )
                q = float(nargs[1].value)
                if not 0.0 <= q <= 1.0:
                    raise PlanError("percentile fraction must be in [0, 1]")
                nargs = nargs[:1]
            arg = self.sql_to_rex(nargs[0], schema, qualifiers)
            at = arg.get_type(schema)
            if not at.is_numeric:
                raise PlanError(f"{name} is not defined for {at!r} values")
            if low == "median":
                fname = "median"
            elif low == "percentile_disc_desc":
                fname = f"percentile_disc_desc_{q!r}"
            elif low == "percentile_disc":
                fname = f"percentile_disc_{q!r}"
            else:
                fname = f"percentile_{q!r}"
            return AggregateFunction(fname, (arg,), DataType.Float64)
        if low in _AGG_NAMES:
            args = tuple(self.sql_to_rex(a, schema, qualifiers) for a in node.args)
            if len(args) != 1:
                raise PlanError(f"{name} expects a single argument")
            at = args[0].get_type(schema)
            if low in ("sum", "avg"):
                # SUM/AVG require a numeric argument. The reference's
                # planner lets any type through (sqlplanner.rs:317) but
                # its runtime dispatch has no Utf8/Boolean arm in
                # array_sum (aggregate.rs:344-546) so it ERRORS there;
                # we match that outcome at plan time rather than ever
                # fabricating a value.
                if not at.is_numeric and at is not DataType.Null:
                    kindname = {
                        DataType.Date32: "DATE",
                        DataType.Timestamp: "TIMESTAMP",
                        DataType.Utf8: "VARCHAR",
                        DataType.Boolean: "BOOLEAN",
                    }.get(at, repr(at))
                    raise PlanError(f"{name} is not defined for {kindname} values")
            # return type = argument type (reference: sqlplanner.rs:317)
            # MIN/MAX(DISTINCT x) = MIN/MAX(x); SUM/AVG keep the flag
            distinct = node.distinct and low in ("sum", "avg")
            return AggregateFunction(name, args, at, distinct)
        if low == "count":
            args = tuple(
                Column(0)
                if isinstance(a, (A.SQLWildcard,)) or (isinstance(a, A.SQLLong) and a.value == 1)
                else self.sql_to_rex(a, schema, qualifiers)
                for a in node.args
            )
            return AggregateFunction(name, args, DataType.UInt64, node.distinct)
        fm = self.schema_provider.get_function_meta(low)
        if fm is None:
            raise PlanError(f"Invalid function '{name}'")
        raw = [self.sql_to_rex(a, schema, qualifiers) for a in node.args]
        if len(raw) != len(fm.args):
            raise PlanError(
                f"function '{name}' expects {len(fm.args)} argument(s), got {len(raw)}"
            )
        safe = tuple(
            raw[i].cast_to(fm.args[i].dtype, schema) for i in range(len(raw))
        )
        if fm.function_type is FunctionType.Aggregate:
            # desugar onto the map/combine/finalize monoid the UDAF was
            # registered as (ops/functions.py AggregateUDF): the plan is
            # ordinary SUM/MIN/MAX + COUNT wrapped in registered scalar
            # hooks, so grouped, pallas-dense, AND distributed
            # partial+merge execution all work unchanged
            udf = getattr(self.schema_provider, "get_aggregate_udf", lambda n: None)(
                low
            )
            if udf is None:
                # planner-only providers (no implementation attached):
                # keep the bare node for plan goldens/serialization
                return AggregateFunction(name, safe, fm.return_type)
            f64 = DataType.Float64
            mapped: Expr = (
                ScalarFunction(f"{low}__map", safe, f64)
                if udf.map_fn is not None
                else safe[0].cast_to(f64, schema)
            )
            combined: Expr = AggregateFunction(udf.combine, (mapped,), f64)
            if udf.finalize_fn is None:
                return (
                    combined
                    if fm.return_type is f64
                    else Cast(combined, fm.return_type)
                )
            cnt = Cast(
                AggregateFunction("count", (safe[0],), DataType.UInt64), f64
            )
            return ScalarFunction(
                f"{low}__finalize", (combined, cnt), fm.return_type
            )
        return ScalarFunction(name, safe, fm.return_type)
