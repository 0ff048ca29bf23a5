"""Logical plan IR: relational expressions and plan nodes.

Reproduces the reference's IR surface (reference: src/logicalplan.rs —
`Expr` enum :136-167, `LogicalPlan` enum :311-348, Debug pretty-printer
:366-443 whose output is the planner-golden-test format) and adds the
`Join` node the reference only roadmapped (ROADMAP.md:33).

Plans are immutable values; `to_json`/`from_json` give the serializable
form the reference intended for shipping plans to workers
(logicalplan.rs:310 serde derives).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Union

from datafusion_tpu_torch.errors import PlanError
from datafusion_tpu_torch.schema import Field, Schema
from datafusion_tpu_torch.types import DataType, ScalarValue, can_coerce_from, get_supertype


class Operator(enum.Enum):
    """Binary operators (reference: logicalplan.rs:67-84). Debug names
    match Rust's derived Debug — planner goldens print them verbatim."""

    Eq = "Eq"
    NotEq = "NotEq"
    Lt = "Lt"
    LtEq = "LtEq"
    Gt = "Gt"
    GtEq = "GtEq"
    Plus = "Plus"
    Minus = "Minus"
    Multiply = "Multiply"
    Divide = "Divide"
    Modulus = "Modulus"
    And = "And"
    Or = "Or"
    Not = "Not"
    Like = "Like"
    NotLike = "NotLike"

    def __repr__(self) -> str:
        return self.value

    @property
    def is_comparison(self) -> bool:
        return self in (
            Operator.Eq,
            Operator.NotEq,
            Operator.Lt,
            Operator.LtEq,
            Operator.Gt,
            Operator.GtEq,
        )

    @property
    def is_boolean(self) -> bool:
        return self in (Operator.And, Operator.Or, Operator.Not)


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class Expr:
    """Base class for relational expressions (reference: logicalplan.rs:136)."""

    # ---- typing ----------------------------------------------------------
    def get_type(self, schema: Schema) -> DataType:
        """Result type of this expression against `schema`
        (reference: logicalplan.rs:170-198)."""
        raise NotImplementedError

    def cast_to(self, target: DataType, schema: Schema) -> "Expr":
        """Wrap in a Cast if needed; error if lossy
        (reference: logicalplan.rs:200-215)."""
        this = self.get_type(schema)
        if this == target:
            return self
        if can_coerce_from(target, this):
            return Cast(self, target)
        raise PlanError(f"Cannot automatically convert {this!r} to {target!r}")

    # ---- builder sugar (reference: logicalplan.rs:217-264) ---------------
    def eq(self, other: "Expr") -> "Expr":
        return BinaryExpr(self, Operator.Eq, other)

    def not_eq(self, other: "Expr") -> "Expr":
        return BinaryExpr(self, Operator.NotEq, other)

    def gt(self, other: "Expr") -> "Expr":
        return BinaryExpr(self, Operator.Gt, other)

    def gt_eq(self, other: "Expr") -> "Expr":
        return BinaryExpr(self, Operator.GtEq, other)

    def lt(self, other: "Expr") -> "Expr":
        return BinaryExpr(self, Operator.Lt, other)

    def lt_eq(self, other: "Expr") -> "Expr":
        return BinaryExpr(self, Operator.LtEq, other)


@dataclass(frozen=True, repr=False)
class Column(Expr):
    """Column reference by ordinal (reference: Expr::Column)."""

    index: int

    def get_type(self, schema: Schema) -> DataType:
        return schema.field(self.index).dtype

    def __repr__(self) -> str:
        return f"#{self.index}"


@dataclass(frozen=True, repr=False)
class Literal(Expr):
    value: ScalarValue

    def get_type(self, schema: Schema) -> DataType:
        return self.value.dtype

    def __repr__(self) -> str:
        return repr(self.value)


@dataclass(frozen=True, repr=False)
class BinaryExpr(Expr):
    left: Expr
    op: Operator
    right: Expr

    def get_type(self, schema: Schema) -> DataType:
        if self.op.is_comparison or self.op.is_boolean:
            return DataType.Boolean
        if self.op in (Operator.Like, Operator.NotLike):
            # deviation: the reference typed LIKE via the supertype branch
            # (→ Utf8, logicalplan.rs:181-193); a predicate is Boolean
            return DataType.Boolean
        lt = self.left.get_type(schema)
        rt = self.right.get_type(schema)
        st = get_supertype(lt, rt)
        # reference falls back to Utf8 with a TODO (logicalplan.rs:191)
        return st if st is not None else DataType.Utf8

    def __repr__(self) -> str:
        return f"{self.left!r} {self.op!r} {self.right!r}"


@dataclass(frozen=True, repr=False)
class IsNull(Expr):
    expr: Expr

    def get_type(self, schema: Schema) -> DataType:
        return DataType.Boolean

    def __repr__(self) -> str:
        return f"{self.expr!r} IS NULL"


@dataclass(frozen=True, repr=False)
class IsNotNull(Expr):
    expr: Expr

    def get_type(self, schema: Schema) -> DataType:
        return DataType.Boolean

    def __repr__(self) -> str:
        return f"{self.expr!r} IS NOT NULL"


@dataclass(frozen=True, repr=False)
class Cast(Expr):
    expr: Expr
    data_type: DataType

    def get_type(self, schema: Schema) -> DataType:
        return self.data_type

    def __repr__(self) -> str:
        return f"CAST({self.expr!r} AS {self.data_type!r})"


@dataclass(frozen=True, repr=False)
class Alias(Expr):
    """Named projection item `expr AS name` (beyond the reference)."""

    expr: Expr
    name: str

    def get_type(self, schema: Schema) -> DataType:
        return self.expr.get_type(schema)

    def __repr__(self) -> str:
        return f"{self.expr!r} AS {self.name}"


@dataclass(frozen=True, repr=False)
class Case(Expr):
    """CASE WHEN cond THEN result ... [ELSE result] END (beyond the
    reference). The planner coerces every result arm (and the ELSE) to a
    common supertype, so arm 0's type is the expression's type. With no
    ELSE, unmatched rows are NULL."""

    branches: tuple[tuple[Expr, Expr], ...]
    else_expr: Optional[Expr] = None

    def get_type(self, schema: Schema) -> DataType:
        return self.branches[0][1].get_type(schema)

    def __repr__(self) -> str:
        parts = " ".join(f"WHEN {c!r} THEN {r!r}" for c, r in self.branches)
        tail = f" ELSE {self.else_expr!r}" if self.else_expr is not None else ""
        return f"CASE {parts}{tail} END"


@dataclass(frozen=True, repr=False)
class SortExpr(Expr):
    """A sort key with direction (reference: Expr::Sort). nulls_first
    None = engine default (nulls last regardless of direction); an
    explicit NULLS FIRST/LAST sets True/False (beyond the reference)."""

    expr: Expr
    asc: bool = True
    nulls_first: Optional[bool] = None

    def get_type(self, schema: Schema) -> DataType:
        return self.expr.get_type(schema)

    def __repr__(self) -> str:
        base = f"{self.expr!r} {'ASC' if self.asc else 'DESC'}"
        if self.nulls_first is not None:
            base += " NULLS FIRST" if self.nulls_first else " NULLS LAST"
        return base


@dataclass(frozen=True, repr=False)
class ScalarFunction(Expr):
    name: str
    args: tuple[Expr, ...]
    return_type: DataType

    def get_type(self, schema: Schema) -> DataType:
        return self.return_type

    def __repr__(self) -> str:
        return f"{self.name}({', '.join(repr(a) for a in self.args)})"


@dataclass(frozen=True, repr=False)
class WindowFunction(Expr):
    """fn(args) OVER (PARTITION BY ... ORDER BY ...) — beyond the
    reference. Evaluated by the Window plan node (ops/window.py)."""

    name: str
    args: tuple[Expr, ...]
    partition_by: tuple[Expr, ...]
    order_by: tuple["SortExpr", ...]
    return_type: DataType
    offset: int = 1  # LAG/LEAD
    # explicit ROWS frame: (lo, hi) row offsets relative to the current
    # row, None = unbounded in that direction; absent = default frame
    frame: Optional[tuple[Optional[int], Optional[int]]] = None

    def get_type(self, schema: Schema) -> DataType:
        return self.return_type

    @staticmethod
    def _bound(off: Optional[int], is_lo: bool) -> str:
        if off is None:
            return "UNBOUNDED " + ("PRECEDING" if is_lo else "FOLLOWING")
        if off == 0:
            return "CURRENT ROW"
        return f"{-off} PRECEDING" if off < 0 else f"{off} FOLLOWING"

    def __repr__(self) -> str:
        inner = ", ".join(repr(a) for a in self.args)
        parts = []
        if self.partition_by:
            parts.append(
                "PARTITION BY " + ", ".join(repr(e) for e in self.partition_by)
            )
        if self.order_by:
            parts.append("ORDER BY " + ", ".join(repr(e) for e in self.order_by))
        if self.frame is not None:
            parts.append(
                f"ROWS BETWEEN {self._bound(self.frame[0], True)} "
                f"AND {self._bound(self.frame[1], False)}"
            )
        return f"{self.name}({inner}) OVER ({' '.join(parts)})"


@dataclass(frozen=True, repr=False)
class AggregateFunction(Expr):
    name: str  # as written in SQL (reference keeps original case)
    args: tuple[Expr, ...]
    return_type: DataType
    distinct: bool = False  # COUNT(DISTINCT x) — beyond the reference

    def get_type(self, schema: Schema) -> DataType:
        return self.return_type

    def __repr__(self) -> str:
        inner = ", ".join(repr(a) for a in self.args)
        if self.distinct:
            return f"{self.name}(DISTINCT {inner})"
        return f"{self.name}({inner})"


# ---------------------------------------------------------------------------
# Schema derivation (reference: sqlplanner.rs:395-431)
# ---------------------------------------------------------------------------


def expr_to_field(e: Expr, input_schema: Schema) -> Field:
    if isinstance(e, Alias):
        inner = expr_to_field(e.expr, input_schema)
        return Field(e.name, inner.dtype, inner.nullable)
    if isinstance(e, Column):
        return input_schema.field(e.index)
    if isinstance(e, Literal):
        return Field("lit", e.value.dtype, True)
    if isinstance(e, (ScalarFunction, AggregateFunction)):
        return Field(e.name, e.return_type, True)
    if isinstance(e, Cast):
        return Field("cast", e.data_type, True)
    if isinstance(e, BinaryExpr):
        if e.op.is_comparison or e.op.is_boolean:
            return Field("binary_expr", DataType.Boolean, True)
        lt = e.left.get_type(input_schema)
        rt = e.right.get_type(input_schema)
        st = get_supertype(lt, rt)
        if st is None:
            raise PlanError(f"no supertype for {lt!r} and {rt!r}")
        return Field("binary_expr", st, True)
    if isinstance(e, (IsNull, IsNotNull)):
        return Field("binary_expr", DataType.Boolean, True)
    if isinstance(e, SortExpr):
        return expr_to_field(e.expr, input_schema)
    if isinstance(e, Case):
        return Field("case", e.get_type(input_schema), True)
    raise PlanError(f"Cannot determine schema type for expression {e!r}")


def exprlist_to_fields(exprs, input_schema: Schema) -> list[Field]:
    return [expr_to_field(e, input_schema) for e in exprs]


# ---------------------------------------------------------------------------
# Plan nodes
# ---------------------------------------------------------------------------


class LogicalPlan:
    """Base class for plan nodes (reference: logicalplan.rs:311-348)."""

    schema: Schema

    def children(self) -> tuple["LogicalPlan", ...]:
        return ()

    # pretty printer (reference: logicalplan.rs:366-443)
    def _fmt(self, indent: int) -> str:
        raise NotImplementedError

    def __repr__(self) -> str:
        return self._fmt(0)

    def _child_fmt(self, indent: int) -> str:
        return "\n" + "  " * (indent + 1)


@dataclass(repr=False)
class EmptyRelation(LogicalPlan):
    schema: Schema

    def _fmt(self, indent: int) -> str:
        return "EmptyRelation"


@dataclass(repr=False)
class TableScan(LogicalPlan):
    schema_name: str
    table_name: str
    schema: Schema
    projection: Optional[list[int]] = None
    # self-contained source description {file_type, path, has_header} —
    # stamped by ExecutionContext.serialize_plan so a shipped plan JSON
    # is executable by a context with no pre-registered tables (the
    # reference's serializable-but-never-constructed groundwork:
    # datasource.rs:78-93 DataSourceMeta, physicalplan.rs:18-34)
    source: Optional[dict] = None

    def _fmt(self, indent: int) -> str:
        proj = "None" if self.projection is None else f"Some({self.projection})"
        return f"TableScan: {self.table_name} projection={proj}"


@dataclass(repr=False)
class Projection(LogicalPlan):
    exprs: tuple[Expr, ...]
    input: LogicalPlan
    schema: Schema

    def children(self):
        return (self.input,)

    def _fmt(self, indent: int) -> str:
        head = "Projection: " + ", ".join(repr(e) for e in self.exprs)
        return head + self._child_fmt(indent) + self.input._fmt(indent + 1)


@dataclass(repr=False)
class Window(LogicalPlan):
    """Appends one column per window expression to the input schema
    (beyond the reference). Evaluated by ops/window.py: one co-sort per
    distinct (PARTITION BY, ORDER BY) spec."""

    input: LogicalPlan
    window_exprs: tuple[WindowFunction, ...]
    schema: Schema  # input fields + one per window expr

    def children(self):
        return (self.input,)

    def _fmt(self, indent: int) -> str:
        head = "Window: " + ", ".join(repr(e) for e in self.window_exprs)
        return head + self._child_fmt(indent) + self.input._fmt(indent + 1)


@dataclass(repr=False)
class Selection(LogicalPlan):
    expr: Expr
    input: LogicalPlan

    @property
    def schema(self) -> Schema:
        return self.input.schema

    def children(self):
        return (self.input,)

    def _fmt(self, indent: int) -> str:
        return (
            f"Selection: {self.expr!r}"
            + self._child_fmt(indent)
            + self.input._fmt(indent + 1)
        )


@dataclass(repr=False)
class Aggregate(LogicalPlan):
    input: LogicalPlan
    group_exprs: tuple[Expr, ...]
    aggr_exprs: tuple[Expr, ...]
    schema: Schema

    def children(self):
        return (self.input,)

    def _fmt(self, indent: int) -> str:
        g = "[" + ", ".join(repr(e) for e in self.group_exprs) + "]"
        a = "[" + ", ".join(repr(e) for e in self.aggr_exprs) + "]"
        return (
            f"Aggregate: groupBy=[{g}], aggr=[{a}]"
            + self._child_fmt(indent)
            + self.input._fmt(indent + 1)
        )


@dataclass(repr=False)
class Sort(LogicalPlan):
    exprs: tuple[SortExpr, ...]
    input: LogicalPlan
    schema: Schema

    def children(self):
        return (self.input,)

    def _fmt(self, indent: int) -> str:
        head = "Sort: " + ", ".join(repr(e) for e in self.exprs)
        return head + self._child_fmt(indent) + self.input._fmt(indent + 1)


@dataclass(repr=False)
class Limit(LogicalPlan):
    """LIMIT [n] [OFFSET m]. limit=None means no cap (bare OFFSET —
    beyond the reference); offset skips the first m rows of the
    input's current order."""

    limit: Optional[int]
    input: LogicalPlan
    schema: Schema
    offset: int = 0

    def children(self):
        return (self.input,)

    def _fmt(self, indent: int) -> str:
        head = f"Limit: {'ALL' if self.limit is None else self.limit}"
        if self.offset:
            head += f" OFFSET {self.offset}"
        return head + self._child_fmt(indent) + self.input._fmt(indent + 1)


class JoinType(enum.Enum):
    Inner = "Inner"
    Left = "Left"
    Right = "Right"
    Full = "Full"

    def __repr__(self) -> str:
        return self.value


@dataclass(repr=False)
class Join(LogicalPlan):
    """Equi-join — the reference's 0.7.0 roadmap item (ROADMAP.md:33),
    first-class here."""

    left: LogicalPlan
    right: LogicalPlan
    on: tuple[tuple[int, int], ...]  # (left column, right column) pairs
    join_type: JoinType
    schema: Schema

    def children(self):
        return (self.left, self.right)

    def _fmt(self, indent: int) -> str:
        on = ", ".join(f"#{l} = #{r}" for l, r in self.on)
        return (
            f"Join: type={self.join_type!r}, on=[{on}]"
            + self._child_fmt(indent)
            + self.left._fmt(indent + 1)
            + self._child_fmt(indent)
            + self.right._fmt(indent + 1)
        )


@dataclass(repr=False)
class Union(LogicalPlan):
    """UNION ALL of same-arity inputs (beyond the reference; the planner
    coerces each input's columns to a common supertype and plain UNION
    wraps this node in a distinct Aggregate)."""

    inputs: tuple[LogicalPlan, ...]
    schema: Schema

    def children(self):
        return self.inputs

    def _fmt(self, indent: int) -> str:
        body = "".join(
            self._child_fmt(indent) + c._fmt(indent + 1) for c in self.inputs
        )
        return "Union" + body


# ---------------------------------------------------------------------------
# JSON serde — the plan-shipping format the reference intended
# (logicalplan.rs:612-651 round-trip test).
# ---------------------------------------------------------------------------


def expr_to_json(e: Expr):
    if isinstance(e, Alias):
        return {"Alias": {"expr": expr_to_json(e.expr), "name": e.name}}
    if isinstance(e, Column):
        return {"Column": e.index}
    if isinstance(e, Literal):
        v = e.value
        return {"Literal": {v.dtype.value: v.value}}
    if isinstance(e, BinaryExpr):
        return {
            "BinaryExpr": {
                "left": expr_to_json(e.left),
                "op": e.op.value,
                "right": expr_to_json(e.right),
            }
        }
    if isinstance(e, IsNull):
        return {"IsNull": expr_to_json(e.expr)}
    if isinstance(e, IsNotNull):
        return {"IsNotNull": expr_to_json(e.expr)}
    if isinstance(e, Cast):
        return {"Cast": {"expr": expr_to_json(e.expr), "data_type": e.data_type.value}}
    if isinstance(e, SortExpr):
        out = {"expr": expr_to_json(e.expr), "asc": e.asc}
        if e.nulls_first is not None:
            out["nulls_first"] = e.nulls_first
        return {"Sort": out}
    if isinstance(e, ScalarFunction):
        return {
            "ScalarFunction": {
                "name": e.name,
                "args": [expr_to_json(a) for a in e.args],
                "return_type": e.return_type.value,
            }
        }
    if isinstance(e, AggregateFunction):
        return {
            "AggregateFunction": {
                "name": e.name,
                "args": [expr_to_json(a) for a in e.args],
                "return_type": e.return_type.value,
                "distinct": e.distinct,
            }
        }
    if isinstance(e, Case):
        return {
            "Case": {
                "branches": [
                    [expr_to_json(c), expr_to_json(r)] for c, r in e.branches
                ],
                "else": None if e.else_expr is None else expr_to_json(e.else_expr),
            }
        }
    if isinstance(e, WindowFunction):
        return {
            "WindowFunction": {
                "name": e.name,
                "args": [expr_to_json(a) for a in e.args],
                "partition_by": [expr_to_json(a) for a in e.partition_by],
                "order_by": [expr_to_json(a) for a in e.order_by],
                "return_type": e.return_type.value,
                "offset": e.offset,
                "frame": None if e.frame is None else list(e.frame),
            }
        }
    raise PlanError(f"cannot serialize expr {e!r}")


def expr_from_json(d) -> Expr:
    (kind, body), = d.items()
    if kind == "Alias":
        return Alias(expr_from_json(body["expr"]), body["name"])
    if kind == "Column":
        return Column(body)
    if kind == "Literal":
        (dt, v), = body.items()
        return Literal(ScalarValue(DataType(dt), v))
    if kind == "BinaryExpr":
        return BinaryExpr(
            expr_from_json(body["left"]), Operator(body["op"]), expr_from_json(body["right"])
        )
    if kind == "IsNull":
        return IsNull(expr_from_json(body))
    if kind == "IsNotNull":
        return IsNotNull(expr_from_json(body))
    if kind == "Cast":
        return Cast(expr_from_json(body["expr"]), DataType(body["data_type"]))
    if kind == "Sort":
        return SortExpr(
            expr_from_json(body["expr"]), body["asc"], body.get("nulls_first")
        )
    if kind == "ScalarFunction":
        return ScalarFunction(
            body["name"],
            tuple(expr_from_json(a) for a in body["args"]),
            DataType(body["return_type"]),
        )
    if kind == "AggregateFunction":
        return AggregateFunction(
            body["name"],
            tuple(expr_from_json(a) for a in body["args"]),
            DataType(body["return_type"]),
            body.get("distinct", False),
        )
    if kind == "Case":
        return Case(
            tuple(
                (expr_from_json(c), expr_from_json(r)) for c, r in body["branches"]
            ),
            None if body["else"] is None else expr_from_json(body["else"]),
        )
    if kind == "WindowFunction":
        return WindowFunction(
            body["name"],
            tuple(expr_from_json(a) for a in body["args"]),
            tuple(expr_from_json(a) for a in body["partition_by"]),
            tuple(expr_from_json(a) for a in body["order_by"]),
            DataType(body["return_type"]),
            body.get("offset", 1),
            None if body.get("frame") is None else tuple(body["frame"]),
        )
    raise PlanError(f"cannot deserialize expr kind {kind}")


def _schema_to_json(s: Schema):
    return [[f.name, f.dtype.value, f.nullable] for f in s.fields]


def _schema_from_json(d) -> Schema:
    return Schema(Field(n, DataType(t), nl) for n, t, nl in d)


def plan_to_json(p: LogicalPlan):
    if isinstance(p, EmptyRelation):
        return {"EmptyRelation": {"schema": _schema_to_json(p.schema)}}
    if isinstance(p, TableScan):
        return {
            "TableScan": {
                "schema_name": p.schema_name,
                "table_name": p.table_name,
                "schema": _schema_to_json(p.schema),
                "projection": p.projection,
                "source": p.source,
            }
        }
    if isinstance(p, Projection):
        return {
            "Projection": {
                "expr": [expr_to_json(e) for e in p.exprs],
                "input": plan_to_json(p.input),
                "schema": _schema_to_json(p.schema),
            }
        }
    if isinstance(p, Selection):
        return {"Selection": {"expr": expr_to_json(p.expr), "input": plan_to_json(p.input)}}
    if isinstance(p, Aggregate):
        return {
            "Aggregate": {
                "input": plan_to_json(p.input),
                "group_expr": [expr_to_json(e) for e in p.group_exprs],
                "aggr_expr": [expr_to_json(e) for e in p.aggr_exprs],
                "schema": _schema_to_json(p.schema),
            }
        }
    if isinstance(p, Sort):
        return {
            "Sort": {
                "expr": [expr_to_json(e) for e in p.exprs],
                "input": plan_to_json(p.input),
                "schema": _schema_to_json(p.schema),
            }
        }
    if isinstance(p, Limit):
        return {
            "Limit": {
                "limit": p.limit,
                "input": plan_to_json(p.input),
                "schema": _schema_to_json(p.schema),
                "offset": p.offset,
            }
        }
    if isinstance(p, Join):
        return {
            "Join": {
                "left": plan_to_json(p.left),
                "right": plan_to_json(p.right),
                "on": [list(x) for x in p.on],
                "join_type": p.join_type.value,
                "schema": _schema_to_json(p.schema),
            }
        }
    if isinstance(p, Union):
        return {
            "Union": {
                "inputs": [plan_to_json(c) for c in p.inputs],
                "schema": _schema_to_json(p.schema),
            }
        }
    if isinstance(p, Window):
        return {
            "Window": {
                "input": plan_to_json(p.input),
                "window_exprs": [expr_to_json(e) for e in p.window_exprs],
                "schema": _schema_to_json(p.schema),
            }
        }
    raise PlanError(f"cannot serialize plan {type(p).__name__}")


def plan_from_json(d) -> LogicalPlan:
    (kind, body), = d.items()
    if kind == "EmptyRelation":
        return EmptyRelation(_schema_from_json(body["schema"]))
    if kind == "TableScan":
        return TableScan(
            body["schema_name"],
            body["table_name"],
            _schema_from_json(body["schema"]),
            body["projection"],
            body.get("source"),
        )
    if kind == "Projection":
        return Projection(
            tuple(expr_from_json(e) for e in body["expr"]),
            plan_from_json(body["input"]),
            _schema_from_json(body["schema"]),
        )
    if kind == "Selection":
        return Selection(expr_from_json(body["expr"]), plan_from_json(body["input"]))
    if kind == "Aggregate":
        return Aggregate(
            plan_from_json(body["input"]),
            tuple(expr_from_json(e) for e in body["group_expr"]),
            tuple(expr_from_json(e) for e in body["aggr_expr"]),
            _schema_from_json(body["schema"]),
        )
    if kind == "Sort":
        return Sort(
            tuple(expr_from_json(e) for e in body["expr"]),
            plan_from_json(body["input"]),
            _schema_from_json(body["schema"]),
        )
    if kind == "Limit":
        return Limit(
            body["limit"],
            plan_from_json(body["input"]),
            _schema_from_json(body["schema"]),
            body.get("offset", 0),
        )
    if kind == "Join":
        return Join(
            plan_from_json(body["left"]),
            plan_from_json(body["right"]),
            tuple(tuple(x) for x in body["on"]),
            JoinType(body["join_type"]),
            _schema_from_json(body["schema"]),
        )
    if kind == "Union":
        return Union(
            tuple(plan_from_json(c) for c in body["inputs"]),
            _schema_from_json(body["schema"]),
        )
    if kind == "Window":
        return Window(
            plan_from_json(body["input"]),
            tuple(expr_from_json(e) for e in body["window_exprs"]),
            _schema_from_json(body["schema"]),
        )
    raise PlanError(f"cannot deserialize plan kind {kind}")
