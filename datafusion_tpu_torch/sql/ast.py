"""SQL AST — our own node set covering the reference's accepted grammar.

Mirrors the shapes the reference consumed from the `sqlparser` crate
(reference: sqlplanner.rs:46-375 matches on ASTNode variants) plus the
DataFusion-specific `CREATE EXTERNAL TABLE` node (reference:
dfparser.rs:39-55) and JOIN support the reference lacked.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class AstNode:
    pass


@dataclass(frozen=True)
class SQLIdentifier(AstNode):
    name: str


@dataclass(frozen=True)
class SQLCompoundIdentifier(AstNode):
    """`table.column` reference (needed for JOIN planning)."""

    qualifier: str
    name: str


@dataclass(frozen=True)
class SQLDerivedTable(AstNode):
    """FROM (SELECT ...) [AS] alias — a subquery as a relation."""

    select: "SQLSelect"
    alias: str


@dataclass(frozen=True)
class SQLInSubquery(AstNode):
    """expr [NOT] IN (SELECT ...) — planned as a semi/anti join against
    the DISTINCT subquery result (beyond the reference's grammar)."""

    expr: AstNode
    subquery: AstNode
    negated: bool


@dataclass(frozen=True)
class SQLExists(AstNode):
    """[NOT] EXISTS (SELECT ...) — decorrelated into a semi/anti join on
    the outer=inner equality predicates (beyond the reference)."""

    select: AstNode


@dataclass(frozen=True)
class SQLScalarSubquery(AstNode):
    """(SELECT ...) used as a scalar expression — planned as a LEFT cross
    join against the LIMIT-1 subquery result (beyond the reference)."""

    select: AstNode


@dataclass(frozen=True)
class SQLAliasedTable(AstNode):
    """FROM name [AS] alias — alias-qualified table reference."""

    name: str
    alias: str


@dataclass(frozen=True)
class SQLWildcard(AstNode):
    pass


@dataclass(frozen=True)
class SQLLong(AstNode):
    value: int


@dataclass(frozen=True)
class SQLDouble(AstNode):
    value: float


@dataclass(frozen=True)
class SQLString(AstNode):
    value: str


@dataclass(frozen=True)
class SQLDate(AstNode):
    """DATE 'YYYY-MM-DD' literal (beyond the reference)."""

    value: str


@dataclass(frozen=True)
class SQLTimestamp(AstNode):
    """TIMESTAMP 'YYYY-MM-DD HH:MM:SS' literal (beyond the reference)."""

    value: str


@dataclass(frozen=True)
class SQLInterval(AstNode):
    """INTERVAL 'n' UNIT literal — only valid as one side of +/- with a
    DATE or TIMESTAMP (beyond the reference)."""

    value: int
    unit: str  # YEAR | MONTH | WEEK | DAY | HOUR | MINUTE | SECOND


@dataclass(frozen=True)
class SQLBinaryExpr(AstNode):
    left: AstNode
    op: str  # canonical operator name: Eq, NotEq, Gt, ..., And, Or, Like
    right: AstNode


@dataclass(frozen=True)
class SQLUnary(AstNode):
    op: str  # "Not" | "Minus" | "Plus"
    expr: AstNode


@dataclass(frozen=True)
class SQLCast(AstNode):
    expr: AstNode
    type_name: str  # raw SQL type name, e.g. "int", "double", "varchar"


@dataclass(frozen=True)
class SQLIsNull(AstNode):
    expr: AstNode


@dataclass(frozen=True)
class SQLIsNotNull(AstNode):
    expr: AstNode


@dataclass(frozen=True)
class SQLFunction(AstNode):
    name: str
    args: tuple[AstNode, ...]
    distinct: bool = False  # COUNT(DISTINCT x)


@dataclass(frozen=True)
class SQLWindowExpr(AstNode):
    """fn(args) OVER ([PARTITION BY ...] [ORDER BY ...]) — beyond the
    reference's grammar."""

    func: SQLFunction
    partition_by: tuple[AstNode, ...]
    order_by: tuple["SQLOrderByExpr", ...]
    # ROWS frame: (lo, hi) offsets relative to the current row,
    # None = unbounded; absent (None) = default frame
    frame: Optional[tuple[Optional[int], Optional[int]]] = None


@dataclass(frozen=True)
class SQLUnion(AstNode):
    """left UNION [ALL] right (beyond the reference)."""

    left: AstNode
    right: AstNode
    all: bool


@dataclass(frozen=True)
class SQLSetOp(AstNode):
    """left INTERSECT|EXCEPT [ALL] right (beyond the reference). Planned
    as distinct + semi/anti join over all columns; ALL keeps bag
    multiplicities via per-duplicate row numbers."""

    op: str  # "INTERSECT" | "EXCEPT"
    left: AstNode
    right: AstNode
    all: bool = False


@dataclass(frozen=True)
class SQLWith(AstNode):
    """WITH name AS (SELECT ...) [, ...] body — common table
    expressions (beyond the reference's grammar). Non-recursive; each
    CTE sees the ones defined before it."""

    ctes: tuple[tuple[str, AstNode], ...]
    body: AstNode


@dataclass(frozen=True)
class SQLCase(AstNode):
    """CASE [operand] WHEN cond THEN result ... [ELSE result] END
    (beyond the reference, whose sqlparser 0.2.1 had no CASE grammar)."""

    operand: Optional[AstNode]
    whens: tuple[tuple[AstNode, AstNode], ...]
    else_expr: Optional[AstNode]


@dataclass(frozen=True)
class SQLAliasedExpr(AstNode):
    """projection item `expr AS name` (beyond the reference)."""

    expr: AstNode
    alias: str


@dataclass(frozen=True)
class SQLOrderByExpr(AstNode):
    expr: AstNode
    asc: bool
    nulls_first: Optional[bool] = None  # explicit NULLS FIRST/LAST


class JoinKind(enum.Enum):
    Inner = "Inner"
    Left = "Left"
    Right = "Right"
    Full = "Full"


@dataclass(frozen=True)
class SQLJoin(AstNode):
    """FROM a [INNER|LEFT|RIGHT|CROSS] JOIN b [ON <expr>] — beyond the
    reference. CROSS JOIN has on=None (every pair)."""

    left: AstNode
    right: AstNode
    kind: JoinKind
    on: Optional[AstNode]


@dataclass(frozen=True)
class SQLSelect(AstNode):
    projection: tuple[AstNode, ...]
    distinct: bool
    relation: Optional[AstNode]
    selection: Optional[AstNode]
    group_by: tuple[AstNode, ...]
    having: Optional[AstNode]
    order_by: tuple[SQLOrderByExpr, ...]
    limit: Optional[AstNode]
    offset: Optional[AstNode] = None
    # GROUP BY GROUPING SETS / ROLLUP / CUBE: the grouping sets, each a
    # subset of group_by (None = plain GROUP BY)
    group_sets: "Optional[tuple[tuple[AstNode, ...], ...]]" = None


class FileType(enum.Enum):
    CSV = "CSV"
    NdJson = "NdJson"
    Parquet = "Parquet"


@dataclass(frozen=True)
class ColumnDef(AstNode):
    name: str
    type_name: str
    allow_null: bool


@dataclass(frozen=True)
class SQLExplain(AstNode):
    """EXPLAIN [VERBOSE] <statement> — plan display (beyond the
    reference); VERBOSE adds the compiler's physical-strategy notes."""

    stmt: AstNode
    verbose: bool = False


@dataclass(frozen=True)
class SQLCreateTableAs(AstNode):
    """CREATE TABLE name AS <select> — materializes the query result as
    a registered in-memory table (beyond the reference)."""

    name: str
    select: AstNode


@dataclass(frozen=True)
class SQLDropTable(AstNode):
    """DROP TABLE [IF EXISTS] name (beyond the reference)."""

    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class SQLInsert(AstNode):
    """INSERT INTO name [(cols)] VALUES ... | SELECT ... — appends rows
    to a registered table (beyond the reference)."""

    table: str
    columns: "Optional[tuple[str, ...]]"
    source: AstNode


@dataclass(frozen=True)
class SQLShowTables(AstNode):
    """SHOW TABLES — registered table names (the reference's vestigial
    PhysicalPlan::Show, physicalplan.rs:31-33, never executed)."""


@dataclass(frozen=True)
class SQLDescribeTable(AstNode):
    """DESCRIBE name — column name/type/nullability (beyond the
    reference)."""

    name: str


@dataclass(frozen=True)
class SQLCreateExternalTable(AstNode):
    """CREATE EXTERNAL TABLE name (cols) STORED AS fmt [WITH|WITHOUT HEADER
    ROW] LOCATION 'path' (reference: dfparser.rs:101-207)."""

    name: str
    columns: tuple[ColumnDef, ...]
    file_type: FileType
    header_row: bool
    location: str
