"""SQL parser: token stream → AST.

Our own Pratt parser covering the reference's accepted grammar — ANSI
SELECT with WHERE / GROUP BY / HAVING / ORDER BY / LIMIT, expressions
with the sqlparser-crate operator set and precedence, plus the
DataFusion DDL `CREATE EXTERNAL TABLE` (reference: dfparser.rs:101-207)
and JOIN clauses (beyond the reference, its 0.7.0 roadmap).
"""

from __future__ import annotations

from typing import Optional

from datafusion_tpu_torch.errors import ParserError
from datafusion_tpu_torch.sql.ast import (
    AstNode,
    ColumnDef,
    FileType,
    JoinKind,
    SQLBinaryExpr,
    SQLCast,
    SQLCompoundIdentifier,
    SQLCreateExternalTable,
    SQLDouble,
    SQLFunction,
    SQLIdentifier,
    SQLInSubquery,
    SQLIsNotNull,
    SQLIsNull,
    SQLJoin,
    SQLLong,
    SQLOrderByExpr,
    SQLSelect,
    SQLString,
    SQLUnary,
    SQLWildcard,
)
from datafusion_tpu_torch.sql.tokenizer import Tok, Token, tokenize

# operator precedence, mirroring sqlparser 0.2.1's get_precedence
_PREC = {
    "OR": 5,
    "AND": 10,
    "IS": 17,
    "=": 20,
    "!=": 20,
    "<>": 20,
    "<": 20,
    "<=": 20,
    ">": 20,
    ">=": 20,
    "LIKE": 20,
    "IN": 20,
    "BETWEEN": 20,
    "NOT": 20,  # as start of NOT LIKE / NOT IN / NOT BETWEEN
    "||": 30,
    "+": 30,
    "-": 30,
    "*": 40,
    "/": 40,
    "%": 40,
}

_BINOP_NAME = {
    "=": "Eq",
    "!=": "NotEq",
    "<>": "NotEq",
    "<": "Lt",
    "<=": "LtEq",
    ">": "Gt",
    ">=": "GtEq",
    "+": "Plus",
    "-": "Minus",
    "*": "Multiply",
    "/": "Divide",
    "%": "Modulus",
    "AND": "And",
    "OR": "Or",
    "LIKE": "Like",
}

_RESERVED_STOP = {
    "FROM",
    "WHERE",
    "GROUP",
    "HAVING",
    "ORDER",
    "LIMIT",
    "ON",
    "JOIN",
    "INNER",
    "LEFT",
    "RIGHT",
    "FULL",
    "CROSS",
    "AS",
    "ASC",
    "DESC",
    "BY",
    "AND",
    "OR",
    "NOT",
    "IS",
    "NULL",
    "LIKE",
    "OVER",
    "EXISTS",
    "SELECT",
    "UNION",
    "CASE",
    "WHEN",
    "THEN",
    "ELSE",
    "END",
    "INTERSECT",
    "EXCEPT",
    "OFFSET",
}


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # ---- token helpers ---------------------------------------------------
    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind is not Tok.EOF:
            self.i += 1
        return t

    def expect_op(self, op: str) -> None:
        t = self.next()
        if t.kind is not Tok.OP or t.value != op:
            raise ParserError(f"expected {op!r}, found {t.value!r} at offset {t.pos}")

    def consume_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind is Tok.OP and t.value == op:
            self.i += 1
            return True
        return False

    def consume_keyword(self, kw: str) -> bool:
        t = self.peek()
        if t.kind is Tok.IDENT and t.upper == kw:
            self.i += 1
            return True
        return False

    def consume_keywords(self, *kws: str) -> bool:
        save = self.i
        for kw in kws:
            if not self.consume_keyword(kw):
                self.i = save
                return False
        return True

    def expect_keyword(self, kw: str) -> None:
        t = self.next()
        if t.kind is not Tok.IDENT or t.upper != kw:
            raise ParserError(f"expected {kw}, found {t.value!r} at offset {t.pos}")

    def expect_ident(self) -> str:
        t = self.next()
        if t.kind is not Tok.IDENT:
            raise ParserError(f"expected identifier, found {t.value!r} at offset {t.pos}")
        return t.value

    # ---- statements ------------------------------------------------------
    def parse_statement(self) -> AstNode:
        if self.consume_keyword("EXPLAIN"):
            from datafusion_tpu_torch.sql.ast import SQLExplain

            verbose = self.consume_keyword("VERBOSE")
            return SQLExplain(self.parse_statement(), verbose)
        if self.consume_keywords("CREATE", "EXTERNAL", "TABLE"):
            return self._parse_create_external_table()
        if self.consume_keywords("CREATE", "TABLE"):
            from datafusion_tpu_torch.sql.ast import SQLCreateTableAs

            name = self.expect_ident()
            self.expect_keyword("AS")
            return SQLCreateTableAs(name, self._parse_select_set())
        if self.consume_keywords("INSERT", "INTO"):
            from datafusion_tpu_torch.sql.ast import SQLInsert

            name = self.expect_ident()
            cols = None
            if self.consume_op("("):
                cols = [self.expect_ident()]
                while self.consume_op(","):
                    cols.append(self.expect_ident())
                self.expect_op(")")
            t = self.peek()
            if t.kind is Tok.IDENT and t.upper == "VALUES":
                source = self._parse_values()
            elif t.kind is Tok.IDENT and t.upper in ("SELECT", "WITH"):
                source = self._parse_select_set()
            else:
                raise ParserError(
                    f"INSERT expects VALUES or SELECT, found {t.value!r}"
                )
            return SQLInsert(name, None if cols is None else tuple(cols), source)
        if self.peek().kind is Tok.IDENT and self.peek().upper == "VALUES":
            return self._parse_values()
        if self.consume_keywords("DROP", "TABLE"):
            from datafusion_tpu_torch.sql.ast import SQLDropTable

            if_exists = self.consume_keywords("IF", "EXISTS")
            return SQLDropTable(self.expect_ident(), if_exists)
        if self.consume_keywords("SHOW", "TABLES"):
            from datafusion_tpu_torch.sql.ast import SQLShowTables

            return SQLShowTables()
        if self.consume_keyword("DESCRIBE"):
            from datafusion_tpu_torch.sql.ast import SQLDescribeTable

            return SQLDescribeTable(self.expect_ident())
        if self.peek().kind is Tok.IDENT and self.peek().upper in ("SELECT", "WITH"):
            return self._parse_select_set()
        t = self.peek()
        raise ParserError(f"unexpected token {t.value!r} at offset {t.pos}")

    def _parse_select_set(self) -> AstNode:
        """[WITH ctes] SELECT ... [UNION [ALL]|INTERSECT|EXCEPT ...]*.

        UNION/EXCEPT are left-associative at equal precedence;
        INTERSECT binds tighter (ANSI).
        """
        from datafusion_tpu_torch.sql.ast import SQLSetOp, SQLUnion, SQLWith

        if self.consume_keyword("WITH"):
            ctes: list[tuple[str, AstNode]] = []
            while True:
                name = self.expect_ident()
                self.expect_keyword("AS")
                self.expect_op("(")
                sub = self._parse_select_set()
                self.expect_op(")")
                ctes.append((name, sub))
                if not self.consume_op(","):
                    break
            return SQLWith(tuple(ctes), self._parse_select_set())
        node: AstNode = self._parse_intersect()
        had_setop = isinstance(node, SQLSetOp)  # pure-INTERSECT compounds
        while True:
            if self.consume_keyword("UNION"):
                all_ = self.consume_keyword("ALL")
                node = SQLUnion(node, self._parse_intersect(), all_)
            elif self.consume_keyword("EXCEPT"):
                all_ = self.consume_keyword("ALL")
                node = SQLSetOp("EXCEPT", node, self._parse_intersect(), all_)
            else:
                break
            had_setop = True
        if had_setop:
            node = _hoist_trailing_order(node)
        return node

    def _parse_values(self) -> AstNode:
        """VALUES (a, b), (c, d) — desugars to a UNION ALL chain of
        FROM-less SELECTs (beyond the reference)."""
        from datafusion_tpu_torch.sql.ast import SQLUnion

        self.expect_keyword("VALUES")
        selects: list[AstNode] = []
        while True:
            self.expect_op("(")
            exprs = [self.parse_expr()]
            while self.consume_op(","):
                exprs.append(self.parse_expr())
            self.expect_op(")")
            selects.append(
                SQLSelect(
                    projection=tuple(exprs),
                    distinct=False,
                    relation=None,
                    selection=None,
                    group_by=(),
                    having=None,
                    order_by=(),
                    limit=None,
                )
            )
            if not self.consume_op(","):
                break
        node: AstNode = selects[0]
        for sel in selects[1:]:
            node = SQLUnion(node, sel, True)
        return node

    def _parse_intersect(self) -> AstNode:
        from datafusion_tpu_torch.sql.ast import SQLSetOp

        node: AstNode = self._parse_select()
        while self.consume_keyword("INTERSECT"):
            all_ = self.consume_keyword("ALL")
            node = SQLSetOp("INTERSECT", node, self._parse_select(), all_)
        return node

    def _parse_create_external_table(self) -> SQLCreateExternalTable:
        # (reference: dfparser.rs:101-207)
        name = self.expect_ident()
        columns: list[ColumnDef] = []
        if self.consume_op("("):
            while True:
                col_name = self.expect_ident()
                type_name = self._parse_type_name()
                if self.consume_keywords("NOT", "NULL"):
                    allow_null = False
                elif self.consume_keyword("NULL"):
                    allow_null = True
                else:
                    allow_null = True
                columns.append(ColumnDef(col_name, type_name, allow_null))
                if self.consume_op(","):
                    continue
                self.expect_op(")")
                break
        header = True
        if self.consume_keywords("STORED", "AS", "CSV"):
            if self.consume_keywords("WITH", "HEADER", "ROW"):
                header = True
            elif self.consume_keywords("WITHOUT", "HEADER", "ROW"):
                header = False
            ftype = FileType.CSV
        elif self.consume_keywords("STORED", "AS", "NDJSON"):
            ftype = FileType.NdJson
        elif self.consume_keywords("STORED", "AS", "PARQUET"):
            ftype = FileType.Parquet
        else:
            raise ParserError(
                f"Expected 'STORED AS' clause, found {self.peek().value!r}"
            )
        if not self.consume_keyword("LOCATION"):
            raise ParserError("Missing 'LOCATION' clause")
        loc = self.next()
        if loc.kind is not Tok.STRING:
            raise ParserError("LOCATION requires a string literal")
        return SQLCreateExternalTable(name, tuple(columns), ftype, header, loc.value)

    def _parse_type_name(self) -> str:
        base = self.expect_ident()
        # double precision
        if base.upper() == "DOUBLE" and self.consume_keyword("PRECISION"):
            base = "DOUBLE"
        # swallow length/precision args: VARCHAR(20), FLOAT(53)
        if self.consume_op("("):
            depth = 1
            while depth:
                t = self.next()
                if t.kind is Tok.EOF:
                    raise ParserError("unterminated type arguments")
                if t.kind is Tok.OP and t.value == "(":
                    depth += 1
                elif t.kind is Tok.OP and t.value == ")":
                    depth -= 1
        return base

    # ---- SELECT ----------------------------------------------------------
    def _parse_projection_item(self) -> AstNode:
        from datafusion_tpu_torch.sql.ast import SQLAliasedExpr

        e = self.parse_expr()
        if self.consume_keyword("AS"):
            return SQLAliasedExpr(e, self.expect_ident())
        t = self.peek()
        if (
            t.kind is Tok.IDENT
            and t.upper not in _RESERVED_STOP
        ):
            self.i += 1
            return SQLAliasedExpr(e, t.value)
        return e

    def _parse_select(self) -> SQLSelect:
        self.expect_keyword("SELECT")
        distinct = self.consume_keyword("DISTINCT")
        projection = [self._parse_projection_item()]
        while self.consume_op(","):
            projection.append(self._parse_projection_item())

        relation: Optional[AstNode] = None
        if self.consume_keyword("FROM"):
            relation = self._parse_relation()

        selection = self.parse_expr() if self.consume_keyword("WHERE") else None

        group_by: list[AstNode] = []
        group_sets = None
        if self.consume_keywords("GROUP", "BY"):
            group_by, group_sets = self._parse_group_by()

        having = self.parse_expr() if self.consume_keyword("HAVING") else None

        order_by: list[SQLOrderByExpr] = []
        if self.consume_keywords("ORDER", "BY"):
            while True:
                e = self.parse_expr()
                if self.consume_keyword("ASC"):
                    asc = True
                elif self.consume_keyword("DESC"):
                    asc = False
                else:
                    asc = True
                order_by.append(SQLOrderByExpr(e, asc, self._parse_nulls_order()))
                if not self.consume_op(","):
                    break

        limit = self.parse_expr() if self.consume_keyword("LIMIT") else None
        offset = self.parse_expr() if self.consume_keyword("OFFSET") else None

        return SQLSelect(
            projection=tuple(projection),
            distinct=distinct,
            relation=relation,
            selection=selection,
            group_by=tuple(group_by),
            having=having,
            order_by=tuple(order_by),
            limit=limit,
            offset=offset,
            group_sets=group_sets,
        )

    def _parse_group_by(self):
        """GROUP BY items | ROLLUP(items) | CUBE(items) |
        GROUPING SETS ((a, b), (a), ()) — beyond the reference. Returns
        (group_exprs, group_sets|None)."""
        if self.consume_keyword("ROLLUP"):
            items = self._parse_paren_exprs()
            sets = tuple(tuple(items[:k]) for k in range(len(items), -1, -1))
            return list(items), sets
        if self.consume_keyword("CUBE"):
            items = self._parse_paren_exprs()
            if len(items) > 5:
                raise ParserError("CUBE supports at most 5 expressions (2^n sets)")
            n = len(items)
            sets = tuple(
                tuple(items[i] for i in range(n) if mask & (1 << i))
                for mask in range(2 ** n - 1, -1, -1)
            )
            return list(items), sets
        if self.consume_keywords("GROUPING", "SETS"):
            self.expect_op("(")
            sets: list[tuple[AstNode, ...]] = []
            union: list[AstNode] = []
            while True:
                if self.peek().kind is Tok.OP and self.peek().value == "(":
                    exprs = self._parse_paren_exprs(allow_empty=True)
                else:
                    exprs = (self.parse_expr(),)
                sets.append(tuple(exprs))
                for e in exprs:
                    if e not in union:
                        union.append(e)
                if not self.consume_op(","):
                    break
            self.expect_op(")")
            return union, tuple(sets)
        group_by = [self.parse_expr()]
        while self.consume_op(","):
            group_by.append(self.parse_expr())
        return group_by, None

    def _parse_paren_exprs(self, allow_empty: bool = False) -> tuple[AstNode, ...]:
        self.expect_op("(")
        if allow_empty and self.consume_op(")"):
            return ()
        exprs = [self.parse_expr()]
        while self.consume_op(","):
            exprs.append(self.parse_expr())
        self.expect_op(")")
        return tuple(exprs)

    def _parse_nulls_order(self):
        """[NULLS FIRST|LAST] after a sort key (beyond the reference)."""
        if self.consume_keywords("NULLS", "FIRST"):
            return True
        if self.consume_keywords("NULLS", "LAST"):
            return False
        return None

    def _parse_table_ref(self) -> AstNode:
        from datafusion_tpu_torch.sql.ast import SQLAliasedTable, SQLDerivedTable

        if self.consume_op("("):
            inner = self._parse_select_set()
            self.expect_op(")")
            self.consume_keyword("AS")
            alias = self.expect_ident()
            return SQLDerivedTable(inner, alias)
        name = self.expect_ident()
        if self.consume_keyword("AS"):
            return SQLAliasedTable(name, self.expect_ident())
        # bare alias: an identifier that is not a clause keyword
        t = self.peek()
        if t.kind is Tok.IDENT and t.upper not in _RESERVED_STOP:
            self.i += 1
            return SQLAliasedTable(name, t.value)
        return SQLIdentifier(name)

    def _parse_relation(self) -> AstNode:
        """FROM list: comma-separated relations are CROSS JOINs
        (`FROM a, b WHERE a.x = b.y` — the classic TPC-H text form; the
        reference's sqlparser crate accepted it). The filter push-down
        optimizer lifts cross-side WHERE equalities into join keys."""
        rel: AstNode = self._parse_joined_table()
        while self.consume_op(","):
            rel = SQLJoin(rel, self._parse_joined_table(), JoinKind.Inner, None)
        return rel

    def _parse_joined_table(self) -> AstNode:
        rel: AstNode = self._parse_table_ref()
        while True:
            kind: Optional[JoinKind] = None
            if self.consume_keyword("JOIN") or self.consume_keywords("INNER", "JOIN"):
                kind = JoinKind.Inner
            elif self.consume_keywords("LEFT", "JOIN") or self.consume_keywords(
                "LEFT", "OUTER", "JOIN"
            ):
                kind = JoinKind.Left
            elif self.consume_keywords("RIGHT", "JOIN") or self.consume_keywords(
                "RIGHT", "OUTER", "JOIN"
            ):
                kind = JoinKind.Right
            elif self.consume_keywords("FULL", "JOIN") or self.consume_keywords(
                "FULL", "OUTER", "JOIN"
            ):
                kind = JoinKind.Full
            elif self.consume_keywords("CROSS", "JOIN"):
                rel = SQLJoin(rel, self._parse_table_ref(), JoinKind.Inner, None)
                continue
            if kind is None:
                return rel
            right = self._parse_table_ref()
            self.expect_keyword("ON")
            on = self.parse_expr()
            rel = SQLJoin(rel, right, kind, on)

    # ---- expressions (Pratt) --------------------------------------------
    def parse_expr(self, precedence: int = 0) -> AstNode:
        expr = self._parse_prefix()
        while True:
            nxt = self._next_precedence()
            if precedence >= nxt:
                return expr
            expr = self._parse_infix(expr, nxt)

    def _next_precedence(self) -> int:
        t = self.peek()
        if t.kind is Tok.OP:
            return _PREC.get(t.value, 0)
        if t.kind is Tok.IDENT:
            return _PREC.get(t.upper, 0)
        return 0

    def _parse_in_list(self, left: AstNode, negated: bool) -> AstNode:
        """x IN (v1, v2, ...) desugars to an OR-chain of equalities
        (x NOT IN → AND-chain of inequalities); x [NOT] IN (SELECT ...)
        becomes SQLInSubquery for the planner's semi/anti-join rewrite."""
        self.expect_op("(")
        t = self.peek()
        if t.kind is Tok.IDENT and t.upper in ("SELECT", "WITH"):
            sub = self._parse_select_set()
            self.expect_op(")")
            return SQLInSubquery(left, sub, negated)
        items = [self.parse_expr()]
        while self.consume_op(","):
            items.append(self.parse_expr())
        self.expect_op(")")
        op, comb = ("NotEq", "And") if negated else ("Eq", "Or")
        expr: AstNode = SQLBinaryExpr(left, op, items[0])
        for item in items[1:]:
            expr = SQLBinaryExpr(expr, comb, SQLBinaryExpr(left, op, item))
        return expr

    def _parse_between(self, left: AstNode, negated: bool) -> AstNode:
        """x BETWEEN a AND b desugars to x >= a AND x <= b."""
        lo = self.parse_expr(11)  # bind tighter than AND
        self.expect_keyword("AND")
        hi = self.parse_expr(11)
        expr: AstNode = SQLBinaryExpr(
            SQLBinaryExpr(left, "GtEq", lo), "And", SQLBinaryExpr(left, "LtEq", hi)
        )
        if negated:
            return SQLUnary("Not", expr)
        return expr

    def _parse_prefix(self) -> AstNode:
        t = self.next()
        if t.kind is Tok.EOF:
            raise ParserError("unexpected end of input, expected an expression")
        if t.kind is Tok.NUMBER:
            if "." in t.value or "e" in t.value or "E" in t.value:
                return SQLDouble(float(t.value))
            return SQLLong(int(t.value))
        if t.kind is Tok.STRING:
            return SQLString(t.value)
        if t.kind is Tok.OP:
            if t.value == "(":
                nt = self.peek()
                if nt.kind is Tok.IDENT and nt.upper in ("SELECT", "WITH"):
                    from datafusion_tpu_torch.sql.ast import SQLScalarSubquery

                    sub = self._parse_select_set()
                    self.expect_op(")")
                    return SQLScalarSubquery(sub)
                e = self.parse_expr()
                self.expect_op(")")
                return e
            if t.value == "*":
                return SQLWildcard()
            if t.value == "-":
                return SQLUnary("Minus", self.parse_expr(45))
            if t.value == "+":
                return SQLUnary("Plus", self.parse_expr(45))
            raise ParserError(f"unexpected operator {t.value!r} at offset {t.pos}")
        # identifier-like
        up = t.upper
        if up == "CAST":
            self.expect_op("(")
            inner = self.parse_expr()
            self.expect_keyword("AS")
            type_name = self._parse_type_name()
            self.expect_op(")")
            return SQLCast(inner, type_name)
        if up == "CASE":
            from datafusion_tpu_torch.sql.ast import SQLCase

            operand = None
            nt = self.peek()
            if not (nt.kind is Tok.IDENT and nt.upper == "WHEN"):
                operand = self.parse_expr()
            whens: list[tuple[AstNode, AstNode]] = []
            while self.consume_keyword("WHEN"):
                cond = self.parse_expr()
                self.expect_keyword("THEN")
                whens.append((cond, self.parse_expr()))
            if not whens:
                raise ParserError("CASE requires at least one WHEN clause")
            else_e = self.parse_expr() if self.consume_keyword("ELSE") else None
            self.expect_keyword("END")
            return SQLCase(operand, tuple(whens), else_e)
        if up == "DATE":
            lt = self.peek()
            if lt.kind is Tok.STRING:
                from datafusion_tpu_torch.sql.ast import SQLDate

                self.next()
                return SQLDate(lt.value)
            # plain identifier named "date" otherwise
        if up == "INTERVAL":
            lt = self.peek()
            if lt.kind is Tok.STRING:
                from datafusion_tpu_torch.sql.ast import SQLInterval

                self.next()
                parts = lt.value.strip().split()
                try:
                    n = int(parts[0])
                except (ValueError, IndexError):
                    raise ParserError(
                        f"INTERVAL value must be an integer, got {lt.value!r}"
                    )
                unit = parts[1] if len(parts) > 1 else None
                if unit is None:
                    t = self.peek()
                    if t.kind is not Tok.IDENT:
                        raise ParserError("INTERVAL requires a unit")
                    self.next()
                    unit = t.value
                unit = unit.upper().rstrip("S")  # DAYS → DAY
                if unit not in (
                    "YEAR", "MONTH", "WEEK", "DAY", "HOUR", "MINUTE", "SECOND"
                ):
                    raise ParserError(f"unsupported INTERVAL unit {unit!r}")
                return SQLInterval(n, unit)
            # plain identifier named "interval" otherwise
        if up == "TIMESTAMP":
            lt = self.peek()
            if lt.kind is Tok.STRING:
                from datafusion_tpu_torch.sql.ast import SQLTimestamp

                self.next()
                return SQLTimestamp(lt.value)
            # plain identifier named "timestamp" otherwise
        if up == "EXTRACT" and self.peek().kind is Tok.OP and self.peek().value == "(":
            # EXTRACT(unit FROM expr) sugar for unit(expr)
            self.next()
            unit = self.expect_ident()
            if unit.upper() not in (
                "YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND",
                "DOW", "DOY", "QUARTER", "WEEK", "EPOCH",
            ):
                raise ParserError(
                    f"EXTRACT supports YEAR/MONTH/DAY/HOUR/MINUTE/SECOND/"
                    f"DOW/DOY/QUARTER/WEEK/EPOCH, got {unit!r}"
                )
            self.expect_keyword("FROM")
            inner = self.parse_expr()
            self.expect_op(")")
            return SQLFunction(unit.lower(), (inner,), False)
        if up == "EXISTS":
            from datafusion_tpu_torch.sql.ast import SQLExists

            self.expect_op("(")
            nt = self.peek()
            if not (nt.kind is Tok.IDENT and nt.upper in ("SELECT", "WITH")):
                raise ParserError("EXISTS requires a (SELECT ...) subquery")
            sub = self._parse_select_set()
            self.expect_op(")")
            return SQLExists(sub)
        if up == "NOT":
            return SQLUnary("Not", self.parse_expr(15))
        if up == "NULL":
            return SQLIdentifier("NULL")
        if up == "TRUE":
            return SQLIdentifier("TRUE")
        if up == "FALSE":
            return SQLIdentifier("FALSE")
        if up in _RESERVED_STOP:
            # LEFT/RIGHT are JOIN keywords, but LEFT(s, n)/RIGHT(s, n)
            # with an immediate '(' are the string functions
            if not (
                up in ("LEFT", "RIGHT")
                and self.peek().kind is Tok.OP
                and self.peek().value == "("
            ):
                raise ParserError(
                    f"unexpected keyword {t.value!r} at offset {t.pos}, "
                    "expected an expression"
                )
        # function call?
        if self.peek().kind is Tok.OP and self.peek().value == "(":
            self.next()
            distinct = self.consume_keyword("DISTINCT")
            args: list[AstNode] = []
            if not self.consume_op(")"):
                while True:
                    args.append(self.parse_expr())
                    if self.consume_op(","):
                        continue
                    self.expect_op(")")
                    break
            fn_node = SQLFunction(t.value, tuple(args), distinct)
            if up in ("PERCENTILE_CONT", "PERCENTILE_DISC") and self.consume_keywords(
                "WITHIN", "GROUP"
            ):
                # ordered-set sugar: PERCENTILE_CONT(q) WITHIN GROUP
                # (ORDER BY x) = PERCENTILE(x, q); DESC flips q
                self.expect_op("(")
                self.expect_keyword("ORDER")
                self.expect_keyword("BY")
                target = self.parse_expr()
                desc = False
                if self.consume_keyword("DESC"):
                    desc = True
                else:
                    self.consume_keyword("ASC")
                self.expect_op(")")
                if len(args) != 1:
                    raise ParserError(
                        f"{t.value} expects one fraction argument"
                    )
                qarg = args[0]
                if desc and up == "PERCENTILE_CONT":
                    # CONT(q) over DESC order == CONT(1-q) over ASC order
                    # exactly (linear interpolation is symmetric)
                    if not isinstance(qarg, (SQLDouble, SQLLong)):
                        raise ParserError(
                            f"{t.value} fraction must be a literal"
                        )
                    qarg = SQLDouble(1.0 - float(qarg.value))
                if up == "PERCENTILE_DISC":
                    # DISC is NOT symmetric under q -> 1-q (off by one
                    # whenever q*n lands on a cumulative-fraction
                    # boundary): DESC keeps q and plans a desc variant
                    # whose ascending-order position is n - ceil(q*n)
                    fn = "percentile_disc_desc" if desc else "percentile_disc"
                else:
                    fn = "percentile"
                return SQLFunction(fn, (target, qarg), False)
            if self.consume_keyword("OVER"):
                return self._parse_over(fn_node)
            return fn_node
        # compound identifier a.b
        if self.peek().kind is Tok.OP and self.peek().value == ".":
            self.next()
            name = self.expect_ident()
            return SQLCompoundIdentifier(t.value, name)
        return SQLIdentifier(t.value)

    def _parse_over(self, fn_node: SQLFunction) -> AstNode:
        """OVER ([PARTITION BY e, ...] [ORDER BY e [ASC|DESC], ...])."""
        from datafusion_tpu_torch.sql.ast import SQLWindowExpr

        self.expect_op("(")
        partition: list[AstNode] = []
        if self.consume_keywords("PARTITION", "BY"):
            partition.append(self.parse_expr())
            while self.consume_op(","):
                partition.append(self.parse_expr())
        order: list[SQLOrderByExpr] = []
        if self.consume_keywords("ORDER", "BY"):
            while True:
                e = self.parse_expr()
                asc = True
                if self.consume_keyword("DESC"):
                    asc = False
                elif self.consume_keyword("ASC"):
                    asc = True
                order.append(SQLOrderByExpr(e, asc, self._parse_nulls_order()))
                if not self.consume_op(","):
                    break
        frame = None
        if self.consume_keyword("RANGE"):
            raise ParserError(
                "RANGE frames are not supported; use ROWS (the engine's "
                "running aggregates already use ROWS semantics)"
            )
        if self.consume_keyword("ROWS"):
            if self.consume_keyword("BETWEEN"):
                lo = self._parse_frame_bound("start")
                self.expect_keyword("AND")
                hi = self._parse_frame_bound("end")
            else:
                lo = self._parse_frame_bound("start")
                hi = 0  # short form: BETWEEN <bound> AND CURRENT ROW
            if lo is not None and hi is not None and lo > hi:
                raise ParserError(
                    f"window frame start ({lo}) is after its end ({hi})"
                )
            frame = (lo, hi)
        self.expect_op(")")
        return SQLWindowExpr(fn_node, tuple(partition), tuple(order), frame)

    def _parse_frame_bound(self, which: str) -> Optional[int]:
        """One ROWS frame bound → row offset relative to the current row
        (negative = preceding, None = unbounded in that direction).
        `which` ('start'|'end') rejects the two invalid unbounded
        placements (ANSI: UNBOUNDED FOLLOWING cannot start a frame,
        UNBOUNDED PRECEDING cannot end one)."""
        if self.consume_keywords("UNBOUNDED", "PRECEDING"):
            if which == "end":
                raise ParserError(
                    "UNBOUNDED PRECEDING is not a valid frame end bound"
                )
            return None
        if self.consume_keywords("UNBOUNDED", "FOLLOWING"):
            if which == "start":
                raise ParserError(
                    "UNBOUNDED FOLLOWING is not a valid frame start bound"
                )
            return None
        if self.consume_keywords("CURRENT", "ROW"):
            return 0
        t = self.next()
        if t.kind is not Tok.NUMBER or "." in t.value:
            raise ParserError(
                f"expected a frame bound, found {t.value!r} at offset {t.pos}"
            )
        n = int(t.value)
        if self.consume_keyword("PRECEDING"):
            return -n
        if self.consume_keyword("FOLLOWING"):
            return n
        raise ParserError("expected PRECEDING or FOLLOWING after frame offset")

    def _parse_infix(self, left: AstNode, precedence: int) -> AstNode:
        t = self.next()
        if t.kind is Tok.OP and t.value == "||":
            # string concatenation operator desugars to CONCAT
            return SQLFunction(
                "concat", (left, self.parse_expr(precedence)), False
            )
        if t.kind is Tok.OP and t.value in _BINOP_NAME:
            return SQLBinaryExpr(left, _BINOP_NAME[t.value], self.parse_expr(precedence))
        if t.kind is Tok.IDENT:
            up = t.upper
            if up in ("AND", "OR", "LIKE"):
                return SQLBinaryExpr(left, _BINOP_NAME[up], self.parse_expr(precedence))
            if up == "IN":
                return self._parse_in_list(left, negated=False)
            if up == "BETWEEN":
                return self._parse_between(left, negated=False)
            if up == "NOT" and self.consume_keyword("LIKE"):
                return SQLBinaryExpr(left, "NotLike", self.parse_expr(precedence))
            if up == "NOT" and self.consume_keyword("IN"):
                return self._parse_in_list(left, negated=True)
            if up == "NOT" and self.consume_keyword("BETWEEN"):
                return self._parse_between(left, negated=True)
            if up == "IS":
                if self.consume_keywords("NOT", "DISTINCT", "FROM"):
                    return _is_distinct_from(
                        left, self.parse_expr(precedence), negated=True
                    )
                if self.consume_keywords("DISTINCT", "FROM"):
                    return _is_distinct_from(
                        left, self.parse_expr(precedence), negated=False
                    )
                if self.consume_keywords("NOT", "NULL"):
                    return SQLIsNotNull(left)
                if self.consume_keyword("NULL"):
                    return SQLIsNull(left)
                raise ParserError(
                    "expected NULL, NOT NULL, or [NOT] DISTINCT FROM after IS"
                )
        raise ParserError(f"unexpected infix token {t.value!r} at offset {t.pos}")


def _is_distinct_from(left: AstNode, right: AstNode, negated: bool) -> AstNode:
    """x IS [NOT] DISTINCT FROM y — null-safe comparison (beyond the
    reference), desugared onto CASE: two NULLs compare equal, one NULL
    compares unequal, else ordinary =/<>. Never returns NULL."""
    from datafusion_tpu_torch.sql.ast import SQLCase

    both_null = SQLBinaryExpr(SQLIsNull(left), "And", SQLIsNull(right))
    either_null = SQLBinaryExpr(SQLIsNull(left), "Or", SQLIsNull(right))
    t: AstNode = SQLIdentifier("TRUE")
    f: AstNode = SQLIdentifier("FALSE")
    if negated:  # IS NOT DISTINCT FROM = null-safe equality
        return SQLCase(
            None,
            ((both_null, t), (either_null, f)),
            SQLBinaryExpr(left, "Eq", right),
        )
    return SQLCase(
        None,
        ((both_null, f), (either_null, t)),
        SQLBinaryExpr(left, "NotEq", right),
    )


def _hoist_trailing_order(node: AstNode) -> AstNode:
    """ANSI: a trailing ORDER BY/LIMIT/OFFSET after a set operation
    applies to the WHOLE compound, not the last operand. The grammar
    attaches them to the right-most SELECT, so strip them there and
    re-apply via a pass-through wrapper over the compound."""
    import dataclasses

    from datafusion_tpu_torch.sql.ast import (
        SQLDerivedTable,
        SQLSetOp,
        SQLUnion,
        SQLSelect,
    )

    def strip_last(n):
        if isinstance(n, SQLUnion):
            right, moved = strip_last(n.right)
            return SQLUnion(n.left, right, n.all), moved
        if isinstance(n, SQLSetOp):
            right, moved = strip_last(n.right)
            return SQLSetOp(n.op, n.left, right, n.all), moved
        assert isinstance(n, SQLSelect)
        if not (n.order_by or n.limit is not None or n.offset is not None):
            return n, None
        moved = (n.order_by, n.limit, n.offset)
        return (
            dataclasses.replace(n, order_by=(), limit=None, offset=None),
            moved,
        )

    stripped, moved = strip_last(node)
    if moved is None:
        return node
    order_by, limit, offset = moved
    return SQLSelect(
        projection=(SQLWildcard(),),
        distinct=False,
        relation=SQLDerivedTable(stripped, "__setop"),
        selection=None,
        group_by=(),
        having=None,
        order_by=order_by,
        limit=limit,
        offset=offset,
    )


def parse_sql(sql: str) -> AstNode:
    """Parse one SQL statement (reference: DFParser::parse_sql, dfparser.rs:74)."""
    p = Parser(sql)
    node = p.parse_statement()
    p.consume_op(";")
    t = p.peek()
    if t.kind is not Tok.EOF:
        raise ParserError(f"unexpected trailing token {t.value!r} at offset {t.pos}")
    return node


def parse_statements(script: str) -> list[AstNode]:
    """Parse a semicolon-separated script (reference: console --script mode,
    src/bin/console/main.rs:41-63)."""
    out = []
    p = Parser(script)
    while p.peek().kind is not Tok.EOF:
        out.append(p.parse_statement())
        while p.consume_op(";"):
            pass
    return out
