"""SQL tokenizer.

Our own implementation of the role the external `sqlparser` 0.2.1 crate's
tokenizer played for the reference (reference: Cargo.toml:34,
dfparser.rs:64-70). Produces a flat token stream for the Pratt parser.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterator

from datafusion_tpu_torch.errors import ParserError


class Tok(enum.Enum):
    IDENT = "IDENT"  # bare identifier or keyword (value holds original text)
    NUMBER = "NUMBER"  # integer or decimal literal
    STRING = "STRING"  # single-quoted string literal (value is unescaped)
    OP = "OP"  # operator or punctuation
    EOF = "EOF"


@dataclass(frozen=True)
class Token:
    kind: Tok
    value: str
    pos: int  # byte offset in the source, for error messages

    @property
    def upper(self) -> str:
        return self.value.upper()


_TWO_CHAR_OPS = {"<>", "!=", ">=", "<=", "||"}
_ONE_CHAR_OPS = set("+-*/%(),.;=<>")


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # line comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c.isalpha() or c == "_":
            j = i + 1
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            toks.append(Token(Tok.IDENT, sql[i:j], i))
            i = j
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    # don't swallow 'a.b' after a digit run that ends an ident
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                    sql[j + 1].isdigit() or (sql[j + 1] in "+-" and j + 2 < n and sql[j + 2].isdigit())
                ):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            toks.append(Token(Tok.NUMBER, sql[i:j], i))
            i = j
            continue
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise ParserError(f"unterminated string literal at offset {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":  # '' escape
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            toks.append(Token(Tok.STRING, "".join(buf), i))
            i = j + 1
            continue
        if sql[i : i + 2] in _TWO_CHAR_OPS:
            toks.append(Token(Tok.OP, sql[i : i + 2], i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS:
            toks.append(Token(Tok.OP, c, i))
            i += 1
            continue
        raise ParserError(f"unexpected character {c!r} at offset {i}")
    toks.append(Token(Tok.EOF, "", n))
    return toks
