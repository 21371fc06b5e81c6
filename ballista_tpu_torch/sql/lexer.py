"""SQL tokenizer."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..errors import SqlError

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "like", "between", "is", "null",
    "case", "when", "then", "else", "end", "cast", "distinct", "asc",
    "desc", "join", "inner", "left", "right", "full", "outer", "semi",
    "anti", "on", "date", "interval", "extract", "union", "all", "exists",
    "create", "external", "table", "stored", "location", "with", "header",
    "row", "nulls", "first", "last", "true", "false", "offset", "using",
}

# Soft (contextual) keywords: only special at statement position, so
# schemas with columns named e.g. ``verbose`` keep parsing (they lex as
# plain identifiers; the parser matches them by value where relevant).
SOFT_KEYWORDS = {"explain", "verbose", "analyze"}

TWO_CHAR_OPS = ("<=", ">=", "<>", "!=", "||")
ONE_CHAR_OPS = "+-*/%(),.;=<>"


@dataclass
class Token:
    kind: str  # kw | ident | number | string | op | eof
    value: str
    pos: int

    def is_kw(self, *names: str) -> bool:
        return self.kind == "kw" and self.value in names

    def __repr__(self):  # pragma: no cover
        return f"{self.kind}:{self.value}"


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # line comment
            while i < n and sql[i] != "\n":
                i += 1
            continue
        if c == "'":  # string literal (with '' escape)
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            if j >= n:
                raise SqlError(f"unterminated string at {i}")
            out.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':  # quoted identifier
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlError(f"unterminated quoted identifier at {i}")
            out.append(Token("ident", sql[i + 1 : j], i))
            i = j + 1
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
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    nxt = sql[j + 1] if j + 1 < n else ""
                    if nxt.isdigit() or nxt in "+-":
                        seen_exp = True
                        j += 2 if nxt in "+-" else 1
                    else:
                        break
                else:
                    break
            out.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            low = word.lower()
            if low in KEYWORDS:
                out.append(Token("kw", low, i))
            else:
                out.append(Token("ident", word, i))
            i = j
            continue
        if sql[i : i + 2] in TWO_CHAR_OPS:
            out.append(Token("op", sql[i : i + 2], i))
            i += 2
            continue
        if c in ONE_CHAR_OPS:
            out.append(Token("op", c, i))
            i += 1
            continue
        raise SqlError(f"unexpected character {c!r} at position {i}")
    out.append(Token("eof", "", n))
    return out
