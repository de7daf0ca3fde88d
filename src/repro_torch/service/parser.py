"""BlinkQL: the paper's §2 SQL dialect, parsed onto the engine's Query types
(counterpart of `repro.service.parser`, pure Python).

Grammar (keywords case-insensitive; one statement per string):

    SELECT <agg> FROM <table>
        [WHERE <atom> {AND <atom>} {OR <atom> {AND <atom>}}]
        [GROUP BY <column>]
        [ERROR WITHIN <e>% [AT] CONFIDENCE <c>%
         | ERROR WITHIN <abs> [[AT] CONFIDENCE <c>%]
         | WITHIN <s> SECONDS [[AT] CONFIDENCE <c>%]]

    EXPLAIN <select-statement>
    SHOW METRICS [FORMAT {JSON | PROMETHEUS}]

    <agg>  := COUNT(*) | COUNT(<column>) | SUM(<column>) | AVG(<column>)
              | QUANTILE(<column>, <q>)
    <atom> := <column> <op> <literal>      with <op> in = == != <> < <= > >=

`parse_blinkql` parses SELECT statements only (onto `Query`); the service
statements (EXPLAIN, SHOW METRICS — docs/OBSERVABILITY.md) go through
`parse_statement`, which `BlinkQLService.execute` uses.

WHERE is DNF by precedence (AND binds tighter than OR), mapping 1:1 onto
`Predicate(disjuncts=(Conjunction(atoms), ...))` — exactly the §4.1
query shapes the engine executes.

Resolution is schema-aware: table and column names are checked against the
registered `Table`s (with did-you-mean suggestions), categorical literals are
coerced to the column DICTIONARY's dtype (so `City = '17'` on an int-valued
dictionary compares 17, not "17"), numeric literals must parse as floats, and
GROUP BY must name a categorical column. Every rejection raises
`BlinkQLError` carrying the offending token and its position in the text.
"""
from __future__ import annotations

import dataclasses
import difflib
import re
from typing import Any

import numpy as np

from repro_torch.core.types import (AggOp, Atom, CmpOp, ColumnKind, Conjunction,
                              ErrorBound, Predicate, Query, TimeBound)


class BlinkQLError(ValueError):
    """A BlinkQL parse/resolution failure, with position context."""


_OPS = {"=": CmpOp.EQ, "==": CmpOp.EQ, "!=": CmpOp.NE, "<>": CmpOp.NE,
        "<": CmpOp.LT, "<=": CmpOp.LE, ">": CmpOp.GT, ">=": CmpOp.GE}

_AGGS = {"COUNT": AggOp.COUNT, "SUM": AggOp.SUM, "AVG": AggOp.AVG,
         "QUANTILE": AggOp.QUANTILE, "PERCENTILE": AggOp.QUANTILE}

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<string>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
    | (?P<number>-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)
    | (?P<op><=|>=|==|!=|<>|[=<>])
    | (?P<punct>[(),*%])
    | (?P<word>[A-Za-z_][A-Za-z_0-9.]*)
    | (?P<bad>\S)
    )""", re.VERBOSE)


def _tokenize(text: str) -> list[tuple[str, str, int]]:
    out = []
    for m in _TOKEN_RE.finditer(text):
        kind = m.lastgroup
        if kind == "bad":
            raise BlinkQLError(
                f"unexpected character {m.group()!r} at position {m.start()}")
        out.append((kind, m.group().strip(), m.start(m.lastgroup)))
    return out


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = _tokenize(text)
        self.i = 0

    # -- token plumbing ------------------------------------------------------
    def _fail(self, msg: str) -> BlinkQLError:
        if self.i < len(self.toks):
            _, val, pos = self.toks[self.i]
            where = f" at position {pos} (near {val!r})"
        else:
            where = " at end of statement"
        return BlinkQLError(msg + where)

    def peek(self) -> tuple[str, str] | None:
        if self.i >= len(self.toks):
            return None
        kind, val, _ = self.toks[self.i]
        return kind, val

    def at_keyword(self, *words: str) -> bool:
        t = self.peek()
        return t is not None and t[0] == "word" and t[1].upper() in words

    def take(self) -> tuple[str, str]:
        if self.i >= len(self.toks):
            raise self._fail("unexpected end of statement")
        kind, val, _ = self.toks[self.i]
        self.i += 1
        return kind, val

    def expect_keyword(self, word: str) -> None:
        if not self.at_keyword(word):
            raise self._fail(f"expected {word}")
        self.take()

    def expect_punct(self, ch: str) -> None:
        t = self.peek()
        if t is None or t[0] != "punct" or t[1] != ch:
            raise self._fail(f"expected {ch!r}")
        self.take()

    def expect_number(self, what: str) -> float:
        t = self.peek()
        if t is None or t[0] != "number":
            raise self._fail(f"expected a number for {what}")
        _, val = self.take()
        return float(val)

    def expect_identifier(self, what: str) -> str:
        t = self.peek()
        if t is None or t[0] != "word":
            raise self._fail(f"expected {what}")
        _, val = self.take()
        return val


def _suggest(name: str, known) -> str:
    close = difflib.get_close_matches(name, list(known), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


_UNESCAPE_RE = re.compile(r"\\(.)")


def _unquote(raw: str) -> str:
    """Strip the quotes and resolve backslash escapes ('O\\'Hare' → O'Hare)."""
    return _UNESCAPE_RE.sub(r"\1", raw[1:-1])


def _literal_for_column(tbl, col: str, kind: str, raw: str) -> Any:
    """Schema-aware literal resolution: coerce the token to what the engine's
    encode path expects for this column — the dictionary's value dtype for
    categoricals, float for measures."""
    schema = tbl.schema.column(col)
    if schema.kind is ColumnKind.NUMERIC:
        if kind == "string":
            raise BlinkQLError(
                f"column {col!r} of table {tbl.schema.name!r} is numeric; "
                f"string literal {raw!r} does not compare")
        try:
            return float(raw)
        except ValueError:
            raise BlinkQLError(
                f"literal {raw!r} does not parse as a number for numeric "
                f"column {col!r} (quote string values)") from None
    dict_vals = tbl.dictionaries[col]
    text = _unquote(raw) if kind == "string" else raw
    if dict_vals.dtype.kind in ("U", "S", "O"):
        return str(text)
    try:
        if dict_vals.dtype.kind in ("i", "u"):
            f = float(text)
            if f != int(f):
                raise BlinkQLError(
                    f"literal {raw!r} is fractional but column {col!r}'s "
                    f"dictionary holds integers — truncating would silently "
                    f"match the wrong value")
            return int(f)
        return np.asarray(text).astype(dict_vals.dtype)[()]
    except BlinkQLError:
        raise                      # already precise (it IS a ValueError)
    except (TypeError, ValueError) as e:
        raise BlinkQLError(
            f"literal {raw!r} does not convert to the "
            f"{dict_vals.dtype} dictionary of column {col!r}") from e


@dataclasses.dataclass(frozen=True)
class ShowMetrics:
    """SHOW METRICS [FORMAT {JSON|PROMETHEUS}] — export the metrics plane."""
    fmt: str = "json"              # "json" | "prometheus"


@dataclasses.dataclass(frozen=True)
class Explain:
    """EXPLAIN <select> — execute with forced tracing, return answer + plan."""
    query: Query
    text: str                      # the inner SELECT, as written


def parse_statement(text: str, db) -> Query | ShowMetrics | Explain:
    """Parse one BlinkQL statement of ANY kind: a SELECT (returned as the
    engine `Query`), SHOW METRICS, or EXPLAIN <select>. This is the entry
    point `BlinkQLService.execute` uses; `parse_blinkql` stays SELECT-only
    for callers that want a `Query` and nothing else."""
    p = _Parser(text)
    if p.at_keyword("SHOW"):
        p.take()
        p.expect_keyword("METRICS")
        fmt = "json"
        if p.at_keyword("FORMAT"):
            p.take()
            t = p.peek()
            if t is None or t[0] != "word" \
                    or t[1].upper() not in ("JSON", "PROMETHEUS"):
                raise p._fail("expected JSON or PROMETHEUS after FORMAT")
            fmt = p.take()[1].lower()
        if p.peek() is not None:
            raise p._fail("unexpected trailing input after SHOW METRICS")
        return ShowMetrics(fmt)
    if p.at_keyword("EXPLAIN"):
        p.take()
        if p.i >= len(p.toks):
            raise p._fail("EXPLAIN needs a statement to explain")
        inner = text[p.toks[p.i][2]:]
        return Explain(query=parse_blinkql(inner, db), text=inner.strip())
    return parse_blinkql(text, db)


def parse_blinkql(text: str, db) -> Query:
    """Parse one BlinkQL SELECT against a BlinkDB's registered tables.
    Returns the engine `Query` (un-normalized; the service normalizes for
    cache/workload keys). Raises BlinkQLError with position context on any
    syntactic or schema/dictionary resolution failure. Service statements
    (SHOW METRICS, EXPLAIN) are rejected here — route those through
    `parse_statement` / `BlinkQLService.execute`."""
    p = _Parser(text)
    if p.at_keyword("SHOW", "EXPLAIN"):
        raise p._fail("service statement — use BlinkQLService.execute "
                      "(parse_blinkql parses SELECT only)")
    p.expect_keyword("SELECT")

    agg_word = p.expect_identifier("an aggregate (COUNT/SUM/AVG/QUANTILE)")
    agg = _AGGS.get(agg_word.upper())
    if agg is None:
        raise BlinkQLError(
            f"unknown aggregate {agg_word!r}"
            f"{_suggest(agg_word.upper(), _AGGS)}")
    p.expect_punct("(")
    value_column: str | None = None
    quantile = 0.5
    t = p.peek()
    if t is not None and t == ("punct", "*"):
        if agg is not AggOp.COUNT:
            raise p._fail(f"{agg_word.upper()}(*) is only valid for COUNT")
        p.take()
    else:
        value_column = p.expect_identifier("a column name")
    if agg is AggOp.QUANTILE:
        if value_column is None:
            raise p._fail("QUANTILE needs a column")
        p.expect_punct(",")
        quantile = p.expect_number("the quantile level")
        if not 0.0 < quantile < 1.0:
            raise BlinkQLError(
                f"quantile level must be in (0, 1), got {quantile}")
    elif agg is not AggOp.COUNT and value_column is None:
        raise p._fail(f"{agg_word.upper()} needs a column")
    p.expect_punct(")")

    p.expect_keyword("FROM")
    table_name = p.expect_identifier("a table name")
    if table_name not in db.tables:
        raise BlinkQLError(
            f"unknown table {table_name!r}"
            f"{_suggest(table_name, db.tables)}; registered tables: "
            f"{sorted(db.tables)}")
    tbl = db.tables[table_name]

    def resolve_column(name: str, context: str) -> str:
        if "." in name:
            raise BlinkQLError(
                f"qualified column {name!r} in {context}: joined dimension "
                "attributes require the programmatic API (Query.joins)")
        try:
            tbl.schema.column(name)
        except KeyError:
            raise BlinkQLError(
                f"unknown column {name!r} in {context} of table "
                f"{table_name!r}{_suggest(name, tbl.schema.column_names)}; "
                f"columns: {list(tbl.schema.column_names)}") from None
        return name

    if value_column is not None:
        resolve_column(value_column, f"{agg_word.upper()}()")
        if agg is not AggOp.COUNT and (tbl.schema.column(value_column).kind
                                       is not ColumnKind.NUMERIC):
            raise BlinkQLError(
                f"{agg_word.upper()}({value_column}) aggregates a "
                f"categorical column — its dictionary codes have no "
                f"arithmetic meaning; aggregate a numeric measure or use "
                f"COUNT(*)")

    predicate = Predicate.true()
    if p.at_keyword("WHERE"):
        p.take()
        disjuncts = [_parse_conjunction(p, tbl, resolve_column)]
        while p.at_keyword("OR"):
            p.take()
            disjuncts.append(_parse_conjunction(p, tbl, resolve_column))
        predicate = Predicate(tuple(disjuncts))

    group_by: tuple[str, ...] = ()
    if p.at_keyword("GROUP"):
        p.take()
        p.expect_keyword("BY")
        cols = [resolve_column(p.expect_identifier("a GROUP BY column"),
                               "GROUP BY")]
        while p.peek() == ("punct", ","):
            p.take()
            cols.append(resolve_column(
                p.expect_identifier("a GROUP BY column"), "GROUP BY"))
        if len(cols) > 1:
            raise BlinkQLError(
                f"GROUP BY supports a single column (got {cols}); composite "
                "grouping is not implemented by the engine")
        if tbl.schema.column(cols[0]).kind is not ColumnKind.CATEGORICAL:
            raise BlinkQLError(
                f"GROUP BY column {cols[0]!r} must be categorical "
                "(dictionary-encoded); numeric measures cannot group")
        group_by = tuple(cols)

    bound = _parse_bound(p)

    t = p.peek()
    if t is not None:
        raise p._fail("unexpected trailing input")
    return Query(table_name, agg, value_column, predicate, group_by,
                 quantile, bound)


def _parse_conjunction(p: _Parser, tbl, resolve_column) -> Conjunction:
    atoms = [_parse_atom(p, tbl, resolve_column)]
    while p.at_keyword("AND"):
        p.take()
        atoms.append(_parse_atom(p, tbl, resolve_column))
    return Conjunction(tuple(atoms))


def _parse_atom(p: _Parser, tbl, resolve_column) -> Atom:
    col = resolve_column(p.expect_identifier("a column name"), "WHERE")
    t = p.peek()
    if t is None or t[0] != "op":
        raise p._fail(f"expected a comparison operator after {col!r}")
    _, op_txt = p.take()
    op = _OPS[op_txt]
    t = p.peek()
    if t is None or t[0] not in ("string", "number", "word"):
        raise p._fail(f"expected a literal after {col!r} {op_txt}")
    kind, raw = p.take()
    return Atom(col, op, _literal_for_column(tbl, col, kind, raw))


def _parse_confidence(p: _Parser, default: float = 0.95) -> float:
    """[AT] CONFIDENCE <c>% — shared tail of both bound clauses."""
    if p.at_keyword("AT"):
        p.take()
        p.expect_keyword("CONFIDENCE")
    elif p.at_keyword("CONFIDENCE"):
        p.take()
    else:
        return default
    c = p.expect_number("the confidence level")
    if p.peek() == ("punct", "%"):
        p.take()
        c = c / 100.0
    if not 0.0 < c < 1.0:
        raise BlinkQLError(f"confidence must be in (0, 1), got {c}")
    return c


def _parse_bound(p: _Parser) -> ErrorBound | TimeBound | None:
    if p.at_keyword("ERROR"):
        p.take()
        p.expect_keyword("WITHIN")
        eps = p.expect_number("the error bound")
        relative = False
        if p.peek() == ("punct", "%"):
            p.take()
            eps, relative = eps / 100.0, True
        if eps <= 0.0:
            raise BlinkQLError(f"error bound must be positive, got {eps}")
        conf = _parse_confidence(p)
        # `... OR FAIL`: strict contract — the engine must certify the bound
        # a-priori (or fall back to exact) and raises BoundUnreachableError
        # instead of serving a best-effort answer (docs/SERVICE.md).
        strict = False
        if p.at_keyword("OR"):
            p.take()
            p.expect_keyword("FAIL")
            strict = True
        return ErrorBound(eps, conf, relative, strict)
    if p.at_keyword("WITHIN"):
        p.take()
        seconds = p.expect_number("the time bound")
        if p.at_keyword("SECONDS", "SECOND"):
            p.take()
        else:
            raise p._fail("expected SECONDS")
        if seconds <= 0:
            raise BlinkQLError(f"time bound must be positive, got {seconds}")
        return TimeBound(seconds, _parse_confidence(p))
    return None
