"""SQLTransformer: a SQL-statement feature stage (restricted grammar).

Counterpart of ``sntc_tpu/feature/sql_transformer.py`` (Spark's
``SQLTransformer``): ``statement`` is a SQL string with the placeholder
``__THIS__`` for the input, e.g. ``SELECT *, (v1 + v2) AS v3 FROM
__THIS__ WHERE v1 > 2``.  As in the JAX package there is no SQL engine;
the stage takes the grammar of the transformer's pipeline uses:

    SELECT <item> [, <item> ...] FROM __THIS__ [WHERE <condition>]

where ``<item>`` is ``*``, a column name, or ``<expression> AS name``,
and expressions and conditions are arithmetic, comparison and boolean
combinations of scalar columns and literals; the SQL spellings ``=``,
``<>``, ``AND``/``OR``/``NOT`` are rewritten to ``pandas.eval``'s
(pandas is imported at the first transform).  Column names with spaces
(the CICIDS2017 flow schema's) take backticks, Spark's own quoting:
``SELECT (`Destination Port` * 2) AS dp2 FROM __THIS__``.  Anything else
(joins, aggregates, UDFs, nested selects) raises ``ValueError``.  Host
work.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param

_STMT = re.compile(
    r"^\s*SELECT\s+(?P<items>.+?)\s+FROM\s+__THIS__"
    r"(?:\s+WHERE\s+(?P<where>.+?))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)


def _outside_quotes(s: str, fn) -> str:
    """Apply ``fn`` to every segment of ``s`` OUTSIDE single-quoted
    string literals and backtick-quoted identifiers — operator
    rewriting must never touch either.  The SQL escaped quote ``''``
    inside a literal stays inside it and is rewritten to the Python
    escape ``\\'`` pandas.eval understands."""
    out: List[str] = []
    seg: List[str] = []
    state = None  # None | "'" | "`"
    i, n = 0, len(s)
    while i < n:
        ch = s[i]
        if state is None:
            if ch in ("'", "`"):
                out.append(fn("".join(seg)))
                seg = []
                out.append(ch)
                state = ch
            else:
                seg.append(ch)
        elif state == "'" and ch == "'" and i + 1 < n and s[i + 1] == "'":
            out.append("\\'")  # SQL '' -> Python \' (still in literal)
            i += 2
            continue
        else:
            out.append(ch)
            if ch == state:
                state = None
        i += 1
    out.append(fn("".join(seg)))
    return "".join(out)


def _sqlize(expr: str) -> str:
    """SQL operator spellings → pandas.eval spellings (outside quotes):
    ``<>`` → ``!=``, bare ``=`` → ``==`` (leaves ``==``/``<=``/``>=``/
    ``!=`` alone), ``AND``/``OR``/``NOT`` (any case) → lowercase."""

    def rewrite(seg: str) -> str:
        seg = seg.replace("<>", "!=")
        seg = re.sub(r"(?<![<>!=])=(?!=)", "==", seg)
        for kw in ("and", "or", "not"):
            seg = re.sub(rf"\b{kw}\b", kw, seg, flags=re.IGNORECASE)
        return seg

    return _outside_quotes(expr, rewrite)


def _split_items(items: str) -> List[str]:
    """Split the select list on top-level commas — parentheses nest,
    and commas inside string literals (incl. SQL ``''`` escapes) or
    backticked names don't split."""
    out, depth, cur = [], 0, []
    state = None  # None | "'" | "`"
    i, n = 0, len(items)
    while i < n:
        ch = items[i]
        if state is None:
            if ch in ("'", "`"):
                state = ch
            elif ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                out.append("".join(cur).strip())
                cur = []
                i += 1
                continue
        elif state == "'" and ch == "'" and i + 1 < n and items[i + 1] == "'":
            cur.append("''")
            i += 2
            continue
        elif ch == state:
            state = None
        cur.append(ch)
        i += 1
    if cur:
        out.append("".join(cur).strip())
    return [s for s in out if s]


def _eval(df, expr: str, n: int) -> np.ndarray:
    """Evaluate one expression against the scalar columns, broadcasting
    literal constants to the row count; evaluator failures surface as
    grammar errors."""
    try:
        val = df.eval(_sqlize(expr))
    except Exception as e:  # pandas raises a zoo of parser error types
        raise ValueError(
            f"cannot evaluate expression {expr!r} (restricted "
            f"SQLTransformer grammar): {e}"
        ) from e
    arr = np.asarray(val)
    if arr.ndim == 0:
        arr = np.full(n, arr[()])
    if arr.ndim != 1 or arr.shape[0] != n:
        raise ValueError(
            f"expression {expr!r} did not produce one value per row"
        )
    return arr


class SQLTransformer(Transformer):
    statement = Param(
        "SELECT <items> FROM __THIS__ [WHERE <cond>] (restricted grammar "
        "— see module docstring)",
        default=None,
    )

    def transform(self, frame: Frame) -> Frame:
        stmt = self.getStatement()
        if not stmt:
            raise ValueError("statement must be set")
        m = _STMT.match(stmt)
        if not m:
            raise ValueError(
                f"unsupported statement {stmt!r}: expected "
                "'SELECT <items> FROM __THIS__ [WHERE <cond>]'"
            )
        import pandas as pd

        scalar_cols = [c for c in frame.columns if frame[c].ndim == 1]
        df = pd.DataFrame({c: to_host(frame[c]) for c in scalar_cols})

        where = m.group("where")
        src = frame
        if where:
            mask = np.asarray(
                _eval(df, where, frame.num_rows), bool
            )
            src = frame.filter(mask)
            df = df[mask]

        out_cols = {}
        for item in _split_items(m.group("items")):
            if item == "*":
                for c in src.columns:
                    out_cols[c] = src[c]
                continue
            as_m = re.match(
                r"^(?P<expr>.+?)\s+AS\s+(?P<name>\w+|`[^`]+`)$", item,
                re.IGNORECASE | re.DOTALL,
            )
            bare = re.fullmatch(r"\w+|`[^`]+`", item)
            if as_m:
                expr, name = as_m.group("expr"), as_m.group("name")
                out_cols[name.strip("`")] = _eval(df, expr, src.num_rows)
            elif bare:
                col = item.strip("`")
                if col not in src:
                    raise ValueError(f"unknown column {col!r}")
                out_cols[col] = src[col]
            else:
                raise ValueError(
                    f"select item {item!r} needs 'AS <name>' (bare "
                    "expressions have no output column name)"
                )
        return Frame(out_cols)
