"""Holding an answer to the reference.

An answer is a ``to_pydict()`` result: column name to array. It is held
to the reference query's whole result (before its LIMIT):

- the columns are the select list, in order;
- each row is named by the query's key columns, names a row of the
  reference, and no two rows name the same one;
- the rows are the ones the ORDER BY and LIMIT choose: every reference
  row that sorts before the last place is there, and the last places are
  filled from the rows tied for them;
- the rows come in ORDER BY order, read from the answer's own values;
- every column but the decimals equals the reference exactly.

Any of these failing makes the answer wrong. Decimal columns are read
apart, as the widest gap between a value and the reference's, in units
in the last place of the reference value (``np.spacing``): the exact
decimal arithmetic that the configuration states reads 0.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np


def _canon(x):
    """A cell as a plain Python value that compares exactly."""
    if isinstance(x, np.datetime64):
        return int(x.astype("datetime64[D]").astype(np.int64))
    if isinstance(x, (np.integer, int)) and not isinstance(x, bool):
        return int(x)
    if isinstance(x, (np.floating, float)):
        return float(x)
    if isinstance(x, np.str_):
        return str(x)
    return x


def _cells(arr) -> list:
    a = np.asarray(arr)
    if a.dtype.kind == "M":
        return [int(v) for v in a.astype("datetime64[D]").astype(np.int64)]
    return [_canon(v) for v in (a if a.dtype.kind == "O" else a.tolist())]


def _ulps(got: float, want: float) -> float:
    if got == want:
        return 0.0
    if not np.isfinite(got):
        return float("inf")
    return abs(got - want) / float(np.spacing(abs(want)))


def _before(a: tuple, b: tuple, order) -> int:
    """-1 when ORDER BY puts ``a`` first, 1 when ``b``, 0 when tied."""
    for (x, y), (_, desc) in zip(zip(a, b), order):
        if x == y:
            continue
        first = x > y if desc else x < y
        return -1 if first else 1
    return 0


class Expected:
    """One query's reference result, indexed for holding answers to it."""

    def __init__(self, module, full: Dict[str, np.ndarray]):
        self.columns = tuple(module.COLUMNS)
        self.keys = tuple(module.KEYS)
        self.decimals = set(module.DECIMALS)
        self.order = tuple(module.ORDER)
        self.limit = module.LIMIT
        self.cells = {c: _cells(full[c]) for c in self.columns}
        n = len(self.cells[self.columns[0]])
        self.index = {}
        for i in range(n):
            self.index[tuple(self.cells[k][i] for k in self.keys)] = i
        want = n if self.limit is None else min(self.limit, n)
        self.want_rows = want
        self.must, self.may = set(range(n)), set()
        if self.limit is not None and want < n:
            okey = [self._order_key(i) for i in range(n)]
            ranked = sorted(range(n), key=functools.cmp_to_key(
                lambda a, b: _before(okey[a], okey[b], self.order)))
            edge = okey[ranked[want - 1]]
            self.must = {i for i in ranked
                         if _before(okey[i], edge, self.order) < 0}
            self.may = {i for i in ranked
                        if _before(okey[i], edge, self.order) == 0}

    def _order_key(self, i: int) -> tuple:
        return tuple(self.cells[c][i] for c, _ in self.order)

    def hold(self, got) -> Tuple[Optional[str], float]:
        """(why the answer is wrong, or None; its widest decimal gap in
        units in the last place)."""
        if tuple(got) != self.columns:
            return f"columns {list(got)}", 0.0
        cells = {c: _cells(got[c]) for c in self.columns}
        n = len(cells[self.columns[0]])
        if any(len(v) != n for v in cells.values()):
            return "ragged columns", 0.0
        if n != self.want_rows:
            return f"{n} rows, want {self.want_rows}", 0.0
        rows = []
        for i in range(n):
            key = tuple(cells[k][i] for k in self.keys)
            j = self.index.get(key)
            if j is None:
                return f"row {key!r} is not in the result", 0.0
            rows.append(j)
        if len(set(rows)) != n:
            return "a row appears twice", 0.0
        chosen = set(rows)
        if not self.must <= chosen or not chosen - self.must <= self.may:
            return "not the rows that ORDER BY and LIMIT choose", 0.0
        gap = 0.0
        for c in self.columns:
            want = self.cells[c]
            for i, j in enumerate(rows):
                if c in self.decimals:
                    gap = max(gap, _ulps(cells[c][i], want[j]))
                elif cells[c][i] != want[j]:
                    return (f"{c} of row {i}: {cells[c][i]!r} != "
                            f"{want[j]!r}"), gap
        for i in range(1, n):
            a = tuple(cells[c][i - 1] for c, _ in self.order)
            b = tuple(cells[c][i] for c, _ in self.order)
            if _before(a, b, self.order) > 0:
                return f"rows {i - 1} and {i} out of order", gap
        return None, gap
