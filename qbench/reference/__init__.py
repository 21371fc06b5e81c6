"""The plain reference: each TPC-H query of the benchmark in NumPy, one
file per query (``qbench/reference/<query>.py``), over the generator's
own column arrays, the values that the ``.tbl`` files encode. Frozen
from the pandas oracles of ``benchmarks/tpch/oracle.py``; nothing here
imports the engine under test.

Decimal arithmetic follows SQL: a decimal(15, 2) column is its cents, a
product's scale is the sum of its factors' scales, sums are exact, and
``avg`` is the exact quotient truncated toward zero at scale 6. A
decimal result leaves as ``float64(scaled integer) / 10.0**scale``, the
nearest float to the exact value's digits. ``Num(exact=False)`` is the
benchmark's control: the same query in float64, as pandas computes it.

Each query module defines ``COLUMNS`` (the select list), ``KEYS`` (the
columns that name a result row), ``DECIMALS`` (the decimal columns),
``ORDER`` (the ORDER BY, as ``(column, descending)`` pairs), ``LIMIT``
(or None) and ``compute(tables, num)``, which returns the whole result
before the LIMIT as a dict of arrays.
"""

from __future__ import annotations

import importlib.util
import os
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> types.ModuleType:
    """The reference module of query ``name`` (``qbench/reference/<name>.py``)."""
    path = os.path.join(HERE, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"qbench.reference.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def day(iso: str) -> int:
    """An ISO date as days since 1970-01-01."""
    return int(np.datetime64(iso, "D").astype(np.int64))


class Num:
    """Decimal arithmetic: exact (scaled int64) or the float64 control.

    A value is ``(array, scale)``; in the control the array holds
    floats and the scale is carried only to read the columns alike."""

    def __init__(self, exact: bool = True):
        self.exact = exact

    def col(self, cents: np.ndarray, scale: int = 2):
        if self.exact:
            return (np.asarray(cents, dtype=np.int64), scale)
        return (np.asarray(cents, dtype=np.int64) / 10.0 ** scale, scale)

    def mul(self, a, b):
        return (a[0] * b[0], a[1] + b[1])

    def one_minus(self, a):
        return ((10 ** a[1] - a[0]) if self.exact else (1.0 - a[0]), a[1])

    def one_plus(self, a):
        return ((10 ** a[1] + a[0]) if self.exact else (1.0 + a[0]), a[1])

    def take(self, a, rows):
        return (a[0][rows], a[1])

    def group_sum(self, a, groups: np.ndarray, n: int):
        """Per-group sums of ``a`` by group ids ``0..n-1``."""
        if self.exact:
            out = np.zeros(n, dtype=np.int64)
            np.add.at(out, groups, a[0])
            return (out, a[1])
        return (np.bincount(groups, weights=a[0], minlength=n), a[1])

    def total(self, a):
        return (np.asarray([a[0].sum()]), a[1])

    def avg(self, sums, counts: np.ndarray):
        """SQL ``avg``: the quotient at scale 6, truncated toward zero."""
        if not self.exact:
            return (sums[0] / counts, 6)
        m = 10 ** (6 - sums[1])
        q = [int(_trunc_div(int(s) * m, int(c))) for s, c in
             zip(sums[0], counts)]
        return (np.asarray(q, dtype=np.int64), 6)

    def out(self, a) -> np.ndarray:
        if self.exact:
            return np.asarray(a[0]).astype(np.float64) / (10.0 ** a[1])
        return np.asarray(a[0], dtype=np.float64)


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def lookup(sorted_keys: np.ndarray, probe: np.ndarray):
    """(index, found) of each probe key in an ascending key column."""
    idx = np.searchsorted(sorted_keys, probe)
    idx = np.minimum(idx, len(sorted_keys) - 1)
    found = sorted_keys[idx] == probe
    return idx, found


def group_ids(*keys: np.ndarray):
    """(ids, first row of each group) over rows keyed by ``keys``,
    groups numbered in ascending key order."""
    stacked = np.stack([np.asarray(k, dtype=np.int64) for k in keys])
    _, first, ids = np.unique(stacked, axis=1, return_index=True,
                              return_inverse=True)
    return ids.reshape(-1), first
