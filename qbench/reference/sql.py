"""SQL pieces the queries beyond the integration set need, over the
generator's columns (``qbench/data/generate.py``): a string column is a
``Coded`` column (codes into a short list) or an Arrow string array.

``like`` is SQL ``LIKE`` (``%`` any run, ``_`` one character, case
sensitive), ``prefix`` is ``substring(col, 1, n)``, ``year`` is
``extract(year from date)``; ``minus`` subtracts two decimals of one
scale; ``codes`` numbers a string column's distinct values in ascending
order, for grouping by it.
"""

from __future__ import annotations

import numpy as np

from qbench.reference import lookup


def _is_coded(col) -> bool:
    return hasattr(col, "codes") and hasattr(col, "values")


def strings(col, rows=None) -> np.ndarray:
    """The column's values at ``rows`` (all rows when None) as Python
    strings in an object array."""
    if _is_coded(col):
        return col.strings(rows)
    if rows is not None:
        import pyarrow as pa

        col = col.take(pa.array(np.asarray(rows, dtype=np.int64)))
    return np.asarray(col.to_pylist(), dtype=object)


def like(col, pattern: str) -> np.ndarray:
    """Boolean mask of the rows whose value matches SQL ``LIKE pattern``."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if _is_coded(col):
        hit = pc.match_like(pa.array(list(col.values)), pattern)
        return np.asarray(hit.to_pylist(), dtype=bool)[col.codes]
    return pc.match_like(col, pattern).to_numpy(zero_copy_only=False)


def prefix(col, n: int):
    """``substring(col, 1, n)`` of an Arrow string column, as an Arrow
    string column."""
    import pyarrow.compute as pc

    return pc.utf8_slice_codeunits(col, 0, n)


def codes(col):
    """(codes, values): each row's rank among the column's distinct
    values, and those values in ascending order."""
    if _is_coded(col):
        values, row_codes = list(col.values), col.codes
    else:
        import pyarrow.compute as pc

        enc = pc.dictionary_encode(col)
        values = enc.dictionary.to_pylist()
        row_codes = enc.indices.to_numpy(zero_copy_only=False)
    values = np.asarray(values, dtype=object)
    order = np.argsort(values.astype(str), kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return rank[np.asarray(row_codes, dtype=np.int64)], values[order]


def year(days: np.ndarray) -> np.ndarray:
    """``extract(year from d)`` of days since 1970-01-01."""
    d = np.asarray(days).astype("datetime64[D]")
    return d.astype("datetime64[Y]").astype(np.int64) + 1970


def minus(a, b):
    """``a - b`` of two ``Num`` values of one scale."""
    assert a[1] == b[1], (a[1], b[1])
    return (a[0] - b[0], a[1])


def nation_rows(t, name: str) -> np.ndarray:
    """Row indices of ``nation`` whose ``n_name`` is ``name``."""
    n = t["nation"]["n_name"]
    return np.flatnonzero(n.codes == n.code_of(name))


def find(keys: np.ndarray, probe: np.ndarray):
    """``lookup``'s (index, found) of each probe key in an ascending key
    column, computed directly where the keys step evenly (the TPC-H
    primary keys the generator writes), else by binary search."""
    keys, probe = np.asarray(keys), np.asarray(probe)
    n = len(keys)
    if n >= 2:
        step = int(keys[1] - keys[0])
        if step > 0 and (np.diff(keys) == step).all():
            off = probe - keys[0]
            idx = off // step
            found = (off % step == 0) & (idx >= 0) & (idx < n)
            return np.clip(idx, 0, n - 1), found
    return lookup(keys, probe)


def groups(keys: np.ndarray):
    """``group_ids`` of one integer key column: (ids, first row of each
    group), groups in ascending key order."""
    _, first, ids = np.unique(np.asarray(keys, dtype=np.int64),
                              return_index=True, return_inverse=True)
    return ids.reshape(-1), first
