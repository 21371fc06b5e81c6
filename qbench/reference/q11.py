"""TPC-H q11 (important stock identification), frozen from
``oracle.py``'s ``q11``.

``value > (total * 0.0001)`` is compared exactly, in cents:
``value * 10000 > total``. (The oracle scales the total in float64.)"""

import numpy as np

from qbench.reference.sql import find, groups, nation_rows

COLUMNS = ("ps_partkey", "value")
KEYS = ("ps_partkey",)
DECIMALS = ("value",)
ORDER = (("value", True),)
LIMIT = None


def compute(t, num):
    ps, s = t["partsupp"], t["supplier"]
    si, sf = find(s["s_suppkey"], ps["ps_suppkey"])
    german = sf & np.isin(
        s["s_nationkey"][si],
        t["nation"]["n_nationkey"][nation_rows(t, "GERMANY")])
    rows = np.flatnonzero(german)
    cents = ps["ps_supplycost"][rows] * ps["ps_availqty"][rows]
    gid, first = groups(ps["ps_partkey"][rows])
    per_part = np.zeros(len(first), dtype=np.int64)
    np.add.at(per_part, gid, cents)
    keep = per_part * 10000 > int(cents.sum())
    value = num.group_sum(num.col(cents), gid, len(first))
    return {
        "ps_partkey": ps["ps_partkey"][rows][first][keep],
        "value": num.out(num.take(value, keep)),
    }
