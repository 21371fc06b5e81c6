"""TPC-H q20 (potential part promotion), frozen from ``oracle.py``'s
``q20``. The correlated ``0.5 * sum(l_quantity)`` is computed directly
per (partkey, suppkey) over 1994's lineitems; a partsupp row with no
such lineitem has a NULL sum and does not qualify. ``ps_availqty >
0.5 * sum`` compares exactly in cents: ``200 * availqty > sum``."""

import numpy as np

from qbench.reference import day
from qbench.reference.sql import find, groups, like, nation_rows, strings

COLUMNS = ("s_name", "s_address")
KEYS = ("s_name",)
DECIMALS = ()
ORDER = (("s_name", False),)
LIMIT = None


def compute(t, num):
    s, ps, p, li = t["supplier"], t["partsupp"], t["part"], t["lineitem"]
    green = p["p_partkey"][like(p["p_name"], "green%")]
    ship = li["l_shipdate"]
    year = (ship >= day("1994-01-01")) & (ship < day("1995-01-01"))
    width = int(max(ps["ps_suppkey"].max(), li["l_suppkey"].max())) + 1
    li_key = li["l_partkey"][year] * width + li["l_suppkey"][year]
    gid, first = groups(li_key)
    sums = np.zeros(len(first), dtype=np.int64)
    np.add.at(sums, gid, li["l_quantity"][year])
    keys = li_key[first]
    ki, kf = find(keys, ps["ps_partkey"] * width + ps["ps_suppkey"])
    ok = (np.isin(ps["ps_partkey"], green) & kf
          & (200 * ps["ps_availqty"] > sums[ki]))
    si, sf = find(s["s_suppkey"], np.unique(ps["ps_suppkey"][ok]))
    canada = t["nation"]["n_nationkey"][nation_rows(t, "CANADA")]
    rows = si[sf]
    rows = rows[np.isin(s["s_nationkey"][rows], canada)]
    return {
        "s_name": strings(s["s_name"], rows),
        "s_address": strings(s["s_address"], rows),
    }
