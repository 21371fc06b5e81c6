"""TPC-H q15 (top supplier), frozen from ``oracle.py``'s ``q15``: the
suppliers whose revenue in the quarter equals the greatest, compared
exactly in scaled integers."""

import numpy as np

from qbench.reference import day
from qbench.reference.sql import find, groups, strings

COLUMNS = ("s_suppkey", "s_name", "s_address", "s_phone", "total_revenue")
KEYS = ("s_suppkey",)
DECIMALS = ("total_revenue",)
ORDER = (("s_suppkey", False),)
LIMIT = None


def compute(t, num):
    s, li = t["supplier"], t["lineitem"]
    ship = li["l_shipdate"]
    keep = (ship >= day("1996-01-01")) & (ship < day("1996-04-01"))
    revenue = num.mul(num.col(li["l_extendedprice"][keep]),
                      num.one_minus(num.col(li["l_discount"][keep])))
    gid, first = groups(li["l_suppkey"][keep])
    sums = num.group_sum(revenue, gid, len(first))
    supp = li["l_suppkey"][keep][first]
    top = sums[0] == sums[0].max() if len(first) else np.zeros(0, bool)
    si, sf = find(s["s_suppkey"], supp)
    top &= sf
    rows = si[top]
    return {
        "s_suppkey": s["s_suppkey"][rows],
        "s_name": strings(s["s_name"], rows),
        "s_address": strings(s["s_address"], rows),
        "s_phone": strings(s["s_phone"], rows),
        "total_revenue": num.out(num.take(sums, top)),
    }
