"""TPC-H q9 (product type profit measure), frozen from ``oracle.py``'s
``q9``. The partsupp row of a lineitem is found by its (partkey,
suppkey) pair."""

import numpy as np

from qbench.reference import group_ids
from qbench.reference.sql import find, like, minus, strings, year

COLUMNS = ("nation", "o_year", "sum_profit")
KEYS = ("nation", "o_year")
DECIMALS = ("sum_profit",)
ORDER = (("nation", False), ("o_year", True))
LIMIT = None


def compute(t, num):
    p, s, li, ps, o, n = (t["part"], t["supplier"], t["lineitem"],
                          t["partsupp"], t["orders"], t["nation"])
    green = like(p["p_name"], "%green%")
    pi, pf = find(p["p_partkey"], li["l_partkey"])
    li_rows = np.flatnonzero(pf & green[pi])
    pkey, skey = li["l_partkey"][li_rows], li["l_suppkey"][li_rows]
    width = int(max(ps["ps_suppkey"].max(), skey.max(initial=0))) + 1
    ps_key = ps["ps_partkey"] * width + ps["ps_suppkey"]
    order = np.argsort(ps_key, kind="stable")
    psi, psf = find(ps_key[order], pkey * width + skey)
    psi = order[psi]
    si, sf = find(s["s_suppkey"], skey)
    oi, of = find(o["o_orderkey"], li["l_orderkey"][li_rows])
    ni, nf = find(n["n_nationkey"], s["s_nationkey"][si])
    ok = psf & sf & of & nf
    rows, psi, oi, ni = li_rows[ok], psi[ok], oi[ok], ni[ok]
    amount = minus(
        num.mul(num.col(li["l_extendedprice"][rows]),
                num.one_minus(num.col(li["l_discount"][rows]))),
        num.mul(num.col(ps["ps_supplycost"][psi]),
                num.col(li["l_quantity"][rows])))
    years = year(o["o_orderdate"][oi])
    gid, first = group_ids(ni, years)
    sums = num.group_sum(amount, gid, len(first))
    return {
        "nation": strings(n["n_name"], ni[first]),
        "o_year": years[first],
        "sum_profit": num.out(sums),
    }
