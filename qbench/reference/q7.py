"""TPC-H q7 (volume shipping), frozen from ``oracle.py``'s ``q7``."""

import numpy as np

from qbench.reference import day, group_ids
from qbench.reference.sql import find, nation_rows, strings, year

COLUMNS = ("supp_nation", "cust_nation", "l_year", "revenue")
KEYS = ("supp_nation", "cust_nation", "l_year")
DECIMALS = ("revenue",)
ORDER = (("supp_nation", False), ("cust_nation", False), ("l_year", False))
LIMIT = None


def compute(t, num):
    s, li, o, c, n = (t["supplier"], t["lineitem"], t["orders"],
                      t["customer"], t["nation"])
    ship = li["l_shipdate"]
    ship_ok = (ship >= day("1995-01-01")) & (ship <= day("1996-12-31"))
    si, sf = find(s["s_suppkey"], li["l_suppkey"])
    oi, of = find(o["o_orderkey"], li["l_orderkey"])
    ci, cf = find(c["c_custkey"], o["o_custkey"][oi])
    n1, n1f = find(n["n_nationkey"], s["s_nationkey"][si])
    n2, n2f = find(n["n_nationkey"], c["c_nationkey"][ci])
    fr, de = nation_rows(t, "FRANCE"), nation_rows(t, "GERMANY")
    pair = ((np.isin(n1, fr) & np.isin(n2, de))
            | (np.isin(n1, de) & np.isin(n2, fr)))
    keep = ship_ok & sf & of & cf & n1f & n2f & pair
    years = year(ship[keep])
    volume = num.mul(num.col(li["l_extendedprice"][keep]),
                     num.one_minus(num.col(li["l_discount"][keep])))
    gid, first = group_ids(n1[keep], n2[keep], years)
    sums = num.group_sum(volume, gid, len(first))
    return {
        "supp_nation": strings(n["n_name"], n1[keep][first]),
        "cust_nation": strings(n["n_name"], n2[keep][first]),
        "l_year": years[first],
        "revenue": num.out(sums),
    }
