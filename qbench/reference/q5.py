"""TPC-H q5 (local supplier volume), frozen from ``oracle.py``'s ``q5``."""

import numpy as np

from qbench.reference import day, group_ids, lookup

COLUMNS = ("n_name", "revenue")
KEYS = ("n_name",)
DECIMALS = ("revenue",)
ORDER = (("revenue", True),)
LIMIT = None


def compute(t, num):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    s, n, r = t["supplier"], t["nation"], t["region"]
    rname = r["r_name"]
    asia = r["r_regionkey"][rname.codes == rname.code_of("ASIA")]
    nation_ok = np.isin(n["n_regionkey"], asia)
    date = o["o_orderdate"]
    order_ok = (date >= day("1994-01-01")) & (date < day("1995-01-01"))
    oi, of = lookup(o["o_orderkey"], li["l_orderkey"])
    ci, cf = lookup(c["c_custkey"], o["o_custkey"][oi])
    si, sf = lookup(s["s_suppkey"], li["l_suppkey"])
    ni, nf = lookup(n["n_nationkey"], s["s_nationkey"][si])
    keep = (of & order_ok[oi] & cf & sf & nf & nation_ok[ni]
            & (c["c_nationkey"][ci] == s["s_nationkey"][si]))
    revenue = num.mul(num.col(li["l_extendedprice"][keep]),
                      num.one_minus(num.col(li["l_discount"][keep])))
    gid, first = group_ids(ni[keep])
    sums = num.group_sum(revenue, gid, len(first))
    return {
        "n_name": n["n_name"].strings(ni[keep][first]),
        "revenue": num.out(sums),
    }
