"""TPC-H q3 (shipping priority), frozen from ``oracle.py``'s ``q3``."""

import numpy as np

from qbench.reference import day, group_ids, lookup

COLUMNS = ("l_orderkey", "revenue", "o_orderdate", "o_shippriority")
KEYS = ("l_orderkey",)
DECIMALS = ("revenue",)
ORDER = (("revenue", True), ("o_orderdate", False))
LIMIT = 10


def compute(t, num):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    seg = c["c_mktsegment"]
    cust_ok = seg.codes == seg.code_of("BUILDING")
    ci, cf = lookup(c["c_custkey"], o["o_custkey"])
    order_ok = (o["o_orderdate"] < day("1995-03-15")) & cf & cust_ok[ci]
    ship_ok = li["l_shipdate"] > day("1995-03-15")
    oi, of = lookup(o["o_orderkey"], li["l_orderkey"])
    keep = ship_ok & of & order_ok[oi]
    rows_o = oi[keep]
    revenue = num.mul(num.col(li["l_extendedprice"][keep]),
                      num.one_minus(num.col(li["l_discount"][keep])))
    gid, first = group_ids(li["l_orderkey"][keep])
    sums = num.group_sum(revenue, gid, len(first))
    first_o = rows_o[first]
    return {
        "l_orderkey": li["l_orderkey"][keep][first],
        "revenue": num.out(sums),
        "o_orderdate": o["o_orderdate"][first_o].astype("datetime64[D]"),
        "o_shippriority": o["o_shippriority"][first_o],
    }
