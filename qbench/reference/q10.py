"""TPC-H q10 (returned item reporting), frozen from ``oracle.py``'s ``q10``."""

import numpy as np

from qbench.reference import day, group_ids, lookup

COLUMNS = ("c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
           "c_address", "c_phone", "c_comment")
KEYS = ("c_custkey",)
DECIMALS = ("revenue", "c_acctbal")
ORDER = (("revenue", True),)
LIMIT = 20


def _strings(arrow_column, rows):
    return np.asarray(arrow_column.take(rows).to_pylist(), dtype=object)


def compute(t, num):
    c, o, li, n = t["customer"], t["orders"], t["lineitem"], t["nation"]
    date = o["o_orderdate"]
    order_ok = (date >= day("1993-10-01")) & (date < day("1994-01-01"))
    flag = li["l_returnflag"]
    oi, of = lookup(o["o_orderkey"], li["l_orderkey"])
    ci, cf = lookup(c["c_custkey"], o["o_custkey"][oi])
    ni, nf = lookup(n["n_nationkey"], c["c_nationkey"][ci])
    keep = (flag.codes == flag.code_of("R")) & of & order_ok[oi] & cf & nf
    revenue = num.mul(num.col(li["l_extendedprice"][keep]),
                      num.one_minus(num.col(li["l_discount"][keep])))
    gid, first = group_ids(ci[keep])
    sums = num.group_sum(revenue, gid, len(first))
    rows_c = ci[keep][first]
    return {
        "c_custkey": c["c_custkey"][rows_c],
        "c_name": _strings(c["c_name"], rows_c),
        "revenue": num.out(sums),
        "c_acctbal": num.out(num.col(c["c_acctbal"][rows_c])),
        "n_name": n["n_name"].strings(ni[keep][first]),
        "c_address": _strings(c["c_address"], rows_c),
        "c_phone": _strings(c["c_phone"], rows_c),
        "c_comment": _strings(c["c_comment"], rows_c),
    }
