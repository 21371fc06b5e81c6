"""TPC-H q18 (large volume customer), frozen from ``oracle.py``'s
``q18``. ``IN`` is computed directly: the orders whose lineitems'
quantities sum above 300 (30000 in cents); each such order is one row,
its ``total_qty`` that same sum."""

import numpy as np

from qbench.reference.sql import find, groups, strings

COLUMNS = ("c_name", "c_custkey", "o_orderkey", "o_orderdate",
           "o_totalprice", "total_qty")
KEYS = ("o_orderkey",)
DECIMALS = ("o_totalprice", "total_qty")
ORDER = (("o_totalprice", True), ("o_orderdate", False))
LIMIT = 100


def compute(t, num):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    gid, first = groups(li["l_orderkey"])
    qty = np.zeros(len(first), dtype=np.int64)
    np.add.at(qty, gid, li["l_quantity"])
    big = qty > 30000
    oi, of = find(o["o_orderkey"], li["l_orderkey"][first])
    ci, cf = find(c["c_custkey"], o["o_custkey"][oi])
    keep = big & of & cf
    rows_o, rows_c = oi[keep], ci[keep]
    return {
        "c_name": strings(c["c_name"], rows_c),
        "c_custkey": c["c_custkey"][rows_c],
        "o_orderkey": o["o_orderkey"][rows_o],
        "o_orderdate": o["o_orderdate"][rows_o].astype("datetime64[D]"),
        "o_totalprice": num.out(num.col(o["o_totalprice"][rows_o])),
        "total_qty": num.out(num.col(qty[keep])),
    }
