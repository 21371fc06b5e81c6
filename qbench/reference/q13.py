"""TPC-H q13 (customer distribution), frozen from ``oracle.py``'s
``q13``. The left outer join is computed directly: a customer's count
is the number of its orders whose comment is not LIKE
``%special%requests%``, 0 for a customer with none."""

import numpy as np

from qbench.reference.sql import find, like

COLUMNS = ("c_count", "custdist")
KEYS = ("c_count",)
DECIMALS = ()
ORDER = (("custdist", True), ("c_count", True))
LIMIT = None


def compute(t, num):
    c, o = t["customer"], t["orders"]
    counted = ~like(o["o_comment"], "%special%requests%")
    ci, cf = find(c["c_custkey"], o["o_custkey"])
    per_cust = np.bincount(ci[counted & cf], minlength=len(c["c_custkey"]))
    dist = np.bincount(per_cust)
    present = np.flatnonzero(dist)
    return {
        "c_count": present.astype(np.int64),
        "custdist": dist[present].astype(np.int64),
    }
