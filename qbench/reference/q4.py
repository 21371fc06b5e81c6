"""TPC-H q4 (order priority checking), frozen from ``oracle.py``'s ``q4``.

``EXISTS`` is computed directly: an order qualifies when any of its
lineitems was received after its commit date."""

import numpy as np

from qbench.reference import day

COLUMNS = ("o_orderpriority", "order_count")
KEYS = ("o_orderpriority",)
DECIMALS = ()
ORDER = (("o_orderpriority", False),)
LIMIT = None


def compute(t, num):
    o, li = t["orders"], t["lineitem"]
    late = np.unique(li["l_orderkey"][li["l_commitdate"]
                                      < li["l_receiptdate"]])
    date = o["o_orderdate"]
    keep = ((date >= day("1993-07-01")) & (date < day("1993-10-01"))
            & np.isin(o["o_orderkey"], late))
    prio = o["o_orderpriority"]
    counts = np.bincount(prio.codes[keep], minlength=len(prio.values))
    present = np.flatnonzero(counts)
    return {
        "o_orderpriority": np.asarray(prio.values, dtype=object)[present],
        "order_count": counts[present].astype(np.int64),
    }
