"""TPC-H q12 (shipping modes and order priority), frozen from
``oracle.py``'s ``q12``."""

import numpy as np

from qbench.reference import day, lookup

COLUMNS = ("l_shipmode", "high_line_count", "low_line_count")
KEYS = ("l_shipmode",)
DECIMALS = ()
ORDER = (("l_shipmode", False),)
LIMIT = None


def compute(t, num):
    li, o = t["lineitem"], t["orders"]
    mode = li["l_shipmode"]
    ship, commit, receipt = (li["l_shipdate"], li["l_commitdate"],
                             li["l_receiptdate"])
    keep = (np.isin(mode.codes, [mode.code_of("MAIL"), mode.code_of("SHIP")])
            & (commit < receipt) & (ship < commit)
            & (receipt >= day("1994-01-01")) & (receipt < day("1995-01-01")))
    idx, found = lookup(o["o_orderkey"], li["l_orderkey"][keep])
    codes = mode.codes[keep][found]
    prio = o["o_orderpriority"]
    high = np.isin(prio.codes[idx[found]],
                   [prio.code_of("1-URGENT"), prio.code_of("2-HIGH")])
    names = np.asarray(mode.values, dtype=object)
    present = sorted(set(codes.tolist()), key=lambda c: names[c])
    return {
        "l_shipmode": names[present] if present else names[:0],
        "high_line_count": np.asarray(
            [int(np.sum(high[codes == c])) for c in present], dtype=np.int64),
        "low_line_count": np.asarray(
            [int(np.sum(~high[codes == c])) for c in present], dtype=np.int64),
    }
