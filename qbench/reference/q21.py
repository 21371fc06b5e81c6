"""TPC-H q21 (suppliers who kept orders waiting), frozen from
``oracle.py``'s ``q21``. The correlated ``EXISTS`` and ``NOT EXISTS``
are computed directly from per-order counts: a late lineitem ``l1``
has another supplier in its order when the order has at least 2
distinct suppliers, and no other late supplier when its order's late
lineitems have exactly 1 distinct supplier (``l1``'s own)."""

import numpy as np

from qbench.reference.sql import find, groups, nation_rows, strings


COLUMNS = ("s_name", "numwait")
KEYS = ("s_name",)
DECIMALS = ()
ORDER = (("numwait", True), ("s_name", False))
LIMIT = 100


def _distinct_suppliers(order_row, suppkey, n_orders):
    """Distinct suppliers per order (by its row in ``orders``)."""
    width = int(suppkey.max(initial=0)) + 1
    pairs = np.unique(order_row * width + suppkey)
    return np.bincount(pairs // width, minlength=n_orders)


def compute(t, num):
    s, li, o = t["supplier"], t["lineitem"], t["orders"]
    skey = li["l_suppkey"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    oi, of = find(o["o_orderkey"], li["l_orderkey"])
    n = len(o["o_orderkey"])
    n_supp = _distinct_suppliers(oi[of], skey[of], n)
    n_late = _distinct_suppliers(oi[of & late], skey[of & late], n)
    status = o["o_orderstatus"]
    si, sf = find(s["s_suppkey"], skey)
    saudi = t["nation"]["n_nationkey"][nation_rows(t, "SAUDI ARABIA")]
    keep = (late & of & (status.codes[oi] == status.code_of("F")) & sf
            & np.isin(s["s_nationkey"][si], saudi)
            & (n_supp[oi] >= 2) & (n_late[oi] == 1))
    gid, first = groups(si[keep])
    return {
        "s_name": strings(s["s_name"], si[keep][first]),
        "numwait": np.bincount(gid, minlength=len(first)).astype(np.int64),
    }
