"""TPC-H q1 (pricing summary report), frozen from ``oracle.py``'s ``q1``."""

import numpy as np

from qbench.reference import day

COLUMNS = ("l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
           "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
           "avg_disc", "count_order")
KEYS = ("l_returnflag", "l_linestatus")
DECIMALS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
            "avg_qty", "avg_price", "avg_disc")
ORDER = (("l_returnflag", False), ("l_linestatus", False))
LIMIT = None


def compute(t, num):
    li = t["lineitem"]
    keep = li["l_shipdate"] <= day("1998-09-02")
    flag, status = li["l_returnflag"], li["l_linestatus"]
    # groups in (flag, status) string order, as ORDER BY asks
    gid_all = flag.codes * len(status.values) + status.codes
    present = np.unique(gid_all[keep])
    dense = np.full(len(flag.values) * len(status.values), -1)
    dense[present] = np.arange(len(present))
    gid = dense[gid_all[keep]]
    n = len(present)
    qty = num.col(li["l_quantity"][keep])
    price = num.col(li["l_extendedprice"][keep])
    disc = num.col(li["l_discount"][keep])
    tax = num.col(li["l_tax"][keep])
    disc_price = num.mul(price, num.one_minus(disc))
    charge = num.mul(disc_price, num.one_plus(tax))
    count = np.bincount(gid, minlength=n).astype(np.int64)
    sum_qty = num.group_sum(qty, gid, n)
    sum_price = num.group_sum(price, gid, n)
    sum_disc = num.group_sum(disc, gid, n)
    return {
        "l_returnflag": np.asarray(flag.values, dtype=object)[
            present // len(status.values)],
        "l_linestatus": np.asarray(status.values, dtype=object)[
            present % len(status.values)],
        "sum_qty": num.out(sum_qty),
        "sum_base_price": num.out(sum_price),
        "sum_disc_price": num.out(num.group_sum(disc_price, gid, n)),
        "sum_charge": num.out(num.group_sum(charge, gid, n)),
        "avg_qty": num.out(num.avg(sum_qty, count)),
        "avg_price": num.out(num.avg(sum_price, count)),
        "avg_disc": num.out(num.avg(sum_disc, count)),
        "count_order": count,
    }
