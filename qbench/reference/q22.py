"""TPC-H q22 (global sales opportunity), frozen from ``oracle.py``'s
``q22``. ``c_acctbal > avg(...)`` compares with the average at scale 6
truncated toward zero (the configuration's ``avg``); ``NOT EXISTS`` is
computed directly: the customer places no order."""

import numpy as np

from qbench.reference.sql import codes, groups, prefix

COLUMNS = ("cntrycode", "numcust", "totacctbal")
KEYS = ("cntrycode",)
DECIMALS = ("totacctbal",)
ORDER = (("cntrycode", False),)
LIMIT = None

CODES = ("13", "31", "23", "29", "30", "18", "17")


def compute(t, num):
    c, o = t["customer"], t["orders"]
    code, values = codes(prefix(c["c_phone"], 2))
    in_list = np.isin(values[code].astype(str), CODES)
    bal = c["c_acctbal"]
    positive = in_list & (bal > 0)
    avg = num.avg(num.col(np.asarray([bal[positive].sum()])),
                  np.asarray([int(positive.sum())]))
    above = (bal * 10 ** (avg[1] - 2) > avg[0][0]) if num.exact else (
        bal / 100.0 > avg[0][0])
    keep = in_list & above & ~np.isin(c["c_custkey"], o["o_custkey"])
    gid, first = groups(code[keep])
    return {
        "cntrycode": values[code[keep][first]],
        "numcust": np.bincount(gid, minlength=len(first)).astype(np.int64),
        "totacctbal": num.out(num.group_sum(num.col(bal[keep]), gid,
                                            len(first))),
    }
