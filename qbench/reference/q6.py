"""TPC-H q6 (forecasting revenue change), frozen from ``oracle.py``'s ``q6``."""

import numpy as np

from qbench.reference import day

COLUMNS = ("revenue",)
KEYS = ()
DECIMALS = ("revenue",)
ORDER = ()
LIMIT = None


def compute(t, num):
    li = t["lineitem"]
    ship = li["l_shipdate"]
    disc = li["l_discount"]
    keep = ((ship >= day("1994-01-01")) & (ship < day("1995-01-01"))
            & (disc >= 5) & (disc <= 7) & (li["l_quantity"] < 2400))
    revenue = num.mul(num.col(li["l_extendedprice"][keep]),
                      num.col(disc[keep]))
    return {"revenue": num.out(num.total(revenue))}
