"""TPC-H q19 (discounted revenue), frozen from ``oracle.py``'s ``q19``.
Quantities compare in cents. Over no rows SQL's sum is NULL, read here
as NaN."""

import numpy as np

from qbench.reference.sql import find

COLUMNS = ("revenue",)
KEYS = ()
DECIMALS = ("revenue",)
ORDER = ()
LIMIT = None

_BRANCHES = (
    ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 11, 5),
    ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 20, 10),
    ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 30, 15),
)


def _codes_of(col, names):
    return [col.code_of(v) for v in names if v in col.values]


def compute(t, num):
    li, p = t["lineitem"], t["part"]
    pi, pf = find(p["p_partkey"], li["l_partkey"])
    mode, instruct = li["l_shipmode"], li["l_shipinstruct"]
    common = (pf & np.isin(mode.codes, _codes_of(mode, ("AIR", "AIR REG")))
              & (instruct.codes == instruct.code_of("DELIVER IN PERSON")))
    qty = li["l_quantity"]
    brand, container, size = p["p_brand"], p["p_container"], p["p_size"]
    any_branch = np.zeros(len(qty), dtype=bool)
    for b, boxes, lo, hi, top in _BRANCHES:
        part_ok = ((brand.codes == brand.code_of(b))
                   & np.isin(container.codes, _codes_of(container, boxes))
                   & (size >= 1) & (size <= top))
        any_branch |= (part_ok[pi] & (qty >= lo * 100) & (qty <= hi * 100))
    keep = common & any_branch
    if not keep.any():
        return {"revenue": np.asarray([np.nan])}
    revenue = num.mul(num.col(li["l_extendedprice"][keep]),
                      num.one_minus(num.col(li["l_discount"][keep])))
    return {"revenue": num.out(num.total(revenue))}
