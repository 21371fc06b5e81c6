"""TPC-H q16 (parts/supplier relationship), frozen from ``oracle.py``'s
``q16``. ``NOT IN`` is computed directly: the complaining suppliers'
keys hold no NULL, so a partsupp row stays when its supplier is not
among them."""

import numpy as np

from qbench.reference import group_ids
from qbench.reference.sql import codes, find, like

COLUMNS = ("p_brand", "p_type", "p_size", "supplier_cnt")
KEYS = ("p_brand", "p_type", "p_size")
DECIMALS = ()
ORDER = (("supplier_cnt", True), ("p_brand", False), ("p_type", False),
         ("p_size", False))
LIMIT = None


def compute(t, num):
    ps, p, s = t["partsupp"], t["part"], t["supplier"]
    bad = s["s_suppkey"][like(s["s_comment"], "%Customer%Complaints%")]
    brand = p["p_brand"]
    part_ok = ((brand.codes != brand.code_of("Brand#45"))
               & ~like(p["p_type"], "MEDIUM POLISHED%")
               & np.isin(p["p_size"], [49, 14, 23, 45, 19, 3, 36, 9]))
    pi, pf = find(p["p_partkey"], ps["ps_partkey"])
    keep = pf & part_ok[pi] & ~np.isin(ps["ps_suppkey"], bad)
    rows_p = pi[keep]
    brand_code, brand_values = codes(brand)
    type_code, type_values = codes(p["p_type"])
    gid, first = group_ids(brand_code[rows_p], type_code[rows_p],
                           p["p_size"][rows_p])
    # count(distinct ps_suppkey): each (group, supplier) pair once
    pairs = np.unique(np.stack([gid, ps["ps_suppkey"][keep]]), axis=1)
    count = np.bincount(pairs[0], minlength=len(first))
    first_p = rows_p[first]
    return {
        "p_brand": brand_values[brand_code[first_p]],
        "p_type": type_values[type_code[first_p]],
        "p_size": p["p_size"][first_p],
        "supplier_cnt": count.astype(np.int64),
    }
