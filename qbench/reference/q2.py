"""TPC-H q2 (minimum cost supplier), frozen from ``oracle.py``'s ``q2``.

The correlated ``min(ps_supplycost)`` is computed directly: per part,
the least supply cost among its suppliers in EUROPE. A part's row is
each such supplier whose cost equals that least one (ties give several
rows), so a row is named by its part and its supplier's name."""

import numpy as np

from qbench.reference.sql import find, like, strings

COLUMNS = ("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
           "s_address", "s_phone", "s_comment")
KEYS = ("p_partkey", "s_name")
DECIMALS = ("s_acctbal",)
ORDER = (("s_acctbal", True), ("n_name", False), ("s_name", False),
         ("p_partkey", False))
LIMIT = 100


def compute(t, num):
    p, s, ps, n, r = (t["part"], t["supplier"], t["partsupp"], t["nation"],
                      t["region"])
    rname = r["r_name"]
    europe = r["r_regionkey"][rname.codes == rname.code_of("EUROPE")]
    nation_ok = np.isin(n["n_regionkey"], europe)
    si, sf = find(s["s_suppkey"], ps["ps_suppkey"])
    ni, nf = find(n["n_nationkey"], s["s_nationkey"][si])
    eu = sf & nf & nation_ok[ni]
    cost = ps["ps_supplycost"]
    pkey = ps["ps_partkey"]
    # per part: the least cost among its European suppliers
    parts = np.unique(pkey[eu])
    least = np.full(len(parts), np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(least, np.searchsorted(parts, pkey[eu]), cost[eu])
    li, lf = find(parts, pkey)
    at_least = eu & lf & (cost == least[li])
    part_ok = (p["p_size"] == 15) & like(p["p_type"], "%BRASS")
    pi, pf = find(p["p_partkey"], pkey)
    keep = np.flatnonzero(at_least & pf & part_ok[pi])
    rows_s, rows_p, rows_n = si[keep], pi[keep], ni[keep]
    return {
        "s_acctbal": num.out(num.col(s["s_acctbal"][rows_s])),
        "s_name": strings(s["s_name"], rows_s),
        "n_name": strings(n["n_name"], rows_n),
        "p_partkey": p["p_partkey"][rows_p],
        "p_mfgr": strings(p["p_mfgr"], rows_p),
        "s_address": strings(s["s_address"], rows_s),
        "s_phone": strings(s["s_phone"], rows_s),
        "s_comment": strings(s["s_comment"], rows_s),
    }
