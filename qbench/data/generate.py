"""TPC-H data for the benchmark: a frozen copy of the repository's
generator (``benchmarks/tpch/datagen.py``, version 2: customers with
``custkey % 3 == 0`` place no orders), drawing the same values from the
same seed in the same order, but kept as column arrays and written as
dbgen ``.tbl`` text (``|`` after every field) by Arrow's CSV writer.

Nothing here formats a value in Python or with ``np.char``: integers,
dates and decimals go to Arrow as they are (decimals as their cents, in
a ``decimal128(15, 2)`` array), and the strings that are built from
numbers (names, addresses, phones, comments) are joined by Arrow's
compute functions.

A column is a NumPy array (integers; decimals as int64 cents; dates as
int32 days since 1970-01-01), a ``Coded`` column (codes into a short
list of strings, for the values the generator draws from a list), or an
Arrow string array (strings built from numbers).
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

GENERATOR_VERSION = 2  # the distributions of datagen.py's DATAGEN_VERSION 2

_EPOCH = np.datetime64("1970-01-01", "D")
START = int((np.datetime64("1992-01-01", "D") - _EPOCH).astype(int))
END_ORDER = int((np.datetime64("1998-08-02", "D") - _EPOCH).astype(int))
CUTOFF = int((np.datetime64("1995-06-17", "D") - _EPOCH).astype(int))

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
INSTRUCTIONS = ("COLLECT COD", "DELIVER IN PERSON", "NONE",
                "TAKE BACK RETURN")
CONTAINERS = ("SM CASE", "SM BOX", "MED BAG", "MED BOX", "LG CASE",
              "LG BOX", "JUMBO PACK", "WRAP CASE")
TYPE_S1 = ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
TYPE_S2 = ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
TYPE_S3 = ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")
BRANDS = tuple(f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6))
NOUNS = ("packages", "requests", "accounts", "deposits", "foxes", "ideas",
         "theodolites", "pinto beans", "instructions", "dependencies")
COLORS = ("almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "chartreuse", "green", "red", "white", "yellow", "ivory")
VERBS = ("sleep", "wake", "haggle", "nag", "cajole", "detect", "integrate",
         "boost", "doze", "wake blithely")
ORDER_STATUS = ("O", "F", "P")
RETURN_FLAGS = ("A", "N", "R")
LINE_STATUS = ("F", "O")

# the column order of each table, as dbgen writes it
COLUMNS = {
    "region": ("r_regionkey", "r_name", "r_comment"),
    "nation": ("n_nationkey", "n_name", "n_regionkey", "n_comment"),
    "supplier": ("s_suppkey", "s_name", "s_address", "s_nationkey",
                 "s_phone", "s_acctbal", "s_comment"),
    "customer": ("c_custkey", "c_name", "c_address", "c_nationkey",
                 "c_phone", "c_acctbal", "c_mktsegment", "c_comment"),
    "part": ("p_partkey", "p_name", "p_mfgr", "p_brand", "p_type",
             "p_size", "p_container", "p_retailprice", "p_comment"),
    "partsupp": ("ps_partkey", "ps_suppkey", "ps_availqty",
                 "ps_supplycost", "ps_comment"),
    "orders": ("o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
               "o_orderdate", "o_orderpriority", "o_clerk",
               "o_shippriority", "o_comment"),
    "lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                 "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate",
                 "l_commitdate", "l_receiptdate", "l_shipinstruct",
                 "l_shipmode", "l_comment"),
}
# decimal(15, 2) columns, held as int64 cents; date columns, as int32 days
DECIMALS = {"s_acctbal", "c_acctbal", "p_retailprice", "ps_supplycost",
            "o_totalprice", "l_quantity", "l_extendedprice", "l_discount",
            "l_tax"}
DATES = {"o_orderdate", "l_shipdate", "l_commitdate", "l_receiptdate"}


@dataclass
class Coded:
    """A string column drawn from a short list: ``values[codes]``."""

    codes: np.ndarray
    values: Sequence[str]

    def __len__(self) -> int:
        return len(self.codes)

    def strings(self, rows=None) -> np.ndarray:
        codes = self.codes if rows is None else self.codes[rows]
        return np.asarray(self.values, dtype=object)[codes]

    def code_of(self, value: str) -> int:
        return list(self.values).index(value)


Table = Dict[str, object]


def _concat(parts: List[Table]) -> Table:
    import pyarrow as pa

    out: Table = {}
    for name in parts[0]:
        cols = [p[name] for p in parts]
        if isinstance(cols[0], Coded):
            out[name] = Coded(np.concatenate([c.codes for c in cols]),
                              cols[0].values)
        elif isinstance(cols[0], np.ndarray):
            out[name] = np.concatenate(cols)
        else:
            out[name] = pa.concat_arrays(cols)
    return out


def _num_str(values) -> "object":
    import pyarrow as pa
    import pyarrow.compute as pc

    return pc.cast(pa.array(np.asarray(values, dtype=np.int64)), pa.string())


def _prefixed(prefix: str, values):
    import pyarrow.compute as pc

    return pc.binary_join_element_wise(prefix, _num_str(values), "")


def _choice(rng, values: Sequence[str], n: int, p=None) -> Coded:
    # draws exactly what rng.choice(values, n, p=p) draws
    return Coded(np.asarray(rng.choice(len(values), n, p=p)), values)


def _phones(rng, n):
    import pyarrow.compute as pc

    return pc.binary_join_element_wise(
        _num_str(rng.integers(10, 35, n)),
        _num_str(rng.integers(10**6, 10**7, n)), "-")


def _comments(rng, n):
    import pyarrow as pa
    import pyarrow.compute as pc

    a = rng.choice(len(NOUNS), n)
    b = rng.choice(len(VERBS), n)
    c = rng.integers(0, 1000, n)
    return pc.binary_join_element_wise(
        pc.take(pa.array(NOUNS), pa.array(a)),
        pc.take(pa.array(VERBS), pa.array(b)),
        _prefixed("#", c), " ")


def _cents(rng, n, lo, hi) -> np.ndarray:
    return rng.integers(int(lo * 100), int(hi * 100), n)


def _orders_chunk(rng, lo, hi, n_cust, n_part, n_supp):
    n = hi - lo
    okey = (np.arange(lo, hi) + 1) * 4 - 3
    n_eligible = n_cust - n_cust // 3
    j = rng.integers(1, n_eligible + 1, n)
    o_cust = j + (j - 1) // 2
    o_date = START + rng.integers(0, END_ORDER - START, n)
    orders = {
        "o_orderkey": okey,
        "o_custkey": o_cust,
        "o_orderstatus": _choice(rng, ORDER_STATUS, n, p=[0.49, 0.49, 0.02]),
        "o_totalprice": _cents(rng, n, 1000.0, 400000.0),
        "o_orderdate": o_date.astype(np.int32),
        "o_orderpriority": _choice(rng, PRIORITIES, n),
        "o_clerk": _prefixed("Clerk#", rng.integers(1, 1000, n)),
        "o_shippriority": np.zeros(n, dtype=np.int64),
        "o_comment": _comments(rng, n),
    }
    per = rng.integers(1, 8, n)
    l_okey = np.repeat(okey, per)
    l_odate = np.repeat(o_date, per)
    n_li = len(l_okey)
    l_pkey = rng.integers(1, n_part + 1, n_li)
    l_skey = ((l_pkey - 1 + rng.integers(0, 4, n_li) * (n_supp // 4 + 1))
              % n_supp) + 1
    starts = np.cumsum(per) - per
    l_lnum = np.arange(n_li) - np.repeat(starts, per) + 1
    qty = rng.integers(1, 51, n_li)
    retail_cents = 90000 + (l_pkey % 20001) + 100 * (l_pkey % 1000)
    disc = rng.integers(0, 11, n_li)
    tax = rng.integers(0, 9, n_li)
    sdate = l_odate + rng.integers(1, 122, n_li)
    cdate = l_odate + rng.integers(30, 91, n_li)
    rdate = sdate + rng.integers(1, 31, n_li)
    returned = rdate <= CUTOFF
    # "A" 0, "N" 1, "R" 2
    rflag = np.where(returned, np.where(rng.random(n_li) < 0.5, 2, 0), 1)
    lineitem = {
        "l_orderkey": l_okey,
        "l_partkey": l_pkey,
        "l_suppkey": l_skey,
        "l_linenumber": l_lnum,
        "l_quantity": qty * 100,
        "l_extendedprice": qty * retail_cents,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": Coded(rflag, RETURN_FLAGS),
        "l_linestatus": Coded((sdate > CUTOFF).astype(np.int64),
                              LINE_STATUS),
        "l_shipdate": sdate.astype(np.int32),
        "l_commitdate": cdate.astype(np.int32),
        "l_receiptdate": rdate.astype(np.int32),
        "l_shipinstruct": _choice(rng, INSTRUCTIONS, n_li),
        "l_shipmode": _choice(rng, SHIPMODES, n_li),
        "l_comment": _comments(rng, n_li),
    }
    return orders, lineitem


def generate(scale: float, seed: int, chunk_rows: int = 500_000
             ) -> Dict[str, Table]:
    """All eight tables at ``scale`` from ``seed``: the values that
    ``datagen.generate(dir, scale, num_parts=1, seed=seed)`` writes."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    n_cust = max(int(150_000 * scale), 10)
    n_ord = n_cust * 10
    n_part = max(int(200_000 * scale), 20)
    n_supp = max(int(10_000 * scale), 5)
    tables: Dict[str, Table] = {}

    tables["region"] = {
        "r_regionkey": np.arange(5),
        "r_name": Coded(np.arange(5), REGIONS),
        "r_comment": _comments(rng, 5),
    }
    nation_names = tuple(n for n, _ in NATIONS)
    tables["nation"] = {
        "n_nationkey": np.arange(25),
        "n_name": Coded(np.arange(25), nation_names),
        "n_regionkey": np.asarray([r for _, r in NATIONS]),
        "n_comment": _comments(rng, 25),
    }
    skey = np.arange(1, n_supp + 1)
    tables["supplier"] = {
        "s_suppkey": skey,
        "s_name": _prefixed("Supplier#", skey),
        "s_address": _prefixed("Addr S", rng.integers(0, 10**6, n_supp)),
        "s_nationkey": rng.integers(0, 25, n_supp),
        "s_phone": _phones(rng, n_supp),
        "s_acctbal": _cents(rng, n_supp, -999.99, 9999.99),
        "s_comment": _comments(rng, n_supp),
    }

    def steps(n):
        step = max(1, min(chunk_rows, n))
        return [(lo, min(lo + step, n)) for lo in range(0, n, step)]

    parts = []
    for lo, hi in steps(n_cust):
        ckey = np.arange(lo + 1, hi + 1)
        m = hi - lo
        parts.append({
            "c_custkey": ckey,
            "c_name": _prefixed("Customer#", ckey),
            "c_address": _prefixed("Addr C", rng.integers(0, 10**6, m)),
            "c_nationkey": rng.integers(0, 25, m),
            "c_phone": _phones(rng, m),
            "c_acctbal": _cents(rng, m, -999.99, 9999.99),
            "c_mktsegment": _choice(rng, SEGMENTS, m),
            "c_comment": _comments(rng, m),
        })
    tables["customer"] = _concat(parts)

    parts, ps_parts = [], []
    for lo, hi in steps(n_part):
        pkey = np.arange(lo + 1, hi + 1)
        m = hi - lo
        import pyarrow.compute as pc

        t1 = pc.take(pa.array(TYPE_S1), pa.array(rng.choice(len(TYPE_S1), m)))
        t2 = pc.take(pa.array(TYPE_S2), pa.array(rng.choice(len(TYPE_S2), m)))
        t3 = pc.take(pa.array(TYPE_S3), pa.array(rng.choice(len(TYPE_S3), m)))
        color = pc.take(pa.array(COLORS), pa.array(rng.choice(len(COLORS), m)))
        noun = pc.take(pa.array(NOUNS), pa.array(rng.choice(len(NOUNS), m)))
        parts.append({
            "p_partkey": pkey,
            "p_name": pc.binary_join_element_wise(color, noun, " "),
            "p_mfgr": _prefixed("Manufacturer#", rng.integers(1, 6, m)),
            "p_brand": _choice(rng, BRANDS, m),
            "p_type": pc.binary_join_element_wise(t1, t2, t3, " "),
            "p_size": rng.integers(1, 51, m),
            "p_container": _choice(rng, CONTAINERS, m),
            "p_retailprice": 90000 + (pkey % 20001) + 100 * (pkey % 1000),
            "p_comment": _comments(rng, m),
        })
        ps_pkey = np.repeat(pkey, 4)
        ps_skey = ((ps_pkey - 1 + np.tile(np.arange(4), m) *
                    (n_supp // 4 + 1)) % n_supp) + 1
        n_ps = 4 * m
        ps_parts.append({
            "ps_partkey": ps_pkey,
            "ps_suppkey": ps_skey,
            "ps_availqty": rng.integers(1, 10000, n_ps),
            "ps_supplycost": _cents(rng, n_ps, 1.00, 1000.00),
            "ps_comment": _comments(rng, n_ps),
        })
    tables["part"] = _concat(parts)
    tables["partsupp"] = _concat(ps_parts)

    o_parts, l_parts = [], []
    for lo, hi in steps(n_ord):
        o, li = _orders_chunk(rng, lo, hi, n_cust, n_part, n_supp)
        o_parts.append(o)
        l_parts.append(li)
    tables["orders"] = _concat(o_parts)
    tables["lineitem"] = _concat(l_parts)
    return tables


def _arrow_column(name: str, col):
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(col, Coded):
        return pc.take(pa.array(list(col.values)), pa.array(col.codes))
    if not isinstance(col, np.ndarray):
        return col
    if name in DECIMALS:
        # decimal128 little-endian: the cents, then their sign extension
        words = np.empty((len(col), 2), dtype=np.int64)
        words[:, 0] = col
        words[:, 1] = col >> 63
        return pa.Array.from_buffers(pa.decimal128(15, 2), len(col),
                                     [None, pa.py_buffer(words)])
    if name in DATES:
        return pa.array(col.astype(np.int32)).cast(pa.date32())
    return pa.array(col.astype(np.int64))


def write_tbl(table: str, cols: Table, path: str) -> None:
    """One table as dbgen ``.tbl`` text: fields joined by ``|``, with a
    ``|`` after the last one."""
    import pyarrow as pa
    import pyarrow.csv as pcsv

    names = COLUMNS[table]
    arrays = [_arrow_column(n, cols[n]) for n in names]
    n = len(arrays[0])
    # an empty last field gives dbgen's trailing "|"
    arrays.append(pa.nulls(n, pa.string()))
    at = pa.Table.from_arrays(arrays, names=list(names) + ["_end"])
    pcsv.write_csv(at, path, pcsv.WriteOptions(
        include_header=False, delimiter="|", quoting_style="none"))


def ensure_data(root: str, scale: float, seed: int,
                tables: Iterable[str]) -> tuple:
    """Generate at ``scale`` from ``seed`` and make sure ``root`` holds
    the ``.tbl`` file of each table in ``tables`` (``root/<table>.tbl``).
    The files are kept while their marker names the same generator,
    scale, seed and tables; otherwise the directory is written anew.
    Returns (arrays, wrote_files)."""
    tables = sorted(tables)
    want = (f"qbench-tpch v{GENERATOR_VERSION} scale={scale!r} "
            f"seed={seed} tables={','.join(tables)}")
    marker = os.path.join(root, ".complete")
    have: Optional[str] = None
    if os.path.exists(marker):
        with open(marker) as f:
            have = f.read().strip()
    data = generate(scale, seed)
    if have == want:
        return data, False
    if os.path.isdir(root):
        shutil.rmtree(root)
    os.makedirs(root)
    from concurrent.futures import ThreadPoolExecutor

    # Arrow's writer releases the interpreter lock: the tables in parallel
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = [pool.submit(write_tbl, t, data[t],
                               os.path.join(root, f"{t}.tbl"))
                   for t in tables]
        for fut in futures:
            fut.result()
    with open(marker, "w") as f:
        f.write(want)
    return data, True
