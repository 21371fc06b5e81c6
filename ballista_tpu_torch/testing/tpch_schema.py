"""TPC-H table schemas for the port (the same mapping as
``benchmarks/tpch/schema_def.py``, which imports the JAX package and so
cannot be used here)."""

from ..datatypes import Date32, Decimal, Int32, Int64, Utf8, schema

TPCH_SCHEMAS = {
    "region": schema(
        ("r_regionkey", Int64), ("r_name", Utf8), ("r_comment", Utf8)
    ),
    "nation": schema(
        ("n_nationkey", Int64), ("n_name", Utf8), ("n_regionkey", Int64),
        ("n_comment", Utf8),
    ),
    "supplier": schema(
        ("s_suppkey", Int64), ("s_name", Utf8), ("s_address", Utf8),
        ("s_nationkey", Int64), ("s_phone", Utf8), ("s_acctbal", Decimal(2)),
        ("s_comment", Utf8),
    ),
    "customer": schema(
        ("c_custkey", Int64), ("c_name", Utf8), ("c_address", Utf8),
        ("c_nationkey", Int64), ("c_phone", Utf8), ("c_acctbal", Decimal(2)),
        ("c_mktsegment", Utf8), ("c_comment", Utf8),
    ),
    "part": schema(
        ("p_partkey", Int64), ("p_name", Utf8), ("p_mfgr", Utf8),
        ("p_brand", Utf8), ("p_type", Utf8), ("p_size", Int32),
        ("p_container", Utf8), ("p_retailprice", Decimal(2)),
        ("p_comment", Utf8),
    ),
    "partsupp": schema(
        ("ps_partkey", Int64), ("ps_suppkey", Int64), ("ps_availqty", Int32),
        ("ps_supplycost", Decimal(2)), ("ps_comment", Utf8),
    ),
    "orders": schema(
        ("o_orderkey", Int64), ("o_custkey", Int64), ("o_orderstatus", Utf8),
        ("o_totalprice", Decimal(2)), ("o_orderdate", Date32),
        ("o_orderpriority", Utf8), ("o_clerk", Utf8),
        ("o_shippriority", Int32), ("o_comment", Utf8),
    ),
    "lineitem": schema(
        ("l_orderkey", Int64), ("l_partkey", Int64), ("l_suppkey", Int64),
        ("l_linenumber", Int32), ("l_quantity", Decimal(2)),
        ("l_extendedprice", Decimal(2)), ("l_discount", Decimal(2)),
        ("l_tax", Decimal(2)), ("l_returnflag", Utf8),
        ("l_linestatus", Utf8), ("l_shipdate", Date32),
        ("l_commitdate", Date32), ("l_receiptdate", Date32),
        ("l_shipinstruct", Utf8), ("l_shipmode", Utf8), ("l_comment", Utf8),
    ),
}

# primary keys for join-side selection (lineitem/partsupp have composite
# PKs -> none usable as a single unique column)
TPCH_PKS = {
    "region": "r_regionkey",
    "nation": "n_nationkey",
    "supplier": "s_suppkey",
    "customer": "c_custkey",
    "part": "p_partkey",
    "partsupp": None,
    "orders": "o_orderkey",
    "lineitem": None,
}


def register_tpch(ctx, data_dir: str, tables=None, **kw):
    """Register the ``.tbl`` tables of a ``benchmarks/tpch/datagen.py``
    directory (all of them, or the names in ``tables``)."""
    import os

    for name, sch in TPCH_SCHEMAS.items():
        if tables is not None and name not in tables:
            continue
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            path = os.path.join(data_dir, f"{name}.tbl")
        ctx.register_tbl(name, path, sch, primary_key=TPCH_PKS[name], **kw)


_DDL_TYPES = {"int64": "bigint", "int32": "int32", "utf8": "varchar",
              "date32": "date32", "decimal": "decimal"}


def tpch_ddl(name: str, data_dir: str) -> str:
    """``CREATE EXTERNAL TABLE`` of table ``name`` over the ``.tbl`` data
    of a ``benchmarks/tpch/datagen.py`` directory: how a SQL-only client
    (an Arrow Flight ``DoGet`` ticket) registers a table. The DDL's
    ``decimal`` is scale 2, as every TPC-H decimal is."""
    import os

    path = os.path.join(data_dir, name)
    if not os.path.exists(path):
        path = os.path.join(data_dir, f"{name}.tbl")
    cols = []
    for f in TPCH_SCHEMAS[name].fields:
        assert f.dtype.kind != "decimal" or f.dtype.scale == 2, f
        cols.append(f"{f.name} {_DDL_TYPES[f.dtype.kind]}")
    return (f"CREATE EXTERNAL TABLE {name} ({', '.join(cols)}) "
            f"STORED AS TBL LOCATION '{path}'")
