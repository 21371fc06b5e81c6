"""SQL frontend: lexer -> parser -> logical planner.

The reference delegates SQL to DataFusion's parser/planner (reference:
rust/client/src/context.rs:131-144 ``BallistaContext::sql``); this package
is the from-scratch equivalent sized for the TPC-H dialect plus general
analytics SQL: SELECT/DISTINCT, expressions, joins (explicit + comma/WHERE
style), GROUP BY/HAVING, ORDER BY, LIMIT, CASE, BETWEEN/IN/LIKE/EXTRACT,
date and interval literals.
"""

from .parser import parse_sql  # noqa: F401
from .planner import SqlPlanner  # noqa: F401
