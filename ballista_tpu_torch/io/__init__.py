"""Table sources: memory and delimited text (.tbl/.csv) through the
native scanner. Parquet, the scan cache and the ingest pipeline of the JAX
package are not ported yet."""

from .memory import MemTableSource  # noqa: F401
from .text import CsvSource, TblSource  # noqa: F401
