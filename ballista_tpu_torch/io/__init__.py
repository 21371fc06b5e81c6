"""Table sources: memory, delimited text (.tbl/.csv) through the native
scanner, and the caching wrapper. Parquet of the JAX package is not
ported yet."""

from .cache import CacheSource  # noqa: F401
from .memory import MemTableSource  # noqa: F401
from .text import CsvSource, TblSource  # noqa: F401
