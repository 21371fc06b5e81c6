"""Table sources: memory, delimited text (.tbl/.csv) through the native
scanner, Parquet through pyarrow, and the caching wrapper; Arrow IPC
shuffle files (``io/ipc.py``)."""

from .cache import CacheSource  # noqa: F401
from .memory import MemTableSource  # noqa: F401
from .parquet import ParquetSource  # noqa: F401
from .text import CsvSource, TblSource  # noqa: F401
