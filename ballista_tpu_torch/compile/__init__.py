"""Shape canonicalization: the row-count bucket ladder (``buckets.py``,
copied from the JAX package). The port has no compile governor: PyTorch
runs eagerly, so only the capacity ladder carries over."""

from .buckets import bucket_capacity  # noqa: F401
