"""Compute kernels of the port: torch ops, plus the hand-written CUDA
kernel for the dense grouped sums (``dense_sums.py``, ``csrc/``)."""
