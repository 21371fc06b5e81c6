"""The benchmark of the PyTorch/CUDA port (``ballista_tpu_torch``): TPC-H
cells driven by ``BENCHMARK.json``, run as ``python3 -m qbench.run``."""
