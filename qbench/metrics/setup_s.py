"""``setup_s`` (s): process start to the window's start, on the host
clock: imports, CUDA's start, the program's builds, data generation,
the deployment's start, table registration and loads, and the warm-up
of the mix's queries."""


def read(run):
    return run.setup_s
