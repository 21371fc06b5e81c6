"""The benchmark's command.

    python3 -m qbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card of this machine and
prints, as the last line of standard output, one JSON object: whether
every answer of the window held to the reference (``correct``), the
queries attempted and failed, the cell's metrics (the end-to-end ones,
or with ``--trace 1`` the per-layer ones), the device, and last the
numbers compared with their limits (``checks``), which also end standard
error. Without a CUDA device, or with fewer than the cell asks for, it
exits non-zero and prints no result; likewise when, after the window,
this process holds a module of JAX or of the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ballista_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden here."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .harness import ROOT, cell

    chips = int(cell(args.workload, bool(args.trace)).workload["chips"])
    import torch

    if not torch.cuda.is_available():
        print("qbench: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"qbench: the cell needs {chips} CUDA devices, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from .harness import run_cell

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", root=ROOT, t0=T0,
                      log=log)
    found = forbidden_modules()
    if found:
        print(f"qbench: this process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
