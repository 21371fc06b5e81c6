"""The control of the comparison that decides ``correct``.

The configuration states exact decimal arithmetic (scaled integers). The
step below it that would tempt a later change is float64, as pandas
computes TPC-H. The control puts the reference, computed in float64
(``Num(exact=False)``), in the program's place: its answers, ordered
and cut by their own values, are held to the exact reference by the
same comparison as a run's. It has to come out not correct.

    python3 -m qbench.control --scale 1 --seeds 11,12,13

prints one JSON line per seed with the numbers a run compares.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

from . import check
from .data import generate
from .reference import Num, load

MIX = ("q1", "q3", "q5", "q6", "q10", "q12")


def ordered(mod, result: dict) -> dict:
    """``result`` in its ORDER BY order (read from its own values) and
    cut to its LIMIT, as the program would return it."""
    cells = {c: check._cells(result[c]) for c in mod.COLUMNS}
    n = len(cells[mod.COLUMNS[0]])
    okey = [tuple(cells[c][i] for c, _ in mod.ORDER) for i in range(n)]
    rows = sorted(range(n), key=functools.cmp_to_key(
        lambda a, b: check._before(okey[a], okey[b], mod.ORDER)))
    if mod.LIMIT is not None:
        rows = rows[:mod.LIMIT]
    return {c: result[c][rows] for c in mod.COLUMNS}


def readings(tables, mix=MIX) -> dict:
    """The numbers a run compares, with the control's answers in place
    of the program's."""
    wrong, gap = 0, 0.0
    for q in mix:
        mod = load(q)
        want = check.Expected(mod, mod.compute(tables, Num(True)))
        why, g = want.hold(ordered(mod, mod.compute(tables, Num(False))))
        wrong += why is not None
        gap = max(gap, g)
    return {"answers_wrong": wrong, "decimal_gap_ulp": gap}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qbench.control")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        tables = generate.generate(args.scale, seed)
        out = readings(tables)
        out.update(seed=seed, scale=args.scale,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
