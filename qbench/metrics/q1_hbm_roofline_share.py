"""``q1_hbm_roofline_share`` (%): the least time TPC-H q1 could take on
the card over the time the card worked on it.

The least time is the bytes q1 must read over the card's HBM bandwidth
(``qbench/peaks.json``: 3.35e12 B/s for an H100 SXM, NVIDIA's data
sheet, at its full power limit). The bytes are lineitem's rows times the
seven columns q1 reads, at the widths of their TPC-H types, whatever
the program holds them in: ``Q1_ROW_BYTES`` = 4 decimals (quantity,
extended price, discount, tax) at 8 B, the ship date at 4 B, and the
return flag and line status, char(1), at 1 B each: 38 B a row.

The time is the union of the card's intervals (kernels, copies, sets)
inside the harness's spans of q1 in the profiled slice that hold whole.
The share is the sum of the least times over the sum of those times."""

import json
import os

from qbench.trace import covered_ns

Q1_COLUMN_BYTES = {"l_quantity": 8, "l_extendedprice": 8, "l_discount": 8,
                   "l_tax": 8, "l_shipdate": 4, "l_returnflag": 1,
                   "l_linestatus": 1}
Q1_ROW_BYTES = sum(Q1_COLUMN_BYTES.values())


def q1_bytes(lineitem_rows: int) -> int:
    """Bytes q1 must read from lineitem."""
    return lineitem_rows * Q1_ROW_BYTES


def hbm_bytes_per_s(device_kind: str):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "peaks.json")
    with open(path) as f:
        peak = json.load(f).get(device_kind)
    return None if peak is None else float(peak["hbm_bytes_per_s"])


def read(run):
    p = run.profile
    peak = hbm_bytes_per_s(run.device_kind)
    if p is None or peak is None or not p.device:
        return None
    spans = [s for s in run.spans if s.name == "q1" and s.session >= 0
             and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns]
    busy_ns = sum(covered_ns(p.device_intervals(), s.start_ns, s.end_ns)
                  for s in spans)
    if busy_ns <= 0:
        return None
    least_s = len(spans) * q1_bytes(run.table_rows["lineitem"]) / peak
    return 100.0 * least_s / (busy_ns / 1e9)
