"""The port's measurement runners (the counterparts of the repo's
``benchmarks/`` scripts, which drive the JAX package) and what they
share: the device rule, the TPC-H tables, query text and data, the card
a line was measured on, and result comparison.

Every runner takes ``--device cuda|cpu`` with ``cuda`` as the default,
and without a card it exits non-zero before it runs anything: a number
measured on the CPU is never printed under a device's name by default.

Runners: ``tpch`` (the ``benchmark``/``convert``/``gen`` CLI),
``sweep``, ``compare``, ``sf_run``, ``cluster_run`` and ``scaling``, each
run as ``python -m ballista_tpu_torch.benchmarks.<name>``; the q1 line is
``python -m ballista_tpu_torch.bench`` and the serving line
``python -m ballista_tpu_torch.bench_serving``.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
QUERY_DIR = os.path.join(REPO_ROOT, "benchmarks", "tpch", "queries")
# the reference's one published number: TPC-H q1 at SF1 in 1956.1 ms on
# a docker-compose cluster (rust/benchmarks/tpch/README.md:70-84), i.e.
# other hardware's; SF1 lineitem holds 6,001,215 rows
REF_ROWS_PER_SEC = 6_001_215 / 1.9561


def add_device_argument(ap) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the port runs (default cuda; without a "
                         "card the runner exits unless --device cpu)")


def require_device(name: str, prog: str = "ballista_tpu_torch") -> torch.device:
    """``name`` as a torch device; exits (non-zero, with the reason)
    when it names CUDA and there is no card."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device is available; pass "
                         f"--device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"{prog}: unsupported device {name!r}")
    return dev


def sync(device) -> None:
    """Wait for the card's queued work before a clock stops."""
    if torch.device(device).type == "cuda":
        # a measurement clock stops after the card is done, by design
        # ballista: ignore[sync-span]
        torch.cuda.synchronize(device)


def timed(fn, device):
    """(seconds, result) of ``fn()`` on the host clock, the card's
    queued work included."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def card_info(device) -> dict:
    """The device a line was measured on: the card's name and its power
    limit in watts as nvidia-smi reports them (``name, power.limit``),
    or ``cpu`` and None."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = visible.split(",")[index].strip() if visible else str(index)
    line = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    limit = line.rsplit(",", 1)[1].strip().split()[0]
    return {"device": torch.cuda.get_device_name(dev),
            "power_limit_w": float(limit), "nvidia_smi": line}


def query_sql(name) -> str:
    """The text of TPC-H query ``name`` (``"q5"`` or ``5``)."""
    name = str(name)
    if not name.startswith("q"):
        name = f"q{name}"
    with open(os.path.join(QUERY_DIR, f"{name}.sql")) as f:
        return f.read()


def register_tables(ctx, data_dir: str, fmt: str = "tbl",
                    cached: bool = False, tables=None, **kw) -> None:
    """Register the TPC-H tables of ``data_dir`` (``.tbl`` directories,
    or ``convert``'s ``parquet`` ones). ``cached`` wraps each source of a
    standalone context in a ``CacheSource`` (the JAX package's
    ``cached=True``)."""
    from ..io import CacheSource, ParquetSource, TblSource
    from ..testing.tpch_schema import TPCH_PKS, TPCH_SCHEMAS

    for name, sch in TPCH_SCHEMAS.items():
        if tables is not None and name not in tables:
            continue
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            path = os.path.join(data_dir, f"{name}.{fmt}")
        if fmt == "tbl":
            src = TblSource(path, sch, device=ctx.device, **kw)
        elif fmt == "parquet":
            src = ParquetSource(path, sch, device=ctx.device, **kw)
        else:
            raise ValueError(f"unknown format {fmt!r}")
        if cached and ctx.mode == "standalone":
            src = CacheSource(src)
        ctx.register_source(name, src, TPCH_PKS[name])


def ensure_tpch(data_dir: str, scale: float, num_parts: int = 1,
                log=None) -> str:
    """Generate TPC-H at ``scale`` into ``data_dir`` unless its
    ``.complete`` marker names the current generator version and part
    count (the marker ``chip_smoke.py`` writes, so both reuse one copy)."""
    import sys

    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    from benchmarks.tpch import datagen

    marker = os.path.join(data_dir, ".complete")
    want = f"v{datagen.DATAGEN_VERSION} parts={num_parts}"
    have = open(marker).read().strip() if os.path.exists(marker) else None
    if have != want:
        t0 = time.perf_counter()
        datagen.generate(data_dir, scale=scale, num_parts=num_parts)
        with open(marker, "w") as f:
            f.write(want)
        if log is not None:
            log(f"# generated TPC-H sf{scale:g} into {data_dir} in "
                f"{time.perf_counter() - t0:.1f}s")
    return data_dir


def count_lineitem_rows(data_dir: str) -> int:
    total = 0
    d = os.path.join(data_dir, "lineitem")
    for f in sorted(os.listdir(d)):
        if f.endswith(".tbl"):
            with open(os.path.join(d, f), "rb") as fh:
                total += sum(buf.count(b"\n") for buf in
                             iter(lambda: fh.read(1 << 20), b""))
    return total


def same_result(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> bool:
    """Two ``to_pydict`` results hold the same columns and values."""
    if list(a) != list(b):
        return False
    return all(np.asarray(a[c]).shape == np.asarray(b[c]).shape
               and np.array_equal(np.asarray(a[c]), np.asarray(b[c]))
               for c in a)


def frame_mismatch(got, exp, rtol: float = 1e-6, atol: float = 1e-6,
                   label: str = "") -> Optional[str]:
    """None when two pandas results agree (floats within ``rtol``/
    ``atol``, everything else exactly, dates by day), else the first
    difference."""
    got = _normalize(got)
    exp = _normalize(exp)
    if list(got.columns) != list(exp.columns):
        return f"{label}: columns {list(got.columns)} != {list(exp.columns)}"
    if len(got) != len(exp):
        return f"{label}: {len(got)} rows != {len(exp)}"
    for c in exp.columns:
        g, e = got[c], exp[c]
        if e.dtype.kind in "fc":
            if not np.allclose(g.astype(float), e.astype(float), rtol=rtol,
                               atol=atol, equal_nan=True):
                return f"{label}.{c}: {list(g[:4])} != {list(e[:4])}"
        elif list(g.astype(str)) != list(e.astype(str)):
            return f"{label}.{c}: {list(g[:4])} != {list(e[:4])}"
    return None


def _normalize(df):
    out = df.copy()
    for c in out.columns:
        if out[c].dtype.kind == "M":
            out[c] = out[c].values.astype("datetime64[D]")
    return out.reset_index(drop=True)


def write_line(line: str, out: Optional[str]) -> None:
    """Print ``line``; also write it to ``out`` when given."""
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
