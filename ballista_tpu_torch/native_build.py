"""Builds the port's native libraries from the sources in the checkout.

Three shared libraries, each with a plain C interface loaded with ctypes,
and one program:

- ``native/tblscan.cpp`` (the port's own copy of the JAX package's
  scanner) with ``g++``;
- ``csrc/dense_grouped_sums.cu`` and ``csrc/tbl_parse.cu`` with ``nvcc``
  for ``sm_90a``;
- ``native/shuffle_server.cpp`` (the port's own copy of the JAX
  package's data-plane daemon) with ``g++``, as an executable.

Outputs go to ``ballista_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source and the command, so an edited source
rebuilds and a stale artifact is never loaded. Builds run at first use
under an ``flock``'d lock file, so concurrent processes build once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import List

from .errors import ExecutionError

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-pthread"]


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise ExecutionError("nvcc not found: the CUDA kernels cannot be built")


def _host_tag() -> bytes:
    """The host's CPU feature line: ``-march=native`` code built on one
    machine may not run on another sharing the checkout."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.encode()
    except OSError:
        pass
    return b"generic"


def build_library(name: str, source: str, compiler: List[str],
                  flags: List[str]) -> str:
    """Compile ``source`` (a path relative to the package) into
    ``_build/lib<name>-<hash>.so`` unless that file exists; returns its
    path. Raises ExecutionError with the compiler's output on failure."""
    return _build(name, source, compiler, flags, "lib{name}-{digest}.so")


def _build(name: str, source: str, compiler: List[str], flags: List[str],
           pattern: str) -> str:
    """Compile ``source`` into ``_build/`` under ``pattern`` (formatted
    with the name and a 12-digit hash) unless that file exists."""
    import fcntl

    src = os.path.join(PACKAGE_DIR, source)
    with open(src, "rb") as fh:
        digest = hashlib.sha1(fh.read())
    digest.update(" ".join(compiler[1:] + flags).encode())
    digest.update(_host_tag())
    out = os.path.join(BUILD_DIR, pattern.format(
        name=name, digest=digest.hexdigest()[:12]))
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it meanwhile
            return out
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run(compiler + flags + ["-o", tmp, src],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise ExecutionError(
                f"building {source} failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: loaders never see a partial file
    return out


def build_tblscan() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise ExecutionError("g++ not found: the native scanner cannot be built")
    return build_library("tblscan", os.path.join("native", "tblscan.cpp"),
                         [gxx], GXX_FLAGS)


def build_shuffle_server() -> str:
    """The data-plane daemon ``_build/shuffle_server-<hash>``."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise ExecutionError(
            "g++ not found: the native shuffle server cannot be built")
    flags = [f for f in GXX_FLAGS if f not in ("-fPIC", "-shared")]
    return _build("shuffle_server", os.path.join("native", "shuffle_server.cpp"),
                  [gxx], flags, "{name}-{digest}")


def build_dense_grouped_sums() -> str:
    return build_library("dense_grouped_sums",
                         os.path.join("csrc", "dense_grouped_sums.cu"),
                         [find_nvcc()], NVCC_FLAGS)


def build_tbl_parse() -> str:
    return build_library("tbl_parse", os.path.join("csrc", "tbl_parse.cu"),
                         [find_nvcc()], NVCC_FLAGS)
