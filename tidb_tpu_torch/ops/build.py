"""Lazy nvcc build + ctypes load of the package's CUDA sources.

Each source under ops/csrc/ compiles, at its first use on a CUDA
device, into a shared library with a plain C interface under ops/_build/
(listed in .gitignore), named by a hash of the flags and of every source
and header under ops/csrc/, so an edited source or header rebuilds. The
machine needs the CUDA toolkit's nvcc (CUDA_HOME, /usr/local/cuda, or
PATH). A failed build raises
KernelBuildError; nothing falls back."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..errors import TiDBError

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_DIR, "csrc")
_OUT_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_LOG: dict = {}      # source name -> (seconds, nvcc output)


class KernelBuildError(TiDBError):
    """A CUDA source did not build or load; the statement fails."""


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA toolkit is needed "
                           "to build tidb_tpu_torch's kernels")


def source_digest() -> str:
    """A hash of NVCC_FLAGS and of every file under csrc/ that a build
    can read (*.cu, *.cuh, *.h), names included."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(_SRC_DIR)):
        if fn.endswith((".cu", ".cuh", ".h")):
            h.update(fn.encode() + b"\0")
            with open(os.path.join(_SRC_DIR, fn), "rb") as f:
                h.update(f.read() + b"\0")
    return h.hexdigest()[:16]


def build(name: str) -> str:
    """Compile csrc/<name>.cu -> _build/lib<name>-<hash>.so if it is not
    built yet; -> the library path."""
    import time
    src = os.path.join(_SRC_DIR, f"{name}.cu")
    digest = source_digest()
    so = os.path.join(_OUT_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_OUT_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, timeout=600)
    BUILD_LOG[name] = (time.perf_counter() - t0,
                       proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise KernelBuildError("nvcc failed on %s:\n%s", src,
                               (proc.stdout + proc.stderr)[-4000:])
    os.replace(tmp, so)
    return so


def load(name: str):
    """-> the ctypes library for csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError("cannot load %s: %s", path, e) \
                    from e
            _LIBS[name] = lib
        return lib
