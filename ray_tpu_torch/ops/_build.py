"""Build and load the port's CUDA kernels.

A source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library lands in
``ray_tpu_torch/_build/``, named by a hash of its source and flags, so an edit
to the source rebuilds it and an unchanged source is built once per checkout.
Nothing is built at import: the first call on a CUDA tensor builds what it
needs, and ``build()`` builds ahead of that.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCE = "flash_attention"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return path


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build(name: str = SOURCE) -> float:
    """Build ``csrc/<name>.cu`` unless it is built already. Returns the seconds
    taken; raises with the compiler's output on a failure. ``nvcc``'s log
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
    library as ``<library>.log``."""
    t0 = time.perf_counter()
    path = library_path(name)
    if os.path.exists(path):
        return time.perf_counter() - t0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with open(path + ".log", "w") as f:
        f.write(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}.cu (nvcc exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(library_path(name))
        return lib
