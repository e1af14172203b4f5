"""Build the package's CUDA sources at first use and bind them with ctypes.

Each `.cu` under gamma_tpu_torch/csrc/ exposes a plain C interface and is
compiled by `nvcc` for sm_90a into a shared library under
`<repo>/build/gamma_tpu_torch/`, named by a hash of its source and flags
so an edited source rebuilds and an unchanged one is reused.  Nothing
here runs at import time: the CPU-only test environment has no nvcc.
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

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_REPO, "build", "gamma_tpu_torch")
# no --use_fast_math: the scans keep IEEE arithmetic next to BIG = 3e38
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds spent compiling, per source (0.0 when a cached build was loaded)
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if needed and return the loaded library."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
        t0 = time.perf_counter()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
            os.replace(tmp, so)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib
