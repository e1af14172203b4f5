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
import re
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_REPO, "build", "gamma_tpu_torch")
# no --use_fast_math: the scans keep IEEE arithmetic next to BIG = 3e38;
# -Xptxas=-v reports each kernel's registers and spills (BUILD_LOG)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds spent compiling, per source (0.0 when a cached build was loaded)
BUILD_SECONDS: Dict[str, float] = {}
# what nvcc wrote to stderr, per source built in this process
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if needed and return the loaded library."""
    return load_all([name])[name]


def load_all(names: List[str]) -> Dict[str, ctypes.CDLL]:
    """Compile every csrc/<name>.cu that is not built yet, one nvcc each,
    all started together, and return the loaded libraries by name.
    BUILD_SECONDS[name] is the time from the start until its build was
    done (0.0 when a cached build was loaded)."""
    with _LOCK:
        t0 = time.perf_counter()
        procs = {}
        for name in names:
            if name in _LIBS:
                continue
            src = os.path.join(CSRC, f"{name}.cu")
            with open(src, "rb") as f:
                digest = hashlib.sha256(
                    f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            so = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
            proc = tmp = None
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
            procs[name] = (src, so, tmp, proc)
        failed = []
        for name, (src, so, tmp, proc) in procs.items():
            if proc is not None:
                _, err = proc.communicate()      # waits for every build
                BUILD_LOG[name] = err
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {src}:\n{err}")
                    continue
                os.replace(tmp, so)
            BUILD_SECONDS[name] = (time.perf_counter() - t0
                                   if proc is not None else 0.0)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, (_, so, _, _) in procs.items():
            _LIBS[name] = ctypes.CDLL(so)
        return {name: _LIBS[name] for name in names}


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes per kernel from `nvcc -Xptxas=-v` output
    (BUILD_LOG): {mangled entry name: {"registers", "spill_stores",
    "spill_loads"}}."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out
