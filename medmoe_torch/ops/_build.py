"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``csrc/build/lib<name>-<hash>.so`` for ``sm_90a``; the hash covers the
source and the flags, so an edited source builds anew. Builds run at first
use (or all at once, in parallel, through ``build``), never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
KERNELS = ("expert_fusion",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                  shutil.which("nvcc") or "",
                  "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ at first use")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[float, str]]:
    """Compile every named kernel that is not built yet, one nvcc each,
    all started together. Returns {name: (seconds, compiler log)}; raises
    with the log when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    results = {}
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, target)      # atomic: concurrent builders agree
        results[name] = (time.perf_counter() - t0, log)
    return results


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use, with its C entry
    points' argument types set."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _declare(name, lib)
            _LIBS[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "expert_fusion":
        arr_p, arr_i = ctypes.POINTER(vp), ctypes.POINTER(i)
        lib.medmoe_expert_fusion_fwd.argtypes = [
            i, arr_p, arr_p, arr_p, arr_p, arr_i, arr_i,
            vp, vp, vp, vp, vp, i, i, i, i, i, vp]
        lib.medmoe_expert_fusion_fwd.restype = i
        lib.medmoe_cuda_error_string.argtypes = [i]
        lib.medmoe_cuda_error_string.restype = ctypes.c_char_p
