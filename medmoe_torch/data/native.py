"""ctypes bindings for the C++ decode helper (csrc/medmoe_native.cpp, the
port's copy of native/medmoe_native.cpp; counterpart of
medmoe_tpu/data/native.py): tar indexing and the fused JPEG decode →
bilinear resize → float32 normalize, one image or a thread-pooled batch.

The library builds at first use with ``g++ -O3 -shared -fPIC`` against
libjpeg into ``csrc/build/libmedmoe_native-<hash>.so``, keyed by the
source and the flags, as ``ops/_build.py`` keys the CUDA kernels. A build
that fails raises with the compiler's message: the port has no quiet PIL
fallback (JAX's loader falls back when its library is not built).

    python -m medmoe_torch.data.native --build
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import List, Sequence, Tuple

import numpy as np

from medmoe_torch.data.transforms import NORM_STATS

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
SOURCE = os.path.join(CSRC, "medmoe_native.cpp")
BUILD_DIR = os.path.join(CSRC, "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-ljpeg", "-pthread")

_lib = None
_LOCK = threading.Lock()


class _TarEntry(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char * 256),
                ("offset", ctypes.c_uint64),
                ("size", ctypes.c_uint64)]


def library_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS + LINK_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libmedmoe_native-{digest.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the library unless it is built; returns its path. Raises
    RuntimeError with the compiler's output when g++ is missing or fails
    (no libjpeg headers, say)."""
    target = library_path()
    if os.path.exists(target):
        return target
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: data.use_native=true builds "
                           f"{SOURCE} at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [gxx, *GXX_FLAGS, "-o", tmp, SOURCE, *LINK_FLAGS]
    if verbose:
        print(" ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE} (data.use_native=true "
                           f"needs libjpeg and jpeglib.h):\n{proc.stderr}")
    os.replace(tmp, target)          # atomic: concurrent builds agree
    return target


def load_library() -> ctypes.CDLL:
    """The library, built on first use, with its entry points declared."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.mn_tar_index.restype = ctypes.c_long
        lib.mn_tar_index.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(_TarEntry))]
        lib.mn_free.argtypes = [ctypes.c_void_p]
        lib.mn_free.restype = None
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.mn_decode_resize_normalize.restype = ctypes.c_int
        lib.mn_decode_resize_normalize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, f32p, f32p, f32p]
        lib.mn_decode_batch.restype = None
        lib.mn_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.c_int, f32p, f32p, f32p,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _lib = lib
        return lib


def tar_index(path: str) -> List[Tuple[str, int, int]]:
    """[(member_name, payload_offset, size)] for a tar shard."""
    lib = load_library()
    entries = ctypes.POINTER(_TarEntry)()
    n = lib.mn_tar_index(path.encode(), ctypes.byref(entries))
    if n < 0:
        raise OSError(f"cannot index tar {path}")
    try:
        return [(entries[i].name.decode(), int(entries[i].offset),
                 int(entries[i].size)) for i in range(n)]
    finally:
        lib.mn_free(entries)


def _stats(norm: str) -> Tuple[np.ndarray, np.ndarray]:
    mean, std = NORM_STATS[norm]
    return np.asarray(mean, np.float32), np.asarray(std, np.float32)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_resize_normalize(jpeg: bytes, size: int,
                            norm: str = "imagenet") -> np.ndarray:
    """One image → [size, size, 3] f32; raises ValueError on corrupt
    input."""
    lib = load_library()
    mean, std = _stats(norm)
    out = np.empty((size, size, 3), np.float32)
    if lib.mn_decode_resize_normalize(jpeg, len(jpeg), size, _f32p(mean),
                                      _f32p(std), _f32p(out)) != 0:
        raise ValueError("JPEG decode failed")
    return out


def decode_batch(jpegs: Sequence[bytes], size: int, norm: str = "imagenet",
                 num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``num_threads`` wide (0 = every core) → ([N, S, S, 3] f32, ok mask
    [N])."""
    lib = load_library()
    n = len(jpegs)
    mean, std = _stats(norm)
    out = np.empty((n, size, size, 3), np.float32)
    ok = np.empty((n,), np.int32)
    datas = (ctypes.c_char_p * n)(*jpegs)
    lens = (ctypes.c_size_t * n)(*(len(j) for j in jpegs))
    lib.mn_decode_batch(datas, lens, n, size, _f32p(mean), _f32p(std),
                        _f32p(out),
                        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                        num_threads)
    return out, ok == 0


if __name__ == "__main__":
    if "--build" in sys.argv:
        print(f"built {build(verbose=True)}")
    else:
        print(f"library {library_path()} built: "
              f"{os.path.exists(library_path())}")
