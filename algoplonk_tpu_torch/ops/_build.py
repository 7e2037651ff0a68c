"""Build and load the CUDA kernels of ``algoplonk_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, which ctypes loads.  No PyTorch
header is included, which keeps the build to seconds.  The library lands in
``algoplonk_tpu_torch/_kernels/`` (ignored by git) under a name that hashes
the sources and flags, so an edited source is rebuilt and never mistaken for
a stale build.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
build_log = ""      # nvcc's output of this process's build ('' if cached)
build_seconds = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    return h.hexdigest()[:16]


def _set_signatures(lib) -> None:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sigs = {
        "ap_mixed_add_signed_multi": [vp, vp, vp, vp, i64, i32, i64, vp, vp],
        "ap_jac_add_multi_scan": [vp, vp, vp, i64, i32, vp, vp],
        "ap_jac_add": [vp, vp, vp, i64, vp, vp],
        "ap_canon": [vp, vp, i64, i64, vp, vp],
        "ap_consts_words": [],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def library():
    """The loaded kernel library, building it on first use."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        target = os.path.join(BUILD_DIR, f"libap_kernels_{_digest()}.so")
        if not os.path.exists(target):
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{build_log}"
                )
            os.replace(tmp, target)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(target)
        _set_signatures(lib)
        _lib = lib
        return lib
