"""Build and load the CUDA kernels of ``algoplonk_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source and width, all started together) and links them into one
shared library with a plain C interface, which ctypes loads.  The curve
and field sources (``PER_WIDTH``) are compiled once for each word count in ``WIDTHS``
with ``-DAP_W=<W>``, and their objects export entry points whose names end
in ``_w<W>`` (``entry``); the W = 12 builds are the long ones, and this lets
them run beside the others.  No PyTorch header is
included, which keeps the build to seconds.  The library lands in
``algoplonk_tpu_torch/_kernels/`` (ignored by git) under a name that hashes
the sources and flags, so an edited source is rebuilt and never mistaken for
a stale build.  A failed build raises.

nvcc's device front end (cicc) recurses deeply on the fully unrolled
W = 12 projective add and overflows the default 8 MiB stack (it dies with
SIGSEGV), so each nvcc runs with a stack limit of ``NVCC_STACK_BYTES``.

The wrappers' shared checks (``check_tensor``, ``stream_of``, ``raise_on``)
live here too.
"""

from __future__ import annotations

import ctypes
import glob
import contextlib
import hashlib
import os
import resource
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

NVCC_STACK_BYTES = 1 << 30
WIDTHS = (8, 12)   # word counts of the curve and field kernels: BN254, BLS12-381's Fp
PER_WIDTH = ("curve_kernels.cu", "field_kernels.cu", "msm_kernels.cu")

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


def _units() -> list[tuple[str, list[str], str]]:
    """(source, extra flags, object name) for every nvcc process."""
    units = []
    for src in _sources():
        name = os.path.basename(src)
        if name in PER_WIDTH:
            units += [(src, [f"-DAP_W={w}"], f"{name}.w{w}.o") for w in WIDTHS]
        else:
            units.append((src, [], f"{name}.o"))
    return units


def _digest() -> str:
    units = [(flags, name) for _, flags, name in _units()]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + [repr(units)]).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    return h.hexdigest()[:16]


def _set_signatures(lib) -> None:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    per_width = {
        "ap_mixed_add_signed_multi": [vp, vp, vp, vp, i64, i32, i64, vp, vp],
        "ap_jac_add_multi_scan": [vp, vp, vp, i64, i32, i32, vp, vp],
        "ap_jac_add": [vp, vp, vp, i64, vp, vp],
        "ap_jac_add_window_scan": [vp, vp, i64, i32, i32, vp, vp],
        "ap_window_combine": [vp, vp, vp, i64, i32, i32, vp, vp],
        "ap_canon": [vp, vp, i64, i64, i32, vp, vp],
        "ap_consts_words": [],
        "ap_mixed_add": [vp, vp, vp, i64, i32, vp, vp],
        "ap_mixed_add_signed": [vp, vp, vp, vp, i64, i32, vp, vp],
        "ap_jac_add_multi": [vp, vp, vp, i64, i32, i32, vp, vp],
        "ap_field_mul": [vp, vp, vp, i64, i64, i64, i64, i64, i64, vp, vp],
        "ap_field_add_sub": [vp, vp, vp, i64, i64, i64, i64, i64, i64, i32, vp, vp],
        "ap_field_consts_words": [],
    }
    sigs = {f"{name}_w{w}": argtypes for name, argtypes in per_width.items() for w in WIDTHS}
    sigs["ap_ntt_pass"] = [vp, vp, vp, vp, vp, i64, i32, i32, i32, i64, i64, i64, i64, vp, vp]
    sigs["ap_ntt_consts_words"] = []
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


@contextlib.contextmanager
def _nvcc_stack():
    """Set this process's soft stack limit, which the nvcc processes started
    meanwhile inherit, to NVCC_STACK_BYTES (capped by the hard limit), and
    restore it after.  An unlimited stack is replaced too: cicc crashed
    under one as well."""
    soft, hard = resource.getrlimit(resource.RLIMIT_STACK)
    want = NVCC_STACK_BYTES if hard == resource.RLIM_INFINITY else min(hard, NVCC_STACK_BYTES)
    resource.setrlimit(resource.RLIMIT_STACK, (want, hard))
    try:
        yield
    finally:
        resource.setrlimit(resource.RLIMIT_STACK, (soft, hard))


def _compile(target: str) -> str:
    """nvcc -c for every source in parallel, then one link; returns the log."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objs, procs = [], []
        with _nvcc_stack():
            for src, flags, name in _units():
                obj = os.path.join(tmp, name)
                objs.append(obj)
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", obj, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ))
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
        so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(so, target)
    return log


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
            build_log = _compile(target)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(target)
        _set_signatures(lib)
        _lib = lib
        return lib


def entry(name: str, W: int):
    """The C entry point ``name`` of the object built for width W."""
    if W not in WIDTHS:
        raise NotImplementedError(f"the curve kernels are built for W in {WIDTHS}, not {W}")
    return getattr(library(), f"{name}_w{W}")


# ------------------------------------------------------- wrapper helpers

def check_tensor(name: str, t: torch.Tensor, shape: tuple) -> None:
    """A kernel operand must be a contiguous int32 CUDA tensor of ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def settle(device) -> None:
    """Wait for the current stream of a CUDA ``device``, so that a table or
    context built on it is complete before it is published to callers that
    read it on other streams (parallel/batch_prove.py); a one-time cost per
    table.  Nothing to wait for on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
