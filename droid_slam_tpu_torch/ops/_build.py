"""Builds and loads the port's CUDA kernels.

One ``nvcc`` process per ``csrc/*.cu``, all started together, compiles the
sources to objects; one more links them into a shared library with a plain C
interface, ``build/libdroid_torch_kernels.so`` inside the package, which
``ctypes`` loads. It is rebuilt only when a source is newer than the
library. Nothing is built at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libdroid_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC"]

_lib = None
last_build_seconds = 0.0  # nvcc wall time of this process's build (0: none)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build(timeout: float = 600.0) -> str:
    """Compile the library if a source is newer; returns its path."""
    global last_build_seconds
    srcs = _sources()
    if (os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH)
            >= max(os.path.getmtime(s) for s in srcs)):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]
    tmp = f"{LIB_PATH}.{tag}"
    tic = time.perf_counter()
    left = lambda: max(timeout - (time.perf_counter() - tic), 1.0)
    procs = []
    try:
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, o in zip(srcs, objs)]
        for src, proc in zip(srcs, procs):
            _, err = proc.communicate(timeout=left())
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"({proc.returncode}):\n{err[-4000:]}")
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True,
                              timeout=left())
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr[-4000:]}")
        os.replace(tmp, LIB_PATH)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        last_build_seconds = time.perf_counter() - tic
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn = handle.droid_corr_lookup
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                       vp, vp, vp, vp]
        fn.restype = ci
        fn = handle.droid_alt_corr
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp,
                       ci, vp, vp]
        fn.restype = ci
        fn = handle.droid_frame_distance
        fn.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, ci, ci,
                       ctypes.c_float, ctypes.c_float, ci, vp, vp]
        fn.restype = ci
        for name in ("droid_gru_epilogue_a", "droid_gru_epilogue_b"):
            fn = getattr(handle, name)
            fn.argtypes = [ci, ci, ci, ci] + [vp] * 8
            fn.restype = ci
        _lib = handle
    return _lib
