"""Builds the CUDA kernels of `deequ_tpu_torch/csrc/` with nvcc and loads
them with ctypes.

The build runs at first use, from the package's own sources, into
`deequ_tpu_torch/build/` (a directory git ignores). The library's file
name carries a digest of the sources, so an edited source builds anew and
a stale library is never loaded. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
SOURCES = ("kernels.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, the PATH, or /usr/local/cuda, in that order."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels build from source at first use"
    )


def library_path() -> str:
    digest = hashlib.sha1()
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libdeequ_kernels-{digest.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels unless this digest's library exists; returns
    the library path. `verbose` adds `-Xptxas -v` and returns nvcc's
    report on stderr (registers, shared memory and spills per kernel)."""
    out = library_path()
    if os.path.exists(out) and not verbose:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp] + [os.path.join(CSRC_DIR, name) for name in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    if verbose and proc.stderr:
        import sys

        sys.stderr.write(proc.stderr)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.dq_masked_moments.argtypes = [ptr, i32, ptr, i64, i32, i32, ptr, ptr, ptr, ptr]
            lib.dq_masked_moments.restype = i32
            lib.dq_centered_sumsq.argtypes = [
                ptr, i32, ptr, i64, i32, i32, ptr, ptr, ptr, ptr, ptr,
            ]
            lib.dq_centered_sumsq.restype = i32
            lib.dq_hll_register_max.argtypes = [ptr, ptr, i64, i32, i32, ptr, ptr]
            lib.dq_hll_register_max.restype = i32
            lib.dq_hist16.argtypes = [ptr, ptr, i64, i32, i64, i32, ptr, ptr]
            lib.dq_hist16.restype = i32
            lib.dq_dict_strings.argtypes = [
                ptr, ptr, i64, ctypes.c_ulonglong, ptr, i64, ptr, ptr, ptr, ptr, ptr,
            ]
            lib.dq_dict_strings.restype = i32
            lib.dq_hist16_select_scratch.argtypes = [i64, i64, i32]
            lib.dq_hist16_select_scratch.restype = i64
            lib.dq_hist16_select.argtypes = [ptr, ptr, i64, ptr, i64, i32, ptr, ptr, ptr, ptr]
            lib.dq_hist16_select.restype = i32
            _LIB = lib
        return _LIB
