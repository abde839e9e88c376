"""Build the port's CUDA kernels with plain nvcc and load them with ctypes.

At first use, one `nvcc` call compiles every `csrc/*.cu` into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds) inside `_build/` next to this package, which `.gitignore` lists.
The library's file name carries a hash of the sources and flags, so it is
rebuilt only when a source changes. Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> (restype, argtypes)
_SIGNATURES = {
    # x, w, out, dtype, n, h, w_cols, n_layers, widths, lo, hi, stream
    "nrx_sepconv_stack": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I,
                               _P]),
    "nrx_cuda_error_string": (ctypes.c_char_p, [_I]),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str
    seconds: float  # compile time; 0 when the library was already built
    log: str        # the compiler's output (ptxas register/spill report)


_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnrx_kernels_{h.hexdigest()[:16]}.so")


def build() -> BuildInfo:
    """Compile the kernels unless the library for these sources exists."""
    path = library_path()
    if os.path.exists(path):
        return BuildInfo(path, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {r.returncode}:\n"
                           f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)
    return BuildInfo(path, seconds, r.stdout + r.stderr)


def load() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build().path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib
