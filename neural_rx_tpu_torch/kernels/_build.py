"""Build the port's CUDA kernels with plain nvcc and load them with ctypes.

At first use, one `nvcc` per `csrc/*.cu`, all started together, compiles
the sources into objects, and one more links them into a shared library
with a plain C interface (no PyTorch headers, so the build takes seconds)
inside `_build/` next to this package, which `.gitignore` lists.
The library's file name carries a hash of the sources and flags, so it is
rebuilt only when a source changes. Nothing is built when this module is
imported. Several processes (the ranks of one card, `dist/`) may build at
once: a lock file beside the library lets one of them compile while the
others wait and then load its library (an advisory `flock`, which the
system drops when its holder dies), and each build writes its objects and
link output under names of its own before the one rename.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# compile flags of each source; the grid-wide barrier of the whole-CGNN
# kernel (cooperative_groups) needs no separate device linking
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> (restype, argtypes)
_SIGNATURES = {
    # x, w, out, dtype, n, h, w_cols, n_layers, widths, lo, hi, mode,
    # stream
    "nrx_sepconv_stack": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I,
                               _I, _P]),
    # s, pe, act, out, out2, agg_w, agg_dims, upd_w, n_layers, widths,
    # ro_w, ro_dims, ch_w, ch_dims, dtype, b, t, h, w, d_s, d_pe, lo, hi,
    # lp, stream
    "nrx_cgnn_iter": (_I, [_P] * 8 + [_I, _P, _P, _P, _P, _P]
                      + [_I] * 10 + [_P]),
    # z0, pe, act, state_a, state_b, llr, hh, init_w, n_init, init_widths,
    # agg_w, agg_dims, upd_w, n_upd, upd_widths, ro_w, ro_dims, ch_w,
    # ch_dims, num_it, dtype, b, t, h, w, d_s, d_pe, lo, hi, lp, stream
    "nrx_cgnn_full": (_I, [_P] * 8 + [_I, _P, _P, _P, _P, _I]
                      + [_P] * 5 + [_I] * 11 + [_P]),
    # llr, out, state, row_ptr, cols, shifts, n, z, n_cols, n_rows,
    # n_edges, num_iter, stream
    "nrx_ldpc_layered_decode": (_I, [_P] * 6 + [_I] * 6 + [_P]),
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnrx_kernels_{h.hexdigest()[:16]}.so")


def _run(cmds: list[list[str]]) -> str:
    """Runs the commands at once; their output, or raises on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {p.returncode}:\n"
                               f"{' '.join(c)}\n{log}")
    return "".join(logs)


def build() -> BuildInfo:
    """Compile the kernels unless the library for these sources exists.
    Safe to call from several processes at once: one compiles, the others
    wait for it and find the library (seconds 0)."""
    path = library_path()
    if os.path.exists(path):
        return BuildInfo(path, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # built while this process waited
            return BuildInfo(path, 0.0, "")
        nvcc = _nvcc()
        srcs = [s for s in _sources() if s.endswith(".cu")]
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, f"{os.path.basename(s)}.o")
                    for s in srcs]
            out = os.path.join(tmp, os.path.basename(path))
            t0 = time.perf_counter()
            log = _run([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                        for s, o in zip(srcs, objs)])
            log += _run([[nvcc, *LINK_FLAGS, "-o", out, *objs]])
            seconds = time.perf_counter() - t0
            os.replace(out, path)
    return BuildInfo(path, seconds, log)


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
