"""The `.cirbin` CIR dataset format: writer, native reader, NumPy reader.

The port's counterpart of `neural_rx_tpu/channel/io_native.py`, same
format: the magic "CIR1", then uint32 N, R, X, P, then a [N, R, X, P]
complex64 (float32 re/im interleaved), then tau [N, P] float32.

`read_cirbin` maps the file with the port's copy of the C++ reader
(`channel/native/cir_reader.cc`), built with g++ into the gitignored
`neural_rx_tpu_torch/_build/` at first use (the library's name carries a
hash of the source) and loaded with ctypes. A failed build raises; the
NumPy reader, `read_cirbin_numpy`, is a function of its own that a caller
names, never a silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG_DIR, "channel", "native", "cir_reader.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_lib = None


def library_path() -> str:
    """Where the reader library for the current source lives."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libcirreader_{digest}.so")


def build() -> str:
    """Compile the reader unless the library for this source exists;
    returns its path. Raises CalledProcessError if g++ fails."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, SRC],
                       check=True, capture_output=True)
        os.replace(tmp, path)  # atomic: concurrent builds agree
    return path


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.cir_open.restype = ctypes.c_void_p
        lib.cir_open.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_uint32)]
        lib.cir_a_ptr.restype = ctypes.POINTER(ctypes.c_float)
        lib.cir_a_ptr.argtypes = [ctypes.c_void_p]
        lib.cir_tau_ptr.restype = ctypes.POINTER(ctypes.c_float)
        lib.cir_tau_ptr.argtypes = [ctypes.c_void_p]
        lib.cir_close.restype = None
        lib.cir_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def write_cirbin(path: str, a: np.ndarray, tau: np.ndarray) -> None:
    """a: [N, R, X, P] complex64; tau: [N, P] float32."""
    a = np.ascontiguousarray(a, np.complex64)
    tau = np.ascontiguousarray(tau, np.float32)
    n, r, x, p = a.shape
    if tau.shape != (n, p):
        raise ValueError(f"tau {tau.shape} does not match a {a.shape}")
    with open(path, "wb") as f:
        f.write(b"CIR1")
        f.write(np.asarray([n, r, x, p], np.uint32).tobytes())
        f.write(a.view(np.float32).tobytes())
        f.write(tau.tobytes())


def read_cirbin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(a [N, R, X, P] complex64, tau [N, P] float32) through the native
    reader (the file mapped, the arrays copied out before it is closed)."""
    lib = _get_lib()
    meta = (ctypes.c_uint32 * 4)()
    h = lib.cir_open(path.encode(), meta)
    if not h:
        raise OSError(f"cannot open CIR dataset {path}")
    try:
        n, r, x, p = (int(meta[i]) for i in range(4))
        a = np.ctypeslib.as_array(lib.cir_a_ptr(h),
                                  shape=(n * r * x * p * 2,)).copy()
        tau = np.ctypeslib.as_array(lib.cir_tau_ptr(h),
                                    shape=(n * p,)).copy()
    finally:
        lib.cir_close(h)
    return a.view(np.complex64).reshape(n, r, x, p), tau.reshape(n, p)


def read_cirbin_numpy(path: str) -> tuple[np.ndarray, np.ndarray]:
    """`read_cirbin` with NumPy alone."""
    with open(path, "rb") as f:
        if f.read(4) != b"CIR1":
            raise ValueError(f"{path} is not a CIR1 dataset")
        n, r, x, p = (int(v) for v in np.frombuffer(f.read(16), np.uint32))
        a = np.frombuffer(f.read(n * r * x * p * 8), np.complex64)
        tau = np.frombuffer(f.read(n * p * 4), np.float32)
    return a.reshape(n, r, x, p).copy(), tau.reshape(n, p).copy()
