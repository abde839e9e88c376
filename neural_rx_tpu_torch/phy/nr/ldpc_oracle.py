"""ctypes binding of the native GF(2) LDPC oracle encoder.

The port's copy of `neural_rx_tpu/phy/nr/ldpc_oracle.py`: an encoder
independent of `ldpc.py`'s structured one (generic bitset Gaussian
elimination on the lifted 4Z x 4Z core system, no special-column or
staircase assumption), for tests that cross-check that encoder under the
live shift table. The port's copy of its source,
`phy/nr/native/ldpc_oracle.cc`, is built with g++ into the gitignored
`neural_rx_tpu_torch/_build/` at first use (the library's name carries a
hash of the source), as `channel/io_native.py` builds its reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(_PKG_DIR, "phy", "nr", "native", "ldpc_oracle.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_lib = None


def library_path() -> str:
    """Where the oracle library for the current source lives."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libldpcoracle_{digest}.so")


def build() -> str:
    """Compile the oracle unless the library for this source exists;
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
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.ldpc_encode_oracle.restype = ctypes.c_int
        lib.ldpc_encode_oracle.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, i32p, i32p, i32p, u8p, u8p]
        _lib = lib
    return _lib


def encode_oracle(code, info: np.ndarray) -> np.ndarray:
    """The codeword [num_cols * Z] (uint8 0/1) of one info vector [K]
    (0/1) by the native generic solver; `code` is an `ldpc.LDPCCode`."""
    lib = _get_lib()
    info = np.ascontiguousarray(np.asarray(info) % 2, np.uint8)
    if info.shape != (code.k,):
        raise ValueError(f"info of shape {info.shape}, expected ({code.k},)")
    out = np.zeros(code.n_full, np.uint8)
    ret = lib.ldpc_encode_oracle(
        code.num_rows, code.num_cols, code.k_b, code.z, code.num_edges,
        np.ascontiguousarray(code.edge_row, np.int32),
        np.ascontiguousarray(code.edge_col, np.int32),
        np.ascontiguousarray(code.edge_shift, np.int32), info, out)
    if ret != 0:
        raise RuntimeError(f"oracle encoder failed with code {ret}")
    return out
