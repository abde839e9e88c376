"""Layered normalized min-sum QC-LDPC decoder (K5): wrapper of the CUDA
kernel and its plain version.

Counterpart of `neural_rx_tpu/kernels/ldpc_pallas.py` (`make_decoder`,
`tb_decode_fast`; the kernel is `csrc/ldpc_decode.cu`). The decode is the
Pallas kernel's and its NumPy oracle's (`reference_layered_decode`): check
rows in order, app updated in place, alpha = 0.8125, the first minimum of a
row masked for the second, hard bits out. The TPU tiling argument (`tile`)
and `interpret` have no counterpart: the CUDA kernel decodes all codewords
of a call in one launch, one codeword a block, and keeps per check row and
lane a compressed state (min1, min2, and a word of edge signs, the
first-minimum edge and the sign parity) from which it rebuilds each
message exactly; its scratch is [N, rows, 3, Z] 32-bit words.

Dispatch: a CPU tensor goes to the plain PyTorch version, a CUDA tensor
launches the kernel or raises. The plain version (float32, like the
kernel; the NumPy oracle runs in float64) rounds at the kernel's points:
the stored message alpha*sign*sgn*min is rounded once, and the new app
t + alpha*sign*sgn*min is rounded once, as one fused multiply-add. That is
what the JAX kernel computes on the CPU, where XLA contracts the multiply
and the add (`tests/test_torch_ldpc.py::test_jax_kernel_rounds_the_update_once`);
rounding the product before the add instead flips hard bits against the
float64 oracle at the seeds of `tests/test_ldpc_pallas.py`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..phy.nr.ldpc import LDPCCode
from ..phy.nr.tb import tb_decode
from . import _build

ALPHA = 0.8125  # normalized min-sum scaling
MAX_ROW_DEG = 19  # the kernel's per-lane register arrays (kMaxDeg)
MAX_Z = 384

# Kernel launches since the last reset; the wrapper adds one per launch.
launches = 0


def _row_plan(code: LDPCCode) -> list[list[tuple[int, int, int]]]:
    """Static per-row (col, shift, edge_index) schedule, edges numbered in
    row order."""
    plan, e = [], 0
    for r, cols in enumerate(code.rows):
        plan.append([(c, int(code.shifts[(r, c)]), e + i)
                     for i, c in enumerate(cols)])
        e += len(cols)
    return plan


def _plan_arrays(code: LDPCCode) -> dict:
    flat = [entry for row in _row_plan(code) for entry in row]
    cols, shifts, _ = zip(*flat)
    return {"row_ptr": code.row_ptr, "cols": np.asarray(cols),
            "shifts": np.asarray(shifts)}


def _plan_tensors(code: LDPCCode, device: torch.device) -> dict:
    """The row plan as int32 tensors on `device`: row_ptr [R + 1] and cols,
    shifts [E] in row order. Built once per (code, device)."""
    return {name: tables.on_device(
        ("ldpc_plan", code.bg, code.z, name), device,
        lambda name=name: _plan_arrays(code)[name], torch.int32)
        for name in ("row_ptr", "cols", "shifts")}


@functools.lru_cache(maxsize=16)
def _reference_rows(code: LDPCCode, device: torch.device) -> list:
    """Per row: (cols [deg, 1], lane index (j + s) mod Z [deg, Z], first
    and last edge) for the plain version's gathers and scatters."""
    lanes = torch.arange(code.z, device=device)
    rows = []
    for entries in _row_plan(code):
        cols = torch.tensor([c for c, _, _ in entries], device=device)
        shifts = torch.tensor([s for _, s, _ in entries], device=device)
        rows.append((cols[:, None], (lanes[None] + shifts[:, None]) % code.z,
                     entries[0][2], entries[-1][2] + 1))
    return rows


def fused_multiply_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                       ) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add does, for
    a = +-alpha: the product (at most 24 + 4 significant bits) is exact in
    float64, and so is the sum unless the two terms lie more than 2^29
    apart; then it is rounded twice, which differs from one rounding only
    if the larger term sits exactly halfway between two floats and the
    smaller one is below 2^-54 of it."""
    return (a.double() * b.double() + c.double()).float()


def layered_decode_reference(code: LDPCCode, llr: torch.Tensor,
                             num_iter: int = 20) -> torch.Tensor:
    """Plain PyTorch version of the kernel, vectorised over codewords.

    llr [N, n_cols*Z] float32 (internal log(p0/p1)) -> hard bits [N,
    n_cols*Z] float32 in {0, 1}."""
    n = llr.shape[0]
    app = llr.reshape(n, code.num_cols, code.z).clone()
    c2v = torch.zeros((n, code.num_edges, code.z), dtype=llr.dtype,
                      device=llr.device)
    for _ in range(num_iter):
        for cols, lanes, e0, e1 in _reference_rows(code, llr.device):
            t = app[:, cols, lanes] - c2v[:, e0:e1]  # [N, deg, Z]
            # sign: t < 0 is negative, so -0.0 counts as +1
            sgn = torch.where(t < 0, -1.0, 1.0)
            sign = sgn.prod(dim=1, keepdim=True)
            mag = t.abs()
            min1 = mag.amin(dim=1, keepdim=True)
            # mask only the FIRST occurrence of the minimum, in row order
            is_min = mag <= min1
            first = is_min & (is_min.cumsum(dim=1) == 1)
            min2 = torch.where(first, 1e30, mag).amin(dim=1, keepdim=True)
            other = torch.where(first, min2, min1)
            coef = ALPHA * sign * sgn  # +-alpha, exact
            c2v[:, e0:e1] = coef * other
            app[:, cols, lanes] = fused_multiply_add(coef, other, t)
    return (app < 0).to(llr.dtype).reshape(n, -1)


def layered_decode(code: LDPCCode, llr: torch.Tensor, num_iter: int = 20
                   ) -> torch.Tensor:
    """llr [N, n_cols*Z] float32 -> hard bits [N, n_cols*Z] float32. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if llr.device.type == "cpu":
        return layered_decode_reference(code, llr, num_iter)
    if llr.device.type != "cuda":
        raise ValueError(f"unsupported device {llr.device}")
    return _launch(code, llr, num_iter)


def _launch(code: LDPCCode, llr: torch.Tensor, num_iter: int
            ) -> torch.Tensor:
    global launches
    if llr.dtype != torch.float32:
        raise TypeError(f"ldpc_decode takes float32, not {llr.dtype}")
    if llr.dim() != 2 or llr.shape[1] != code.n_full \
            or not llr.is_contiguous():
        raise ValueError(f"llr must be a contiguous [N, {code.n_full}] "
                         f"tensor, got {tuple(llr.shape)}")
    if code.max_row_deg > MAX_ROW_DEG or code.z > MAX_Z:
        raise ValueError(f"the kernel takes rows of <= {MAX_ROW_DEG} edges "
                         f"and Z <= {MAX_Z}")
    n = llr.shape[0]
    out = torch.empty_like(llr)
    if n == 0:
        return out
    # check-node state, [N, rows, 3, Z] words (min1, min2, signs and first
    # minimum); the kernel never reads a row's state before it writes it, so
    # it needs no clearing
    state = torch.empty((n, code.num_rows, 3, code.z), dtype=torch.float32,
                        device=llr.device)
    plan = _plan_tensors(code, llr.device)
    lib = _build.load()
    rc = lib.nrx_ldpc_layered_decode(
        llr.data_ptr(), out.data_ptr(), state.data_ptr(),
        plan["row_ptr"].data_ptr(), plan["cols"].data_ptr(),
        plan["shifts"].data_ptr(), n, code.z, code.num_cols, code.num_rows,
        code.num_edges, num_iter,
        torch.cuda.current_stream(llr.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("ldpc_decode launch failed: "
                           + lib.nrx_cuda_error_string(rc).decode())
    launches += 1
    return out


def make_decoder(code: LDPCCode, num_iter: int = 20, kernels: bool = True):
    """fn(llr [..., n_cols*Z] internal log(p0/p1)) -> hard bits [...,
    n_cols*Z]: every leading index is one codeword, decoded in one call.
    kernels=False: the plain version on any device (the kernel's oracle on
    the card)."""
    decode_flat = layered_decode if kernels else layered_decode_reference

    def decode(llr: torch.Tensor) -> torch.Tensor:
        flat = llr.reshape(-1, code.n_full).contiguous()
        return decode_flat(code, flat, num_iter).reshape(llr.shape)
    return decode


def tb_decode_fast(cfg, llr: torch.Tensor, num_iter: int = 20,
                   kernels: bool = True):
    """`phy.nr.tb.tb_decode` through the layered decoder: the same I/O
    contract, and all C code blocks of the transport block in one call
    (one launch on the card)."""
    return tb_decode(cfg, llr,
                     decoder=make_decoder(cfg.code, num_iter, kernels))
