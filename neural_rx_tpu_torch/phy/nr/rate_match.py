"""LDPC rate matching / recovery, 38.212 §5.4.2.

The port's copy of `neural_rx_tpu/phy/nr/rate_match.py`. Index maps are
precomputed in NumPy per static (code, E, rv) config, so the TX path is
one gather and the RX path one scatter-add.

Covers: 2Z systematic puncturing, filler-bit skipping in the circular
buffer, redundancy-version start points, and the Qm bit interleaver
(f(i + j*Qm) = e(i*E/Qm + j)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ... import tables
from .ldpc import LDPCCode
from .ldpc_tables import BG_PARAMS

# rv -> (num, den) per base graph (Table 5.4.2.1-2, N = n*Z):
# k0 = floor(num * N / (den*Z)) * Z
_RV_K0 = {
    1: {0: (0, 1), 1: (17, 66), 2: (33, 66), 3: (56, 66)},
    2: {0: (0, 1), 1: (13, 50), 2: (25, 50), 3: (43, 50)},
}


@functools.lru_cache(maxsize=64)
def rate_match_indices(bg: int, z: int, k: int, k_prime: int, e: int,
                       qm: int, rv: int = 0) -> tuple:
    """-> (sel [E] buffer positions, interleave perm [E], its inverse
    out_pos [E]), int32.

    Buffer = codeword[2Z:], length N = (num_cols-2)*Z. Filler positions
    (k_prime-2Z .. k-2Z-1) are skipped during selection.
    """
    n_buf = (BG_PARAMS[bg]["num_cols"] - 2) * z
    filler_lo, filler_hi = k_prime - 2 * z, k - 2 * z
    num, den = _RV_K0[bg][rv]
    k0 = (num * n_buf // (den * z)) * z

    sel = np.zeros(e, np.int32)
    idx, count = k0, 0
    while count < e:
        pos = idx % n_buf
        if not (filler_lo <= pos < filler_hi):
            sel[count] = pos
            count += 1
        idx += 1

    # Qm interleaver as an output permutation: f[i + j*qm] = e_sel[i*(E/qm)+j]
    epq = e // qm
    j_grid, i_grid = np.meshgrid(np.arange(epq), np.arange(qm))
    out_pos = (i_grid + j_grid * qm).reshape(-1).astype(np.int32)
    perm = np.zeros(e, np.int32)
    perm[out_pos] = np.arange(e, dtype=np.int32)
    # f = selected[perm]; selected = f[out_pos] (out_pos is perm's inverse)
    return sel, perm, out_pos


def _indices(code: LDPCCode, k_prime: int, e: int, qm: int, rv: int,
             device) -> list[torch.Tensor]:
    key = (code.bg, code.z, code.k, k_prime, e, qm, rv)
    return [tables.on_device(("rate_match", i) + key, device,
                             lambda i=i: rate_match_indices(*key)[i],
                             torch.int64)
            for i in range(3)]


def rate_match(code: LDPCCode, codeword: torch.Tensor, k_prime: int, e: int,
               qm: int, rv: int = 0) -> torch.Tensor:
    """codeword [..., num_cols*Z] -> rate-matched bits [..., E]."""
    sel, perm, _ = _indices(code, k_prime, e, qm, rv, codeword.device)
    return codeword[..., 2 * code.z:][..., sel][..., perm]


def rate_recover(code: LDPCCode, llr: torch.Tensor, k_prime: int, qm: int,
                 rv: int = 0, filler_llr: float = 20.0) -> torch.Tensor:
    """Rate-matched LLRs [..., E] -> full-codeword LLRs [..., num_cols*Z].

    LLRs use the decoder-internal convention log(p0/p1); repeated buffer
    positions accumulate; fillers get +filler_llr (known zero bits);
    punctured first 2Z positions get 0.
    """
    e = llr.shape[-1]
    sel, _, inv = _indices(code, k_prime, e, qm, rv, llr.device)
    buf = torch.zeros(llr.shape[:-1] + (code.n,), dtype=llr.dtype,
                      device=llr.device)
    buf.index_add_(-1, sel, llr[..., inv])
    filler_lo, filler_hi = k_prime - 2 * code.z, code.k - 2 * code.z
    if filler_hi > filler_lo:
        buf[..., filler_lo:filler_hi] = filler_llr
    punct = torch.zeros(llr.shape[:-1] + (2 * code.z,), dtype=llr.dtype,
                        device=llr.device)
    return torch.cat([punct, buf], dim=-1)


def cb_bit_allocation(g: int, c: int, qm: int, num_layers: int = 1) -> list:
    """Per-code-block rate-matched lengths E_r (38.212 §5.4.2.1)."""
    g_prime = g // (num_layers * qm)
    es = []
    for r in range(c):
        if r <= c - (g_prime % c) - 1:
            es.append(num_layers * qm * (g_prime // c))
        else:
            es.append(num_layers * qm * -(-g_prime // c))
    if sum(es) != g:
        raise ValueError(f"code-block lengths {es} do not sum to G={g}")
    return es
