"""5G NR QC-LDPC encoder and flooding belief-propagation decoder (38.212
§5.3.2), in plain PyTorch.

The port's copy of `neural_rx_tpu/phy/nr/ldpc.py`. The flooding decoder
is an XLA computation there, not a Pallas kernel, so plain torch is its
port; the layered min-sum kernel is `kernels/ldpc.py`.

- Encoding uses the structured spec algorithm: per-row accumulation of
  Z-block circular shifts, the special-column trick to solve p1, staircase
  back-substitution for p2..p4, then the degree-1 extension parities.
  GF(2) adds are float XORs ((a + b) mod 2).
- Decoding is flat-edge BP over the lifted graph with a static edge list:
  per-edge frame changes are gathers with a precomputed [E, Z] index map,
  and the per-row / per-column sums are products with one-hot E x R / E x C
  matrices. Check update: "boxplus" (phi function, the reference default,
  20 iterations) or "minsum".

LLR convention at the public boundary (`tb_decode`) is Sionna's,
llr = log(p1/p0); the decoder takes the internal log(p0/p1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ... import tables
from .ldpc_tables import BG_PARAMS, SPECIAL_ROWS, base_graph


class LDPCCode:
    """Static description of one lifted code (bg, z) + precomputed indices."""

    def __init__(self, bg: int, z: int):
        self.bg = bg
        self.z = z
        p = BG_PARAMS[bg]
        self.k_b = p["k_b"]
        self.num_rows = p["num_rows"]
        self.num_cols = p["num_cols"]
        self.k = self.k_b * z  # systematic bits (incl. filler)
        self.n_full = self.num_cols * z  # incl. punctured 2Z
        self.n = self.n_full - 2 * z  # circular buffer size (66Z / 50Z)
        rows, shifts = base_graph(bg, z)
        self.rows = rows
        self.shifts = shifts
        # Flat edge list, in row order
        er, ec, es = [], [], []
        for r, cols in enumerate(rows):
            for c in cols:
                er.append(r)
                ec.append(c)
                es.append(shifts[(r, c)])
        self.edge_row = np.asarray(er, np.int32)
        self.edge_col = np.asarray(ec, np.int32)
        self.edge_shift = np.asarray(es, np.int32)
        self.num_edges = len(er)
        self.row_ptr = np.concatenate(
            [[0], np.cumsum([len(c) for c in rows])]).astype(np.int32)
        self.max_row_deg = max(len(r) for r in rows)
        # Gather maps for frame changes: check frame sees var (i+s) mod Z.
        ar = np.arange(z)
        self.to_check_idx = (ar[None, :] + self.edge_shift[:, None]) % z
        self.to_var_idx = (ar[None, :] - self.edge_shift[:, None]) % z
        # One-hot segment-sum matrices (float32; tiny).
        self.row_onehot = np.zeros((self.num_edges, self.num_rows), np.float32)
        self.row_onehot[np.arange(self.num_edges), self.edge_row] = 1.0
        self.col_onehot = np.zeros((self.num_edges, self.num_cols), np.float32)
        self.col_onehot[np.arange(self.num_edges), self.edge_col] = 1.0
        # Padded per-row edge table (for min-sum): row_edges[r, d] = flat
        # edge index of the d-th edge of row r (0-padded, masked), plus the
        # inverse map flat-edge -> (row, slot) flattened for scatter-back.
        self.row_edges = np.zeros((self.num_rows, self.max_row_deg), np.int32)
        self.row_edge_mask = np.zeros((self.num_rows, self.max_row_deg), bool)
        self.row_edge_inv = np.zeros(self.num_edges, np.int32)
        for e in range(self.num_edges):
            r = self.edge_row[e]
            d = e - self.row_ptr[r]
            self.row_edges[r, d] = e
            self.row_edge_mask[r, d] = True
            self.row_edge_inv[e] = r * self.max_row_deg + d


@functools.lru_cache(maxsize=16)
def get_code(bg: int, z: int) -> LDPCCode:
    return LDPCCode(bg, z)


def _xor(a, b):
    return torch.remainder(a + b, 2.0)


def _special_shift(code: LDPCCode) -> int:
    """The shift t with P_t p1 = sum of the four core rows' info sums: the
    odd one out of the weight-3 special column's shifts (two are equal),
    or their common value."""
    s3 = [code.shifts[(r, code.k_b)] for r in SPECIAL_ROWS[code.bg]]
    if s3[0] == s3[1] == s3[2]:
        return s3[0]
    if s3[0] == s3[1]:
        return s3[2]
    if s3[0] == s3[2]:
        return s3[1]
    if s3[1] == s3[2]:
        return s3[0]
    raise ValueError(f"special column shifts {s3} all distinct")


def encode(code: LDPCCode, info: torch.Tensor) -> torch.Tensor:
    """Encode systematic info bits (filler already zeroed).

    info: [..., K] float {0,1} -> codeword [..., num_cols*Z] including the
    2Z punctured systematic bits (caller punctures). P_s x = roll(x, -s).
    """
    z = code.z
    blocks = info.reshape(info.shape[:-1] + (code.k_b, z))

    def row_info_sum(r):
        acc = torch.zeros(info.shape[:-1] + (z,), dtype=info.dtype,
                          device=info.device)
        for c in code.rows[r]:
            if c < code.k_b:
                acc = acc + torch.roll(blocks[..., c, :],
                                       -code.shifts[(r, c)], dims=-1)
        return torch.remainder(acc, 2.0)

    lam = [row_info_sum(r) for r in range(4)]
    # Summing the four lifted core rows cancels the shift-0 staircase and
    # the paired special-column circulants: P_t p1 = lam0+lam1+lam2+lam3.
    lam_sum = torch.remainder(lam[0] + lam[1] + lam[2] + lam[3], 2.0)
    p1 = torch.roll(lam_sum, _special_shift(code), dims=-1)

    def p1_term(r):
        if code.k_b in code.rows[r]:
            return torch.roll(p1, -code.shifts[(r, code.k_b)], dims=-1)
        return torch.zeros_like(p1)

    # Staircase back-substitution: row r involves parity cols k_b+r, k_b+r+1
    p2 = _xor(lam[0], p1_term(0))
    p3 = _xor(_xor(lam[1], p1_term(1)), p2)
    p4 = _xor(_xor(lam[2], p1_term(2)), p3)
    core = [p1, p2, p3, p4]

    # Extension parities (rows >= 4): sums over info + core terms.
    ext = []
    all_blocks = [blocks[..., c, :] for c in range(code.k_b)] + core
    for r in range(4, code.num_rows):
        acc = torch.zeros_like(p1)
        for c in code.rows[r]:
            if c < code.k_b + 4:
                acc = acc + torch.roll(all_blocks[c], -code.shifts[(r, c)],
                                       dims=-1)
        ext.append(torch.remainder(acc, 2.0))
    return torch.cat([info] + core + ext, dim=-1)


def _phi(x):
    """phi(x) = -log(tanh(x/2)), self-inverse, stable-clamped."""
    x = torch.clamp(x, 8.5e-4, 16.635)
    return torch.log((torch.exp(x) + 1.0) / (torch.exp(x) - 1.0))


def _decoder_tables(code: LDPCCode, device: torch.device) -> dict:
    t = {}
    for names, dtype in ((("row_onehot", "col_onehot", "row_edge_mask"),
                          None),
                         (("to_check_idx", "to_var_idx", "edge_row",
                           "edge_col", "row_edges", "row_edge_inv"),
                          torch.int64)):
        for name in names:
            t[name] = tables.on_device(
                ("ldpc", code.bg, code.z, name), device,
                lambda name=name: getattr(code, name), dtype)
    return t


def decode(code: LDPCCode, llr_ch: torch.Tensor, num_iter: int = 20,
           cn_type: str = "boxplus") -> torch.Tensor:
    """Flooding BP decode of channel LLRs.

    llr_ch: [..., num_cols*Z] in internal convention log(p0/p1)
    (punctured positions = 0, filler positions = +big).
    Returns hard bits [..., num_cols*Z].
    """
    if cn_type not in ("boxplus", "minsum"):
        raise ValueError(f"unknown cn_type {cn_type}")
    z = code.z
    batch_shape = llr_ch.shape[:-1]
    llr_blocks = llr_ch.reshape(batch_shape + (code.num_cols, z))
    t = _decoder_tables(code, llr_ch.device)

    def expand(idx):
        return idx.expand(batch_shape + idx.shape)

    def var_totals(c2v):
        c2v_var = torch.gather(c2v, -1, expand(t["to_var_idx"]))
        col_sums = torch.einsum("...ez,ec->...cz", c2v_var, t["col_onehot"])
        return llr_blocks + col_sums

    c2v = torch.zeros(batch_shape + (code.num_edges, z), dtype=llr_ch.dtype,
                      device=llr_ch.device)
    for _ in range(num_iter):
        # --- variable update ---
        v_total = var_totals(c2v)
        v2c = (torch.gather(v_total[..., t["edge_col"], :], -1,
                            expand(t["to_check_idx"])) - c2v)
        # --- check update (all-but-self boxplus / minsum) ---
        neg = (v2c < 0).to(llr_ch.dtype)
        row_neg = torch.einsum("...ez,er->...rz", neg, t["row_onehot"])
        # sign of product of others = row sign parity / own sign
        others_neg = row_neg[..., t["edge_row"], :] - neg
        sign_out = 1.0 - 2.0 * torch.remainder(others_neg, 2.0)
        mag = v2c.abs()
        if cn_type == "boxplus":
            pm = _phi(mag)
            row_pm = torch.einsum("...ez,er->...rz", pm, t["row_onehot"])
            mag_out = _phi(row_pm[..., t["edge_row"], :] - pm)
        else:
            # normalized min-sum: padded per-row gather, two-minima trick
            mask = t["row_edge_mask"][:, :, None]
            padded = torch.where(mask, mag[..., t["row_edges"], :],
                                 torch.full((), 1e9, dtype=mag.dtype,
                                            device=mag.device))
            min1, arg1 = padded.min(dim=-2, keepdim=True)
            slot = torch.arange(padded.shape[-2], device=mag.device)[:, None]
            is_min = slot == arg1
            min2 = torch.where(is_min, 1e9, padded).amin(dim=-2, keepdim=True)
            others_min = torch.where(is_min, min2, min1)
            mag_out = 0.8125 * others_min.reshape(
                batch_shape + (-1, z))[..., t["row_edge_inv"], :]
        c2v = sign_out * mag_out
    bits = (var_totals(c2v) < 0).to(llr_ch.dtype)
    return bits.reshape(batch_shape + (code.n_full,))
