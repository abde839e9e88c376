"""Classical baseline receivers: LMMSE and K-Best / ML detection, and the
covariance-based LMMSE channel interpolator.

The port's copy of `neural_rx_tpu/rx/baselines.py`, in plain PyTorch (the
JAX package computes these with XLA, outside any Pallas kernel):

- `lmmse_equalize`: per-RE MMSE equalisation with a unit-power symbol
  prior, returning Sionna's unbiased estimates x_hat = x + e and per-stream
  effective noise variances;
- `kbest_detect`: max-log LLRs from the exact candidate set for small
  search spaces (<= 2 streams, <= 64 points: `_ml_maxlog_detect`), else
  from a K-Best survivor list (QR, per-level expansion and top-k prune,
  SQRD ordering);
- `LMMSEChannelInterpolator`: space-frequency-time LMMSE interpolation from
  measured covariance matrices, with the weights solved per call at the
  caller's noise level (exact mode) or taken from precomputed per-noise
  banks over PRB chunks (chunked mode).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import tables
from ..phy.constellation import bit_labels, qam_points

_BIG = 1e9
LLR_CLIP = 20.0  # |LLR| of a bit without a counter-hypothesis
QR_MAX_UNROLLED = 4  # streams of the unrolled Gram-Schmidt QR


def _points_labels(num_bits_per_symbol: int, device):
    """(points [P] complex64, labels [P, m] float32) on `device`."""
    return (tables.on_device(("qam_points", num_bits_per_symbol), device,
                             lambda: qam_points(num_bits_per_symbol)),
            tables.on_device(("bit_labels", num_bits_per_symbol), device,
                             lambda: bit_labels(num_bits_per_symbol)))


def _noise(no, device) -> torch.Tensor | float:
    """no as float32: a number stays one, a tensor moves to `device`."""
    if isinstance(no, torch.Tensor):
        return no.to(device=device, dtype=torch.float32)
    return float(np.float32(no))


def _metric_noise(no):
    """The divisor of the detectors' metrics: no floored at 1e-12, a tensor
    given a trailing axis for the candidates."""
    if isinstance(no, torch.Tensor):
        return no.clamp_min(1e-12)[..., None]
    return max(no, 1e-12)


# ---------------------------------------------------------------------------
# LMMSE detection
# ---------------------------------------------------------------------------

def lmmse_equalize(y: torch.Tensor, h: torch.Tensor, no):
    """Per-RE LMMSE equalisation.

    y: [..., ant]; h: [..., ant, streams] complex64; no: noise variance (a
    number or a tensor broadcastable to [...]). Returns (x_hat [...,
    streams], no_eff [..., streams]) with the unbiased convention
    x_hat = x + e, Var(e) = no_eff.
    """
    no = _noise(no, y.device)
    hh = torch.einsum("...as,...at->...st", h.conj(), h)
    eye = torch.eye(hh.shape[-1], dtype=hh.dtype, device=hh.device)
    if isinstance(no, torch.Tensor):
        a = hh + no[..., None, None] * eye
    else:
        a = hh + no * eye
    hy = torch.einsum("...as,...a->...s", h.conj(), y)
    # one factorisation for both right-hand sides: A^-1 H^H y, A^-1 H^H H
    # (solve_ex: A is positive definite, and checking would wait for the
    # device)
    sol = torch.linalg.solve_ex(a, torch.cat([hy[..., None], hh],
                                             dim=-1))[0]
    x_tilde = sol[..., 0]
    # bias mu_s = [A^-1 H^H H]_ss
    mu = torch.diagonal(sol[..., 1:], dim1=-2, dim2=-1).real
    mu = mu.clamp(1e-6, 1.0 - 1e-6)
    return x_tilde / mu, (1.0 - mu) / mu


# ---------------------------------------------------------------------------
# K-Best detection
# ---------------------------------------------------------------------------

def _qr_small(h: torch.Tensor):
    """Batched thin QR of few-stream channels [..., ant, S] -> (q [...,
    ant, S], r [..., S, S]): modified Gram-Schmidt unrolled over the
    streams, `torch.linalg.qr` above QR_MAX_UNROLLED. Any valid QR gives the
    same detection (only A = QR with orthonormal Q is needed)."""
    s = h.shape[-1]
    if s > QR_MAX_UNROLLED:
        return torch.linalg.qr(h)
    qs, cols = [], []
    for j in range(s):
        v = h[..., :, j]
        rj = []
        for i in range(j):
            rij = (qs[i].conj() * v).sum(dim=-1)
            v = v - rij[..., None] * qs[i]
            rj.append(rij)
        nrm = (v.abs() ** 2).sum(dim=-1).sqrt()
        qs.append(v / nrm.clamp_min(1e-20)[..., None].to(v.dtype))
        rj.append(nrm.to(h.dtype))
        rj += [torch.zeros_like(nrm).to(h.dtype)] * (s - j - 1)
        cols.append(torch.stack(rj, dim=-1))  # r[:, j] (i = 0..S-1)
    return torch.stack(qs, dim=-1), torch.stack(cols, dim=-1)


def _bit_max(metric: torch.Tensor, labels: torch.Tensor):
    """Per bit, the largest metric over the points whose bit is 1 and over
    those whose bit is 0: metric [..., P], labels [P, m] -> ([..., m],
    [..., m])."""
    one = labels.T > 0.5  # [m, P]
    met = metric[..., None, :]
    return (torch.where(one, met, -_BIG).amax(dim=-1),
            torch.where(one, -_BIG, met).amax(dim=-1))


def _ml_maxlog_detect(y, h, no, points, labels, n_streams: int):
    """Exact max-log detection over the full candidate set (1 or 2
    streams). y: [..., ant]; h: [..., ant, S] -> [..., S, m].

    Constant-per-RE |y|^2 terms cancel in LLR differences, so the metric is
    -2 Re<z, c> + c^H G c with z = H^H y, G = H^H H. For 2 streams a loop
    over the stream-0 point carries running per-bit maxima and a per-c1
    best metric: O(REs * P) memory, never the [REs, P^2, ant]
    cross-product (~8 GB at 132 PRB).
    """
    m = labels.shape[-1]
    no = _metric_noise(no)
    p_abs2 = points.abs() ** 2  # [P]

    if n_streams == 1:
        # d(c) - |y|^2 = -2 Re(y^H h c) + |h|^2 |c|^2
        z = torch.einsum("...a,...as->...s", y.conj(), h)[..., 0]
        g = (h[..., 0].abs() ** 2).sum(dim=-1)
        d = -2.0 * (z[..., None] * points).real + g[..., None] * p_abs2
        m1, m0 = _bit_max(-d / no, labels)
        return (m1 - m0).clamp(-LLR_CLIP, LLR_CLIP)[..., None, :]

    if n_streams != 2:
        raise ValueError("exact max-log detection takes 1 or 2 streams")
    z = torch.einsum("...as,...a->...s", h.conj(), y)  # [..., 2]
    gram = torch.einsum("...as,...at->...st", h.conj(), h)
    g00 = gram[..., 0, 0].real
    g11 = gram[..., 1, 1].real
    g01 = gram[..., 0, 1]  # h0^H h1
    # terms independent of c0: [..., P] over c1
    v1 = g11[..., None] * p_abs2 \
        - 2.0 * (z[..., 1:2].conj() * points).real
    shape = y.shape[:-1]
    m1_0 = torch.full(shape + (m,), -_BIG, device=y.device)
    m0_0 = torch.full(shape + (m,), -_BIG, device=y.device)
    best1 = torch.full(shape + (points.shape[0],), -_BIG, device=y.device)
    bits = labels > 0.5  # [P, m]
    z0c = z[..., 0].conj()
    for s0 in range(points.shape[0]):
        c0 = points[s0]
        a0 = g00 * p_abs2[s0] - 2.0 * (z0c * c0).real  # [...]
        cross = 2.0 * (g01[..., None] * c0.conj() * points).real
        met = -(a0[..., None] + v1 + cross) / no  # [..., P] over c1
        best1 = torch.maximum(best1, met)  # per-c1 best over all c0
        mbest = met.amax(dim=-1, keepdim=True)  # best over c1 for this c0
        b0 = bits[s0]  # [m]
        m1_0 = torch.maximum(m1_0, torch.where(b0, mbest, -_BIG))
        m0_0 = torch.maximum(m0_0, torch.where(b0, -_BIG, mbest))
    llr0 = (m1_0 - m0_0).clamp(-LLR_CLIP, LLR_CLIP)
    m1_1, m0_1 = _bit_max(best1, labels)
    llr1 = (m1_1 - m0_1).clamp(-LLR_CLIP, LLR_CLIP)
    return torch.stack([llr0, llr1], dim=-2)  # [..., 2, m]


def kbest_detect(y: torch.Tensor, h: torch.Tensor, no,
                 num_bits_per_symbol: int, k: int = 64,
                 exact: bool | None = None):
    """K-Best MIMO detection with max-log LLRs.

    y: [..., ant]; h: [..., ant, streams] complex64; no: a number or a
    tensor broadcastable to [...]. Returns llr [..., streams,
    num_bits_per_symbol] in the log(p1/p0) convention.

    exact: None picks the exact max-log over the full candidate set when
    n_streams <= 2 and the constellation has <= 64 points (every live
    configuration), True forces it (<= 2 streams), False forces the
    k-survivor list: QR with the strongest stream detected first (SQRD
    order), each level's survivors expanded by every point and the k best
    partial distances kept; bits without a counter-hypothesis in the final
    list get +-LLR_CLIP (every LLR is clipped to that).
    """
    points, labels = _points_labels(num_bits_per_symbol, y.device)
    n_pts = points.shape[0]
    n_streams = h.shape[-1]
    no = _noise(no, y.device)
    if exact is None:
        exact = n_streams <= 2 and n_pts <= 64
    if exact:
        return _ml_maxlog_detect(y, h, no, points, labels, n_streams)

    order = None
    if n_streams > 1:
        norms = (h.abs() ** 2).sum(dim=-2)  # [..., S]
        order = torch.argsort(norms, dim=-1, stable=True)  # strongest last
        h = h.gather(-1, order[..., None, :].expand(h.shape))
    q, r = _qr_small(h)
    z = torch.einsum("...as,...a->...s", q.conj(), y)

    # level 0: the last stream
    s_idx = n_streams - 1
    ped = (z[..., s_idx:s_idx + 1] - r[..., s_idx, s_idx][..., None]
           * points).abs() ** 2  # [..., P]
    negped, top = torch.topk(-ped, min(k, n_pts), dim=-1)
    ped = -negped
    cand_idx = top[..., None]  # [..., cand, level]: point index per level
    for lvl in range(1, n_streams):
        s = n_streams - 1 - lvl
        n_cand = cand_idx.shape[-2]
        # interference of the streams already detected
        interf = torch.zeros(ped.shape, dtype=torch.complex64,
                             device=y.device)
        for j in range(lvl):
            sj = n_streams - 1 - j
            interf = interf + r[..., s, sj][..., None] \
                * points[cand_idx[..., j]]
        resid = z[..., s][..., None] - interf  # [..., cand]
        ped_new = ped[..., None] + (
            resid[..., None] - r[..., s, s][..., None, None] * points
        ).abs() ** 2  # [..., cand, P]
        ped_flat = ped_new.reshape(ped_new.shape[:-2] + (n_cand * n_pts,))
        negped, top = torch.topk(-ped_flat, min(k, n_cand * n_pts), dim=-1)
        ped = -negped
        new_sym = top % n_pts
        parent = top // n_pts
        cand_idx = cand_idx.gather(
            -2, parent[..., None].expand(parent.shape + (lvl,)))
        cand_idx = torch.cat([cand_idx, new_sym[..., None]], dim=-1)

    # max-log LLRs per stream and bit from the survivor list
    metric = (-ped / _metric_noise(no))[..., None]  # [..., cand, 1]
    llrs = []
    for st in range(n_streams):
        bits = labels[cand_idx[..., n_streams - 1 - st]]  # [..., cand, m]
        m1 = torch.where(bits > 0.5, metric, -_BIG).amax(dim=-2)
        m0 = torch.where(bits < 0.5, metric, -_BIG).amax(dim=-2)
        llrs.append((m1 - m0).clamp(-LLR_CLIP, LLR_CLIP))
    out = torch.stack(llrs, dim=-2)  # [..., streams (detection order), m]
    if order is not None:
        # out[pos] belongs to stream order[pos]: undo the permutation
        inv = torch.argsort(order, dim=-1)
        out = out.gather(-2, inv[..., None].expand(out.shape))
    return out


# ---------------------------------------------------------------------------
# LMMSE channel interpolation from measured covariances
# ---------------------------------------------------------------------------

def _lmmse_weights(cov: np.ndarray, obs_idx: np.ndarray,
                   noise_var: float) -> np.ndarray:
    """W = R[:, obs] (R[obs, obs] + noise I)^-1 : [N, n_obs]."""
    r_oo = cov[np.ix_(obs_idx, obs_idx)]
    r_ao = cov[:, obs_idx]
    a = r_oo + noise_var * np.eye(len(obs_idx))
    return r_ao @ np.linalg.inv(a)


def _best_chunk_size(n_prb: int, target: int = 20) -> int:
    """The smallest divisor of n_prb that is >= target PRBs (else
    n_prb)."""
    for d in range(target, n_prb + 1):
        if n_prb % d == 0:
            return d
    return n_prb


class LMMSEChannelInterpolator:
    """Space-frequency-time LMMSE interpolation (order "s-f-t") from
    measured covariance matrices.

    Two modes:
    - exact (lmmse_num_prbs == -1, every configuration): full-band
      frequency LMMSE with the weights solved on the device per call at
      the caller's noise level: one [P, P] complex solve per stage and TX;
    - chunked (lmmse_num_prbs >= 0; 0 picks the chunk size): PRB chunks
      with weights precomputed for each level of `NOISE_GRID`; the
      caller's noise picks the nearest bank on a log scale.

    Both regularise with the pilot-level noise no / pilot power. The
    complex tables go to each device once (`tables.on_device`).
    """

    NOISE_GRID = (0.8, 0.5, 0.32, 0.2, 0.125, 0.08, 0.05, 0.032, 0.02,
                  0.0125, 0.008, 0.005)

    def __init__(self, resource_grid, cov_freq: np.ndarray,
                 cov_time: np.ndarray, cov_space: np.ndarray,
                 lmmse_num_prbs: int = -1):
        rg = resource_grid
        self.rg = rg
        n_sc = rg.num_subcarriers
        n_prb = n_sc // 12
        mask = rg.pilot_mask
        self.dmrs_syms = np.where(mask.any(axis=1))[0]
        self.exact = lmmse_num_prbs == -1
        if self.exact:
            chunk_prbs = n_prb
        elif lmmse_num_prbs == 0:
            chunk_prbs = _best_chunk_size(n_prb) if n_prb > 100 else n_prb
        else:
            chunk_prbs = lmmse_num_prbs
        self.chunk_sc = chunk_prbs * 12
        self.num_chunks = n_sc // self.chunk_sc

        slot = rg.configs[0].carrier.slot_number
        # mean pilot power (beta^2): converts the symbol-level no to the
        # noise of the LS estimates at the pilots
        pil = rg.pilots[slot]
        self._pilot_pow = float(np.mean(np.abs(pil[np.abs(pil) > 0]) ** 2))
        self._pilot_sc = {}
        for tx in range(rg.num_tx):
            nz = np.abs(rg.dmrs_grids[slot, tx, self.dmrs_syms[0]]) > 1e-3
            self._pilot_sc[tx] = np.where(nz)[0]
        digest = hashlib.sha1()
        for a in (cov_freq, cov_time, cov_space):
            digest.update(np.ascontiguousarray(a).tobytes())
        self._key = (digest.hexdigest(), rg._key, lmmse_num_prbs)

        if self.exact:
            c64 = np.complex64
            self._host = {"ct_oo": cov_time[np.ix_(
                self.dmrs_syms, self.dmrs_syms)].astype(c64),
                "ct_ao": cov_time[:, self.dmrs_syms].astype(c64),
                "cs": cov_space.astype(c64)}
            for tx in range(rg.num_tx):
                obs = self._pilot_sc[tx]
                self._host[f"cf_oo{tx}"] = cov_freq[np.ix_(obs, obs)].astype(
                    c64)
                self._host[f"cf_ao{tx}"] = cov_freq[:, obs].astype(c64)
            return

        cf = cov_freq[:self.chunk_sc, :self.chunk_sc]
        grid = list(self.NOISE_GRID)
        self._noise_grid = np.asarray(grid, np.float32)
        self._host = {}
        for tx in range(rg.num_tx):
            nz = np.abs(rg.dmrs_grids[slot, tx, self.dmrs_syms[0]]) > 1e-3
            sc_idx = np.where(nz[:self.chunk_sc])[0]
            self._host[f"wf{tx}"] = np.stack(
                [_lmmse_weights(cf, sc_idx, nv) for nv in grid]
            ).astype(np.complex64)  # [L, chunk_sc, pilots_in_chunk]
        self._host["wt"] = np.stack(
            [_lmmse_weights(cov_time, self.dmrs_syms, nv) for nv in grid]
        ).astype(np.complex64)  # [L, 14, n_dmrs]
        n_ant = cov_space.shape[0]
        self._host["ws"] = np.stack(
            [(cov_space @ np.linalg.inv(cov_space + nv * np.eye(n_ant)))
             for nv in grid]).astype(np.complex64)  # [L, ant, ant]

    def _table(self, name: str, device) -> torch.Tensor:
        return tables.on_device(("lmmse_interp", self._key, name), device,
                                lambda: self._host[name])

    def bank_index(self, no: float) -> int:
        """Chunked mode: the index into `NOISE_GRID` of the bank nearest on
        a log scale to the pilot-level noise of `no`."""
        no_pil = self._pilot_noise(no)
        return int(np.argmin(np.abs(
            np.log(np.maximum(no_pil, np.float32(1e-9)))
            - np.log(self._noise_grid))))

    def _pilot_noise(self, no: float) -> np.float32:
        """no / pilot power in float32, as the JAX package computes it."""
        return np.float32(np.float32(no) / np.float32(self._pilot_pow))

    def __call__(self, h_pilots: dict, no: float) -> torch.Tensor:
        """h_pilots: per tx -> [b, ant, n_dmrs_syms, n_pilot_sc] LS
        estimates at the TX's nonzero pilot REs; no: the symbol-level noise
        variance. Returns [b, ant, tx, 14, sc] complex64."""
        if self.exact:
            return self._call_exact(h_pilots, self._pilot_noise(no))
        dev = h_pilots[0].device
        idx = self.bank_index(no)
        ws = self._table("ws", dev)[idx]
        wt = self._table("wt", dev)[idx]
        outs = []
        for tx in range(self.rg.num_tx):
            hp = torch.einsum("ij,bjts->bits", ws, h_pilots[tx])  # space
            b, ant, nt, nps = hp.shape
            hp_c = hp.reshape(b, ant, nt, self.num_chunks,
                              nps // self.num_chunks)
            wf = self._table(f"wf{tx}", dev)[idx]
            hf = torch.einsum("fp,batcp->batcf", wf, hp_c)  # frequency
            hf = hf.reshape(b, ant, nt, -1)  # [b, ant, n_dmrs, sc]
            outs.append(torch.einsum("st,batf->basf", wt, hf))  # time
        return torch.stack(outs, dim=2)

    def _call_exact(self, h_pilots: dict, no_pil) -> torch.Tensor:
        """Full-band s-f-t LMMSE with the weights solved at the actual
        noise level: W^T from A^T W^T = R_ao^T, A = R_oo + no_pil I
        (Hermitian PSD + no_pil I, so the LU solve is well posed)."""
        dev = h_pilots[0].device
        no_c = complex(no_pil)

        def solve_w(r_oo, r_ao):
            a = r_oo + no_c * torch.eye(r_oo.shape[0], dtype=r_oo.dtype,
                                        device=dev)
            return torch.linalg.solve_ex(a.T, r_ao.T)[0].T

        wt = solve_w(self._table("ct_oo", dev), self._table("ct_ao", dev))
        cs = self._table("cs", dev)
        ws = solve_w(cs, cs)  # [ant, ant]
        outs = []
        for tx in range(self.rg.num_tx):
            wf = solve_w(self._table(f"cf_oo{tx}", dev),
                         self._table(f"cf_ao{tx}", dev))  # [sc, P]
            hp = torch.einsum("ij,bjts->bits", ws, h_pilots[tx])
            hf = torch.einsum("fp,batp->batf", wf, hp)  # [b, ant, nd, sc]
            outs.append(torch.einsum("st,batf->basf", wt, hf))
        return torch.stack(outs, dim=2)  # [b, ant, tx, 14, sc]
