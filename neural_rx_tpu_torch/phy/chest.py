"""LS channel estimation with nearest-neighbour or linear interpolation.

The port's counterpart of `neural_rx_tpu/phy/chest.py:LSChannelEstimator`:
the planar NN estimate (`estimate_planar`: gather-free for the serving
path's comb-2 pattern, `estimate_planar_dense`, else gather-based), the raw LS values
at the pilot REs (`ls_at_pilots`) and the complex estimate over the grid
with its error variance (`__call__`: "nn", "lin" or "lin_extrap"), as the
classical baselines use it. Index and weight tables are NumPy, built once
from the static resource grid; the estimates are torch ops on the device
of their input.

Semantics (as the JAX package):
- LS at pilot REs: h_ls = y / p where |p|>0, else 0;
- FOCC despreading: each pilot pair of a TX (consecutive nonzero pilots)
  is averaged, which halves the error variance no / |p|^2;
- NN interpolation: every RE takes the nearest (Manhattan distance,
  zero-energy pilots excluded, first-index tie-break) pilot estimate;
- "lin": linear in frequency on each DMRS symbol, then linear in time,
  flat past the edge pilots; "lin_extrap" (Sionna's LinearInterpolator)
  continues the slope of the edge pilot pair instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _linear_plan(x: np.ndarray, n: int, extrapolate: bool):
    """(left, right, w) over the targets 0..n-1 from the sorted sample
    positions x: target i is x[left] + w (x[right] - x[left]), clamped to
    the edge samples, or with `extrapolate` continued along the edge
    pair's slope."""
    xi = np.arange(n, dtype=np.float32)
    hi = max(len(x) - 2, 0) if extrapolate else len(x) - 1
    left = np.clip(np.searchsorted(x, xi, "right") - 1, 0, hi)
    right = np.clip(left + 1, 0, len(x) - 1)
    x0, x1 = x[left], x[right]
    w = np.where(x1 > x0, (xi - x0) / np.maximum(x1 - x0, 1), 0.)
    if not extrapolate:
        w = np.clip(w, 0.0, 1.0)
    return left, right, w.astype(np.float32)


class LSChannelEstimator:
    """LS estimator over a static ResourceGrid.

    Estimates the per-UE effective (post-precoding) channel, one value per
    (rx antenna, tx) per RE. interpolation_type: "nn", "lin" or
    "lin_extrap".
    """

    def __init__(self, resource_grid, interpolation_type: str = "nn"):
        rg = resource_grid
        self.rg = rg
        if interpolation_type not in ("nn", "lin", "lin_extrap"):
            raise ValueError(f"unknown interpolation {interpolation_type}")
        self.extrapolate = interpolation_type == "lin_extrap"
        self.interpolation_type = "lin" if self.extrapolate \
            else interpolation_type
        slot = rg.configs[0].carrier.slot_number

        mask = rg.pilot_mask  # [14, sc], the same for all tx
        # [n_pilots] row-major (symbol-major) flat pilot positions
        self._pilot_flat_ind = np.flatnonzero(mask.reshape(-1))
        self.pilot_bank = rg.pilots  # [num_slots, num_tx, n_pilots]
        self.pilots = rg.pilots[slot]  # default-slot values
        self._default_slot = slot

        # Safe reciprocal of pilots (0 where pilot is 0), full slot bank
        pb = self.pilot_bank
        self._pilot_inv_bank = np.where(
            np.abs(pb) > 0, 1.0 / np.where(np.abs(pb) > 0, pb, 1.0), 0.0
        ).astype(np.complex64)  # [num_slots, tx, n_pilots]
        p = self.pilots
        self._pilot_pow_inv = np.where(
            np.abs(p) > 0, 1.0 / np.maximum(np.abs(p) ** 2, 1e-12), 0.0
        ).astype(np.float32)  # |p| is slot-independent (QPSK * beta)

        # FOCC partner map: consecutive nonzero pilots of a TX form pairs
        partner = np.zeros((rg.num_tx, self.pilots.shape[-1]), np.int64)
        for tx in range(rg.num_tx):
            nz = np.where(np.abs(self.pilots[tx]) > 0)[0]
            part = np.arange(self.pilots.shape[-1], dtype=np.int64)
            part[nz[0::2]] = nz[1::2]
            part[nz[1::2]] = nz[0::2]
            partner[tx] = part
        self._focc_partner = partner

        self._dense_ok = self.interpolation_type == "nn" \
            and self._build_dense_nn()
        if self.interpolation_type == "lin":
            self._build_linear()
        self._tables = {}

    @functools.cached_property
    def _gather_ind(self) -> np.ndarray:
        """Per-TX NN gather indices [num_tx, 14, sc] -> pilot index, built
        at first use (the dense estimate does not need them).

        The pilot nearest in Manhattan distance, the first in pilot order
        on a tie. Pilots are ordered by symbol, then subcarrier, so that
        is: per DMRS symbol the nearest active subcarrier (the lower on a
        tie), then the DMRS symbol with the least total distance (the
        earlier on a tie)."""
        mask = self.rg.pilot_mask
        n_sym, n_sc = mask.shape
        i_p, j_p = np.where(mask)
        dsyms = np.asarray(sorted(set(i_p.tolist())), np.int64)
        sc = np.arange(n_sc)
        far = n_sym + n_sc  # beyond any distance on the grid
        d_t = np.abs(np.arange(n_sym)[:, None] - dsyms[None, :])
        gather = np.zeros((self.rg.num_tx, n_sym, n_sc), np.int64)
        for tx in range(self.rg.num_tx):
            act = np.abs(self.pilots[tx]) > 0
            if not act.any():
                continue  # every pilot equally far: the first
            dist = np.full((len(dsyms), n_sc), far, np.int64)
            near = np.zeros((len(dsyms), n_sc), np.int64)
            for k, s in enumerate(dsyms):
                idx = np.where((i_p == s) & act)[0]
                if len(idx) == 0:
                    continue
                pos = j_p[idx]  # ascending
                r = np.searchsorted(pos, sc)
                lo = np.clip(r - 1, 0, len(idx) - 1)
                hi = np.clip(r, 0, len(idx) - 1)
                d_lo, d_hi = np.abs(sc - pos[lo]), np.abs(pos[hi] - sc)
                right = d_hi < d_lo
                dist[k] = np.where(right, d_hi, d_lo)
                near[k] = idx[np.where(right, hi, lo)]
            k_best = np.argmin(dist[None] + d_t[:, :, None], axis=1)
            gather[tx] = near[k_best, sc[None, :]]
        return gather

    def _build_dense_nn(self) -> bool:
        """Precompute the tables of `estimate_planar_dense`; False when the
        pilot pattern does not factorize.

        Valid when, per TX, the active pilots form a uniform comb-2 pattern
        identical on every DMRS symbol (38.211 type-1 DMRS). Then the
        Manhattan-NN map factorizes into (nearest DMRS symbol in time) x
        (nearest active subcarrier in frequency): for comb offset d an
        off-comb subcarrier s takes the value at s-1 (first-index
        tie-break), except s=0 for d=1, which takes s+1.
        """
        rg = self.rg
        mask = rg.pilot_mask
        n_sym, n_sc = mask.shape
        i_p, j_p = np.where(mask)
        dsyms = np.asarray(sorted(set(i_p.tolist())), np.int64)
        nds = len(dsyms)
        n_tx = rg.num_tx
        combs = np.zeros(n_tx, np.int64)
        for tx in range(n_tx):
            act = np.abs(self.pilots[tx]) > 0
            sc_per_sym = [np.sort(j_p[(i_p == s) & act]) for s in dsyms]
            sc0 = sc_per_sym[0]
            if any(len(s) != len(sc0) or (s != sc0).any()
                   for s in sc_per_sym[1:]):
                return False
            if len(sc0) < 2:
                return False
            d = int(sc0[0])
            if d not in (0, 1) or (np.diff(sc0) != 2).any() \
                    or len(sc0) != n_sc // 2 or (n_sc % 4) != 0:
                return False
            combs[tx] = d
        # the FOCC partner map must be the (4n+d, 4n+2+d) pairing
        for tx in range(n_tx):
            act = np.abs(self.pilots[tx]) > 0
            part = self._focc_partner[tx]
            for k in np.where(act)[0]:
                sc_k, sc_p = j_p[k], j_p[part[k]]
                if i_p[k] != i_p[part[k]]:
                    return False
                g = (sc_k - combs[tx]) // 2
                want = sc_k + 2 if g % 2 == 0 else sc_k - 2
                if sc_p != want:
                    return False
        # nearest DMRS symbol per output symbol (first-index tie-break)
        dist = np.abs(np.arange(n_sym)[:, None] - dsyms[None, :])
        self._dense_sym_sel = np.argmin(dist, axis=1).astype(np.int64)
        self._dense_dsyms = dsyms
        self._dense_combs = combs
        # dense per-slot inverse-pilot grids [num_slots, tx, nds, sc]
        pb_inv = self._pilot_inv_bank
        sym_pos = {int(s): k for k, s in enumerate(dsyms)}
        dense = np.zeros((pb_inv.shape[0], n_tx, nds, n_sc), np.complex64)
        dense[:, :, [sym_pos[int(s)] for s in i_p], j_p] = pb_inv
        self._dense_inv_r = np.ascontiguousarray(dense.real)
        self._dense_inv_i = np.ascontiguousarray(dense.imag)
        sc = np.arange(n_sc)
        self._dense_oncomb = np.stack(
            [(sc % 2) == combs[tx] for tx in range(n_tx)])  # [tx, sc]
        self._dense_geven = np.stack(
            [((sc - combs[tx]) // 2) % 2 == 0 for tx in range(n_tx)])
        # per-tx source subcarrier for s=0 (1 for comb d=1, else itself)
        self._dense_first_src = np.asarray(
            [1 if int(d) == 1 else 0 for d in combs], np.int64)
        return True

    def _build_linear(self):
        """Index and weight tables of the linear interpolation: per TX and
        DMRS symbol the left and right active pilot of every subcarrier
        and its weight ([tx, nds, sc]), then per symbol the left and right
        DMRS symbol and its weight ([14])."""
        mask = self.rg.pilot_mask
        n_sym, n_sc = mask.shape
        i_p, j_p = np.where(mask)
        dmrs_syms = sorted(set(i_p.tolist()))
        shape = (self.rg.num_tx, len(dmrs_syms), n_sc)
        left, right = np.zeros(shape, np.int64), np.zeros(shape, np.int64)
        w = np.zeros(shape, np.float32)
        for tx in range(self.rg.num_tx):
            nz = np.abs(self.pilots[tx]) > 0
            for k, s in enumerate(dmrs_syms):
                idx = np.where((i_p == s) & nz)[0]
                lo, hi, w[tx, k] = _linear_plan(j_p[idx], n_sc,
                                                self.extrapolate)
                left[tx, k], right[tx, k] = idx[lo], idx[hi]
        t = np.asarray(dmrs_syms, np.float32)
        lt, rt, wt = _linear_plan(t, n_sym,
                                  self.extrapolate and len(t) > 1)
        self._lin = dict(left=left, right=right, w=w, lt=lt, rt=rt, wt=wt)

    def _device_tables(self, device, gather: bool = False):
        """The tables as tensors on `device`, made once per device; with
        gather, also the NN gather map."""
        key = str(device)
        if key not in self._tables:
            t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
            tb = dict(
                pilot_ind=t(self._pilot_flat_ind),
                inv_bank=t(self._pilot_inv_bank),
                inv_r=t(np.ascontiguousarray(self._pilot_inv_bank.real)),
                inv_i=t(np.ascontiguousarray(self._pilot_inv_bank.imag)),
                pow_inv=t(self._pilot_pow_inv), partner=t(self._focc_partner),
                flat_partner=t((np.arange(self.rg.num_tx)[:, None]
                                * self._focc_partner.shape[1]
                                + self._focc_partner).ravel()),
                tx_idx=t(np.arange(self.rg.num_tx)))
            if self._dense_ok:
                tb.update(
                    dsyms=t(self._dense_dsyms),
                    dense_inv_r=t(self._dense_inv_r),
                    dense_inv_i=t(self._dense_inv_i),
                    geven=t(self._dense_geven), oncomb=t(self._dense_oncomb),
                    sym_sel=t(self._dense_sym_sel),
                    first_src=t(self._dense_first_src))
            if self.interpolation_type == "lin":
                tb.update({f"lin_{k}": t(v) for k, v in self._lin.items()})
            self._tables[key] = tb
        tb = self._tables[key]
        if gather and "gather" not in tb:
            tb["gather"] = torch.as_tensor(self._gather_ind, device=device)
        return tb

    def estimate_planar_dense(self, y_planar: torch.Tensor, slot_idx=None,
                              out_dtype=None) -> torch.Tensor:
        """Gather-free NN LS estimate.

        y_planar [b, ant, 14, sc, 2] float32 (re/im last) ->
        h_in [b, tx, 14, sc, 2*ant] with channel order [re a0.., im a0..],
        in float32, or rounded to `out_dtype` after the FOCC average (the
        JAX package's rounding point). Only for a uniform comb-2 pilot
        pattern (`_build_dense_nn`); `estimate_planar` takes any.
        """
        if not self._dense_ok:
            raise NotImplementedError(
                "the pilot pattern is not a uniform comb-2 type-1 DMRS with "
                "FOCC pairs; use estimate_planar")
        tb = self._device_tables(y_planar.device)
        b, ant = y_planar.shape[0], y_planar.shape[1]
        n_sym, n_sc = self.rg.pilot_mask.shape
        n_tx = self.rg.num_tx
        # DMRS symbols only: [b, ant, nds, sc]
        yr = y_planar[..., 0].index_select(2, tb["dsyms"])
        yi = y_planar[..., 1].index_select(2, tb["dsyms"])
        slot = self._default_slot if slot_idx is None else slot_idx
        invr, invi = tb["dense_inv_r"][slot], tb["dense_inv_i"][slot]
        # [b, ant, tx, nds, sc] planar complex multiply
        yr, yi = yr[:, :, None], yi[:, :, None]
        hr = yr * invr - yi * invi
        hi = yr * invi + yi * invr
        ge = tb["geven"][None, None, :, None, :]
        hr = 0.5 * (hr + torch.where(ge, torch.roll(hr, -2, -1),
                                     torch.roll(hr, 2, -1)))
        hi = 0.5 * (hi + torch.where(ge, torch.roll(hi, -2, -1),
                                     torch.roll(hi, 2, -1)))
        if out_dtype is not None:
            hr = hr.to(out_dtype)
            hi = hi.to(out_dtype)
        # frequency NN: off-comb sc takes the value one lane to the left
        oc = tb["oncomb"][None, None, :, None, :]
        hr = torch.where(oc, hr, torch.roll(hr, 1, -1))
        hi = torch.where(oc, hi, torch.roll(hi, 1, -1))
        if (self._dense_combs == 1).any():
            # d=1: s=0 has no left pilot; its NN is s=1
            src = tb["first_src"][None, None, :, None, None].expand(
                b, ant, n_tx, hr.shape[3], 1)
            hr = torch.cat([hr.gather(-1, src), hr[..., 1:]], dim=-1)
            hi = torch.cat([hi.gather(-1, src), hi[..., 1:]], dim=-1)
        # time NN: expand the DMRS rows to all 14 symbols
        hr = hr.index_select(3, tb["sym_sel"])  # [b, ant, tx, 14, sc]
        hi = hi.index_select(3, tb["sym_sel"])
        h = torch.stack([hr, hi], dim=1)  # [b, 2, ant, tx, 14, sc]
        h = h.permute(0, 3, 4, 5, 1, 2)  # [b, tx, 14, sc, 2, ant]
        return h.reshape(b, n_tx, n_sym, n_sc, 2 * ant)

    def estimate_planar(self, y_planar: torch.Tensor, slot_idx=None,
                        out_dtype=None) -> torch.Tensor:
        """NN LS estimate for any pilot pattern, with the contract of
        `estimate_planar_dense`: that gather-free form where the pattern
        allows it, else the gather-based `_estimate_planar_gather` (the
        same values on a comb-2 pattern). nn interpolation only."""
        if self.interpolation_type != "nn":
            raise ValueError("estimate_planar interpolates nn only")
        estimate = self.estimate_planar_dense if self._dense_ok \
            else self._estimate_planar_gather
        return estimate(y_planar, slot_idx=slot_idx, out_dtype=out_dtype)

    def _estimate_planar_gather(self, y_planar: torch.Tensor, slot_idx=None,
                                out_dtype=None) -> torch.Tensor:
        """Gather-based NN LS estimate, for any pilot pattern."""
        tb = self._device_tables(y_planar.device, gather=True)
        b, ant = y_planar.shape[0], y_planar.shape[1]
        n_tx = self.rg.num_tx
        n_sym, n_sc = self.rg.pilot_mask.shape
        # LS at pilots, planar complex multiply: [b, ant, tx, npil]
        y_p = y_planar.reshape(b, ant, n_sym * n_sc, 2)[:, :, tb["pilot_ind"]]
        slot = self._default_slot if slot_idx is None else slot_idx
        invr, invi = tb["inv_r"][slot], tb["inv_i"][slot]
        npil = y_p.shape[2]
        yr, yi = y_p[..., None, :, 0], y_p[..., None, :, 1]
        h_pil = torch.stack([yr * invr - yi * invi, yr * invi + yi * invr],
                            dim=-1)  # [b, ant, tx, npil, 2]
        h2 = h_pil.reshape(b, ant, n_tx * npil, 2)
        h_part = h2[:, :, tb["flat_partner"]].reshape(h_pil.shape)
        h_pil = 0.5 * (h_pil + h_part)
        if out_dtype is not None:
            h_pil = h_pil.to(out_dtype)
        # channels-last, then one sc-trailing gather per TX over the grid
        h_pil = h_pil.movedim(1, -1).reshape(b, n_tx, npil, 2 * ant)
        h_pil = h_pil.movedim(2, -1)  # [b, tx, 2ant, npil]
        gi = tb["gather"].reshape(n_tx, -1)
        h_grid = torch.stack([h_pil[:, t][..., gi[t]] for t in range(n_tx)],
                             dim=1)  # [b, tx, 2ant, 14*sc]
        return h_grid.movedim(2, -1).reshape(b, n_tx, n_sym, n_sc, 2 * ant)

    def ls_at_pilots(self, y: torch.Tensor) -> torch.Tensor:
        """Raw LS estimates at the pilot REs of the configured slot: y [b,
        ant, 14, sc] complex -> h_ls [b, ant, num_tx, n_pilots] (zeros on
        other-comb REs)."""
        tb = self._device_tables(y.device)
        b, n_ant = y.shape[0], y.shape[1]
        y_p = y.reshape(b, n_ant, -1)[..., tb["pilot_ind"]]
        return y_p[:, :, None, :] * tb["inv_bank"][self._default_slot][
            None, None]

    def __call__(self, y: torch.Tensor, no
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """y: [batch, num_rx_ant, 14, sc] complex, no: the noise variance (a
        number) -> (h_hat, err_var).

        h_hat: [batch, num_rx_ant, num_tx, 14, sc] complex, the per-UE
        effective channel over the full grid; err_var: the same shape,
        float32.
        """
        tb = self._device_tables(y.device, gather=True)
        b, n_ant = y.shape[0], y.shape[1]
        h_ls = self.ls_at_pilots(y)  # [b, ant, tx, n_pilots]
        ev = torch.full((b, n_ant, 1, 1), no, dtype=torch.float32,
                        device=y.device) * tb["pow_inv"]
        txi = tb["tx_idx"]
        h_ls = 0.5 * (h_ls + h_ls[:, :, txi[:, None], tb["partner"]])
        ev = 0.5 * ev  # averaging halves the estimation noise
        gi = tb["gather"]  # [tx, 14, sc]
        err_var = ev[:, :, txi[:, None, None], gi]
        if self.interpolation_type == "nn":
            return h_ls[:, :, txi[:, None, None], gi], err_var
        return self._interpolate_linear(h_ls, tb), err_var

    def _interpolate_linear(self, h_ls, tb):
        """Linear interpolation in frequency on each DMRS symbol, then in
        time: h_ls [b, ant, tx, n_pilots] -> [b, ant, tx, 14, sc]."""
        txi = tb["tx_idx"][:, None, None]
        h0 = h_ls[:, :, txi, tb["lin_left"]]  # [b, ant, tx, nds, sc]
        h1 = h_ls[:, :, txi, tb["lin_right"]]
        hs = h0 + (h1 - h0) * tb["lin_w"]
        h0 = hs[:, :, :, tb["lin_lt"]]  # [b, ant, tx, 14, sc]
        h1 = hs[:, :, :, tb["lin_rt"]]
        return h0 + (h1 - h0) * tb["lin_wt"][:, None]
