"""LS channel estimation with nearest-neighbour interpolation (dense form).

The port's counterpart of `neural_rx_tpu/phy/chest.py:LSChannelEstimator`
for the serving path: `estimate_planar_dense`, the gather-free NN estimate.
Tables are NumPy, built once from the static resource grid; the estimate
itself is a few elementwise torch ops on the device of its input.

Semantics (as the JAX package):
- LS at pilot REs: h_ls = y / p where |p|>0, else 0;
- FOCC despreading: each (4n+d, 4n+2+d) pilot pair is averaged;
- NN interpolation: every RE takes the nearest (Manhattan distance,
  zero-energy pilots excluded, first-index tie-break) pilot estimate.
"""

from __future__ import annotations

import numpy as np
import torch


class LSChannelEstimator:
    """LS estimator over a static ResourceGrid: "nn" interpolation with FOCC
    removal, the dense form only.

    Estimates the per-UE effective (post-precoding) channel, one value per
    (rx antenna, tx) per RE.
    """

    def __init__(self, resource_grid):
        rg = resource_grid
        self.rg = rg
        slot = rg.configs[0].carrier.slot_number
        self.pilot_bank = rg.pilots  # [num_slots, num_tx, n_pilots]
        self.pilots = rg.pilots[slot]  # default-slot values
        self._default_slot = slot

        # Safe reciprocal of pilots (0 where pilot is 0), full slot bank
        pb = self.pilot_bank
        self._pilot_inv_bank = np.where(
            np.abs(pb) > 0, 1.0 / np.where(np.abs(pb) > 0, pb, 1.0), 0.0
        ).astype(np.complex64)  # [num_slots, tx, n_pilots]

        # FOCC partner map: consecutive nonzero pilots of a TX form pairs
        partner = np.zeros((rg.num_tx, self.pilots.shape[-1]), np.int32)
        for tx in range(rg.num_tx):
            nz = np.where(np.abs(self.pilots[tx]) > 0)[0]
            part = np.arange(self.pilots.shape[-1], dtype=np.int32)
            part[nz[0::2]] = nz[1::2]
            part[nz[1::2]] = nz[0::2]
            partner[tx] = part
        self._focc_partner = partner

        if not self._build_dense_nn():
            raise NotImplementedError(
                "pilot pattern is not a uniform comb-2 type-1 DMRS; the "
                "gather-based estimate is not ported")
        self._tables = {}

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

    def _device_tables(self, device):
        """The dense tables as tensors on `device`, made once per device."""
        key = str(device)
        if key not in self._tables:
            t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
            self._tables[key] = dict(
                dsyms=t(self._dense_dsyms), inv_r=t(self._dense_inv_r),
                inv_i=t(self._dense_inv_i), geven=t(self._dense_geven),
                oncomb=t(self._dense_oncomb), sym_sel=t(self._dense_sym_sel),
                first_src=t(self._dense_first_src))
        return self._tables[key]

    def estimate_planar_dense(self, y_planar: torch.Tensor, slot_idx=None,
                              out_dtype=None) -> torch.Tensor:
        """Gather-free NN LS estimate.

        y_planar [b, ant, 14, sc, 2] float32 (re/im last) ->
        h_in [b, tx, 14, sc, 2*ant] with channel order [re a0.., im a0..],
        in float32, or rounded to `out_dtype` after the FOCC average (the
        JAX package's rounding point).
        """
        tb = self._device_tables(y_planar.device)
        b, ant = y_planar.shape[0], y_planar.shape[1]
        n_sym, n_sc = self.rg.pilot_mask.shape
        n_tx = self.rg.num_tx
        # DMRS symbols only: [b, ant, nds, sc]
        yr = y_planar[..., 0].index_select(2, tb["dsyms"])
        yi = y_planar[..., 1].index_select(2, tb["dsyms"])
        slot = self._default_slot if slot_idx is None else slot_idx
        invr, invi = tb["inv_r"][slot], tb["inv_i"][slot]
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
