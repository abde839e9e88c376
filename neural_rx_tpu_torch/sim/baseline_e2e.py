"""Baseline end-to-end systems: classical receivers behind the transmitter
and channel of the eval model.

The port's counterpart of `neural_rx_tpu/sim/baseline_e2e.py`, eval only,
with the port's E2E shape: `draw` (from `EvalLink`), `forward` after the
draws, `__call__`. The system names route as the JAX package's:

  baseline_lslin_lmmse     LS + linear interpolation (slope-extrapolated,
                           Sionna's), LMMSE detection
  baseline_lsnn_lmmse      LS + nearest-neighbour interpolation, LMMSE
  baseline_lmmse_lmmse     LS at the pilots + covariance-based s-f-t LMMSE
                           interpolation, LMMSE detection
  baseline_lmmse_kbest     the same estimate, K-Best detection (K = 64;
                           exact max-log for <= 2 streams)
  baseline_perf_csi_lmmse  the true effective channel, LMMSE detection
  baseline_perf_csi_kbest  the true effective channel, K-Best detection

LMMSE detection is demapped with the max-log demapper. Each user's
transport block is decoded by the flooding decoder or, with fast_ldpc, by
the layered min-sum kernel (its plain version with kernels=False). Every
user is on the evaluated MCS (`mcs_arr_eval_idx`): its bits, transmitter,
noise variance, constellation and decode chain. As in the JAX package, the
baselines apply no carrier frequency offset.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import tables
from ..channel.apply import apply_ofdm_channel
from ..kernels.ldpc import tb_decode_fast
from ..phy.chest import LSChannelEstimator
from ..phy.constellation import qam_points
from ..phy.mapping import demap_maxlog
from ..phy.nr.tb import tb_decode
from ..rx.baselines import (LMMSEChannelInterpolator, kbest_detect,
                            lmmse_equalize)
from ..weights import WEIGHTS_DIR
from . import covariance
from .e2e import EvalLink, eval_order, refuse_unported

SYSTEMS = ("baseline_lslin_lmmse", "baseline_lsnn_lmmse",
           "baseline_lmmse_lmmse", "baseline_lmmse_kbest",
           "baseline_perf_csi_lmmse", "baseline_perf_csi_kbest")


def load_or_compute_covariances(p, cov_dir: str, device) -> dict:
    """{"freq", "time", "space"} covariances of `p`'s eval channel from
    cov_dir/{label}_{name}_cov_mat.npy; if any is missing, all three are
    estimated on `device` (`sim.covariance`, COV_SEED) and saved there."""
    paths = {name: os.path.join(cov_dir, f"{p.label}_{name}_cov_mat.npy")
             for name in ("freq", "time", "space")}
    if all(os.path.exists(path) for path in paths.values()):
        return {name: np.load(path) for name, path in paths.items()}
    gen = torch.Generator(device=device).manual_seed(covariance.COV_SEED)
    covs = dict(zip(("freq", "time", "space"),
                    covariance.compute_cov_matrices(p, generator=gen)))
    os.makedirs(cov_dir, exist_ok=True)
    for name, path in paths.items():
        np.save(path, covs[name])
    return covs


class BaselineE2EModel(EvalLink):
    """TX -> channel -> classical RX of one `sim.config.Parameters`, eval
    only. cov_dir: where the LMMSE estimate's covariances are read, or
    computed and written when missing (default: the repository's
    weights/). kernels=False: the layered decoder takes its plain
    version."""

    def __init__(self, sys_parameters, system: str,
                 cov_dir: str | None = None, kernels: bool = True,
                 device="cuda", mesh=None):
        if system not in SYSTEMS:
            raise ValueError(f"unknown baseline system {system!r}; one of "
                             f"{', '.join(SYSTEMS)}")
        refuse_unported(sys_parameters, mesh=mesh, baseline=True)
        super().__init__(sys_parameters, device)
        self.system = system
        parts = system.split("_")
        # baseline_<chest>_<det>, with perf_csi as two tokens
        self.chest_type, self.det_type = (
            ("perf", parts[3]) if parts[1] == "perf" else parts[1:3])
        self.kernels = kernels
        p = self.p
        rg = self.transmitter.resource_grid
        self.rg = rg
        self.w = self.transmitter.w  # [T, ports, 1] precoders
        if self.chest_type in ("lslin", "lsnn"):
            self.ls = LSChannelEstimator(
                rg, "lin_extrap" if self.chest_type == "lslin" else "nn")
        elif self.chest_type == "lmmse":
            self.ls = LSChannelEstimator(rg, "nn")  # the pilot-RE LS values
            covs = load_or_compute_covariances(
                p, cov_dir or WEIGHTS_DIR, self.device)
            self.interp = LMMSEChannelInterpolator(
                rg, covs["freq"], covs["time"], covs["space"],
                lmmse_num_prbs=p.lmmse_num_prbs)
            # per TX: positions of its nonzero pilots among the pilot REs
            # of one DMRS symbol
            mask = rg.pilot_mask
            sym_sc = np.where(mask[self.interp.dmrs_syms[0]])[0]
            self._n_pil_per_sym = len(sym_sc)
            self._pilot_sel = [
                np.searchsorted(sym_sc, self.interp._pilot_sc[tx])
                for tx in range(rg.num_tx)]

    # -- channel estimation ---------------------------------------------
    def estimate(self, y: torch.Tensor, h: torch.Tensor, no: float
                 ) -> torch.Tensor:
        """-> h_hat [b, ant, T, 14, sc]: the effective per-user channels."""
        if self.chest_type == "perf":
            w = tables.on_device(("precoders", self.w.tobytes()), h.device,
                                 lambda: self.w[..., 0])
            return torch.einsum("batpsc,tp->batsc", h, w)
        if self.chest_type in ("lslin", "lsnn"):
            return self.ls(y, no)[0]
        # LS at the nonzero pilot REs -> s-f-t interpolation
        b, ant = y.shape[:2]
        h_ls = self.ls.ls_at_pilots(y)  # [b, ant, T, n_pilots]
        n_ds = len(self.interp.dmrs_syms)
        h_pilots = {}
        for tx, sel in enumerate(self._pilot_sel):
            hp = h_ls[:, :, tx].reshape(b, ant, n_ds, self._n_pil_per_sym)
            h_pilots[tx] = hp[..., tables.on_device(
                ("pilot_sel", self.rg._key, tx), y.device, lambda s=sel: s)]
        return self.interp(h_pilots, no=no)

    def detect(self, y: torch.Tensor, h_hat: torch.Tensor, no: float,
               mcs_idx: int = 0) -> torch.Tensor:
        """Per-RE MIMO detection at MCS mcs_idx's constellation -> LLRs
        [b, 14, sc, T, m]."""
        hh = h_hat.permute(0, 3, 4, 1, 2)  # [b, 14, sc, ant, T]
        yy = y.permute(0, 2, 3, 1)  # [b, 14, sc, ant]
        m = self.transmitters[mcs_idx].num_bits_per_symbol
        if self.det_type == "kbest":
            return kbest_detect(yy, hh, no, m, k=64)
        x_hat, no_eff = lmmse_equalize(yy, hh, no)
        points = tables.on_device(("qam_points", m), y.device,
                                  lambda: qam_points(m))
        return demap_maxlog(x_hat, points, no_eff)

    def decode(self, llr: torch.Tensor, fast_ldpc: bool = False,
               mcs_idx: int = 0):
        """LLRs [b, 14, sc, T, m] -> (b_hat [b, T, tb_size], crc [b, T]):
        each user's data REs, transport block of MCS mcs_idx decoded by the
        flooding decoder or the layered min-sum kernel (one launch a
        user)."""
        llr = llr.permute(0, 3, 1, 2, 4)  # [b, T, 14, sc, m]
        llr_flat = self.rg.demap_data(llr).reshape(llr.shape[0],
                                                   llr.shape[1], -1)
        b_hats, crcs = [], []
        for ue, cfg in enumerate(self.transmitters[mcs_idx].configs):
            if fast_ldpc:
                bh, ok = tb_decode_fast(cfg.tb, llr_flat[:, ue],
                                        kernels=self.kernels)
            else:
                bh, ok = tb_decode(cfg.tb, llr_flat[:, ue])
            b_hats.append(bh)
            crcs.append(ok)
        return torch.stack(b_hats, 1), torch.stack(crcs, 1)

    def forward(self, params, bits: torch.Tensor, h: torch.Tensor,
                noise: torch.Tensor, no: float, fast_ldpc: bool = False,
                mcs_arr_eval_idx: int = 0):
        """Everything after the draws: transmit `bits` with the transmitter
        of MCS mcs_arr_eval_idx in the configured slot, y = sum h x +
        noise, `estimate`, `detect`, `decode`. no: the noise variance of
        `noise` (of the evaluated MCS). params is unused (the baselines
        have no weights). Returns (bits, b_hat [b, T, tb_size], crc [b,
        T])."""
        x = self.transmitters[mcs_arr_eval_idx](bits)
        y = apply_ofdm_channel(x, h, None, noise=noise)
        llr = self.detect(y, self.estimate(y, h, no), no, mcs_arr_eval_idx)
        return (bits,) + self.decode(llr, fast_ldpc, mcs_arr_eval_idx)

    def __call__(self, params, generator: torch.Generator, batch_size: int,
                 ebno_db: float, fast_ldpc: bool = False,
                 mcs_arr_eval_idx: int = 0):
        """One Monte-Carlo batch on MCS mcs_arr_eval_idx: `draw` from
        `generator` (on the model's device), then `forward` at that MCS's
        noise variance of `ebno_db`."""
        order = eval_order(mcs_arr_eval_idx, None, self.num_mcs)
        (bits,), h, noise = self.draw(generator, batch_size, ebno_db, order)
        return self.forward(params, bits, h, noise,
                            self.p.noise_variance(ebno_db, order[0]),
                            fast_ldpc=fast_ldpc, mcs_arr_eval_idx=order[0])
