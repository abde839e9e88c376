"""Aerial-compatible real-time receiver: the deployable engine.

The port's counterpart of `neural_rx_tpu/deploy/aerial.py:AerialNRX` (the
reference's `NeuralReceiverONNX` + `NRPreprocessing`): FOCC removal of the
pilot estimates, the PRB-local nearest-neighbour gather onto the grid, the
positional encoding, the CGNN and both readouts. TB/LDPC decoding stays
outside, as in the reference's TensorRT scope.

I/O contract (Aerial axis order):
inputs
  rx_slot_real / rx_slot_imag : [b, num_subcarriers, num_symbols, ant]
  h_hat_real / h_hat_imag     : [b, num_pilots, num_layers, ant] LS
                                estimates at each layer's nonzero pilot
                                REs, (sym, sc) order, FOCC not removed
  dmrs_port_mask              : [b, num_layers] active ports
outputs
  llr   : [b, num_layers, num_subcarriers, num_symbols, num_bits],
          SIGN-FLIPPED (-log(p1/p0)), the Aerial convention
  h_hat : [b, num_layers, num_subcarriers, num_symbols, 2*num_rx_ant], the
          CGNN's channel readout

The static tables come from NumPy as the JAX package builds them
(`engine_tables`); an engine holds them on its device and needs no
resource grid, so an engine file rebuilds it (`deploy/aot.py`). The CGNN
runs the route of the `CGNNConfig` it is given, in the engine's dtype,
through the port's kernels on a CUDA device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..rx.cgnn import CGNNConfig, cgnn_apply, pilot_positional_encoding
from ..rx.neural_rx import resolve_device

TABLE_NAMES = ("pe", "nn_gather", "focc_pair", "pilot_sc", "uniq_pilot_sc",
               "freq_dist", "pilot_mask")


def nn_gather_map(ip: np.ndarray, jp: np.ndarray, n_sym: int, n_sc: int
                  ) -> np.ndarray:
    """[n_sym, n_sc] int32: for each RE the index of the pilot (ip[k],
    jp[k]) nearest in |d sym| + |d sc|, the first in (sym, sc) order on a
    tie: the JAX package's argmin over an [n_sym, n_sc, pilots] distance
    array, one symbol at a time (that array takes ~1.2 GB a layer at 273
    PRB)."""
    sc_d = np.abs(np.arange(n_sc, dtype=np.int32)[:, None]
                  - jp.astype(np.int32)[None, :])  # [sc, pilots]
    out = np.empty((n_sym, n_sc), np.int32)
    for sym in range(n_sym):
        d = sc_d + np.abs(sym - ip.astype(np.int32))[None, :]
        out[sym] = np.argmin(d, axis=-1)
    return out


def engine_tables(resource_grid) -> dict:
    """The engine's static tables (NumPy), as the JAX package's AerialNRX
    builds them: "pe" [T, sym, sc, 2]; "nn_gather" [T, sym, sc] int32;
    "focc_pair" and "pilot_sc" [T, pilots] int32; "uniq_pilot_sc" [T, U]
    int32; "freq_dist" [T, sc, U] int16; "pilot_mask" [sym, sc] bool;
    "pad_dispatch_exact" (no valid RE gathers a pilot from a later PRB, so
    a bucket-padded run crops to the direct run's LLRs)."""
    rg = resource_grid
    slot = rg.configs[0].carrier.slot_number
    n_sym, n_sc = rg.pilot_mask.shape
    cols = {name: [] for name in TABLE_NAMES[1:-1]}
    pad_exact = True
    for tx in range(rg.num_tx):
        ip, jp = np.where(np.abs(rg.dmrs_grids[slot, tx]) > 1e-3)
        gather = nn_gather_map(ip, jp, n_sym, n_sc)
        uniq = np.unique(jp)
        cols["nn_gather"].append(gather)
        # FOCC pairs: adjacent pilot REs of a CDM pair
        cols["focc_pair"].append((np.arange(len(ip)) // 2).astype(np.int32))
        cols["pilot_sc"].append(jp.astype(np.int32))
        cols["uniq_pilot_sc"].append(uniq.astype(np.int32))
        cols["freq_dist"].append(np.abs(
            np.arange(n_sc)[:, None] - uniq[None, :]).astype(np.int16))
        # valid boundaries are PRB multiples: exact iff no RE gathers a
        # pilot subcarrier from a later PRB (type-1 comb DMRS)
        pad_exact &= bool(np.all(jp[gather] // 12
                                 <= np.arange(n_sc)[None, :] // 12))
    if len({len(u) for u in cols["uniq_pilot_sc"]}) != 1:
        raise ValueError("the layers' unique pilot subcarrier counts differ")
    tables = {k: np.stack(v) for k, v in cols.items()}
    tables["pe"] = pilot_positional_encoding(rg.dmrs_grids[slot],
                                             rg.pilot_mask)
    tables["pilot_mask"] = rg.pilot_mask
    tables["pad_dispatch_exact"] = pad_exact
    return tables


def dynamic_pe(pe: torch.Tensor, uniq_pilot_sc: torch.Tensor,
               freq_dist: torch.Tensor, num_valid_sc: int) -> torch.Tensor:
    """The positional encoding [T, sym, sc, 2] of a bucket grid whose
    subcarriers from num_valid_sc on are padding: frequency distances to
    the pilots inside the valid region only, z-scored over the valid
    subcarriers, zero on the padding; the time channel (column-local) is
    the static one, zeroed on the padding. The JAX package's
    `AerialNRX._dynamic_pe`."""
    nv = num_valid_sc
    msc = torch.arange(freq_dist.shape[1], device=pe.device) < nv
    far = torch.full((), 32767, dtype=freq_dist.dtype, device=pe.device)
    # the valid columns alone, so that every width reduces alike
    dist = torch.where(uniq_pilot_sc[:, None, :] < nv, freq_dist[:, :nv],
                       far).amin(-1).float()  # [T, nv]
    mean = dist.sum(-1, keepdim=True) / float(nv)
    std = torch.sqrt(((dist - mean) ** 2).sum(-1, keepdim=True) / float(nv))
    pe_f = dist.new_zeros((pe.shape[0], msc.shape[0]))
    pe_f[:, :nv] = torch.where(std > 0, (dist - mean)
                               / torch.where(std > 0, std, 1.0), 0.0)
    pe_t = pe[..., 0] * msc
    return torch.stack([pe_t, pe_f[:, None].expand(pe_t.shape)], dim=-1)


class AerialNRX:
    """Aerial-ABI engine of one grid width: static tables on `device`, the
    CGNN configuration (its route flags included), the evaluated MCS, the
    iteration count and the dtype."""

    def __init__(self, tables: dict, cgnn_cfg: CGNNConfig,
                 num_it: int | None = None, dtype=torch.bfloat16,
                 mcs_idx: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cgnn_cfg
        self.num_it = num_it
        self.dtype = dtype
        self.mcs_idx = mcs_idx
        self.pad_dispatch_exact = bool(tables["pad_dispatch_exact"])
        t = {k: torch.as_tensor(np.asarray(tables[k]), device=self.device)
             for k in TABLE_NAMES}
        self.tables = t
        self.num_layers, self.num_pilots = t["pilot_sc"].shape
        self.n_sc = t["freq_dist"].shape[1]
        # numpy copies for the dispatcher's host-side index work
        self.pilot_sc = np.asarray(tables["pilot_sc"])
        if self.num_pilots % 2 or not (np.asarray(tables["focc_pair"])
                                       == np.arange(self.num_pilots) // 2
                                       ).all():
            raise ValueError("FOCC pairs must be adjacent pilots (k // 2)")
        self._pe = {}

    @classmethod
    def from_grid(cls, resource_grid, cgnn_cfg: CGNNConfig, **kwargs):
        """The engine of a resource grid's width (`engine_tables`)."""
        return cls(engine_tables(resource_grid), cgnn_cfg, **kwargs)

    def numpy_tables(self) -> dict:
        """The static tables as NumPy arrays, with "pad_dispatch_exact"."""
        out = {k: v.cpu().numpy() for k, v in self.tables.items()}
        out["pad_dispatch_exact"] = self.pad_dispatch_exact
        return out

    def positional_encoding(self, num_valid_sc: int | None) -> torch.Tensor:
        """The static encoding (None), or `dynamic_pe` at a valid width,
        computed once per width."""
        if num_valid_sc is None:
            return self.tables["pe"]
        if num_valid_sc not in self._pe:
            t = self.tables
            self._pe[num_valid_sc] = dynamic_pe(
                t["pe"], t["uniq_pilot_sc"], t["freq_dist"], num_valid_sc)
        return self._pe[num_valid_sc]

    def __call__(self, params, rx_slot_real, rx_slot_imag, h_hat_real,
                 h_hat_imag, dmrs_port_mask, num_valid_sc: int | None = None):
        """(llr, h_hat) in the Aerial layout, float32; num_valid_sc: the
        count of valid leading subcarriers of a bucket-padded slot (the
        power norm, the encoding and every conv layer then see only
        those)."""
        b, t = rx_slot_real.shape[0], self.num_layers
        # Aerial [b, sc, sym, ant] -> internal [b, sym, sc, 2*ant]
        y_in = torch.cat([rx_slot_real.transpose(1, 2),
                          rx_slot_imag.transpose(1, 2)], dim=-1)

        def focc(h):  # [b, pilots, T, ant]: mean of each CDM pair
            pairs = h.reshape(b, self.num_pilots // 2, 2, t, h.shape[-1])
            return (pairs.sum(dim=2) / 2.0).repeat_interleave(2, dim=1)

        # nearest-neighbour gather per layer: [b, T, sym, sc, ant]
        gi = self.tables["nn_gather"]
        tx_idx = torch.arange(t, device=gi.device)[:, None, None]
        h_in = torch.cat([focc(h).transpose(1, 2)[:, tx_idx, gi]
                          for h in (h_hat_real, h_hat_imag)], dim=-1)
        mcs_mask = torch.zeros((b, t, self.cfg.num_mcs),
                               device=rx_slot_real.device)
        mcs_mask[..., self.mcs_idx] = 1.0
        llrs, h_hats = cgnn_apply(
            params["cgnn"], self.cfg, y_in,
            self.positional_encoding(num_valid_sc), h_in,
            dmrs_port_mask.float(), mcs_mask, num_it=self.num_it,
            dtype=self.dtype, sc_valid=num_valid_sc)
        llr = llrs[-1][self.mcs_idx]  # [b, T, sym, sc, bits]
        return (-llr.transpose(2, 3), h_hats[-1].transpose(2, 3))

    def config(self) -> dict:
        """What rebuilds the engine besides its tables (`deploy/aot.py`
        writes it into an engine file)."""
        return {"cgnn_cfg": dataclasses.asdict(self.cfg),
                "num_it": self.num_it, "mcs_idx": self.mcs_idx,
                "dtype": str(self.dtype).removeprefix("torch.")}
