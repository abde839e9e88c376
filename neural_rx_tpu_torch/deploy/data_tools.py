"""Aerial-layout test vectors and the evaluation of engine outputs.

The port's counterpart of `neural_rx_tpu/deploy/data_tools.py` (the
reference's ONNX/Aerial data tooling): `AerialDataGenerator` makes engine
inputs in the Aerial layout, with their labels, from the E2E model's
transmitter, channel and noise; `AerialDataEvaluator` turns the engine's
sign-flipped LLRs into a coded BER and each user's transport-block CRC
(the flooding decoder, as the JAX package's); `export_static_indices`
writes an engine's static index tables to `.npz`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..channel.apply import apply_ofdm_channel
from ..phy.nr.tb import tb_decode


class AerialDataGenerator:
    """Aerial-layout engine inputs from an eval `sim.e2e.E2EModel` (one
    MCS, all users active; its receiver computes the LS estimate)."""

    def __init__(self, e2e_model):
        self.model = e2e_model
        rg = e2e_model.transmitter.resource_grid
        slot = rg.configs[0].carrier.slot_number
        mask_flat = np.flatnonzero(rg.pilot_mask.reshape(-1))
        # each layer's nonzero pilots among the LS estimate's pilot REs
        self.pilot_sel = [
            np.flatnonzero(np.abs(rg.dmrs_grids[slot, t].reshape(-1)[
                mask_flat]) > 1e-3) for t in range(rg.num_tx)]

    def __call__(self, generator: torch.Generator, batch_size: int,
                 ebno_db: float):
        """`forward` of the model's draws (bits, channel, noise) from
        `generator`."""
        (bits,), h, noise = self.model.draw(generator, batch_size, ebno_db)
        return self.forward(bits, h, noise)

    def forward(self, bits: torch.Tensor, h: torch.Tensor,
                noise: torch.Tensor):
        """(inputs, labels) of one slot: bits [b, T, tb_size] through the
        transmitter, the channel h and the noise; inputs = (rx_slot_real,
        rx_slot_imag [b, sc, sym, ant], h_hat_real, h_hat_imag [b, pilots,
        T, ant] (the LS estimates at each layer's nonzero pilots),
        dmrs_port_mask [b, T] ones); labels = {"bits", "coded_bits"}."""
        tx = self.model.transmitter
        coded = tx.encode(bits)
        y = apply_ofdm_channel(tx.modulate(coded), h, None, noise=noise)
        h_ls = self.model.receiver._ls.ls_at_pilots(y)  # [b, ant, T, P]
        h_sel = torch.stack([h_ls[:, :, t, torch.as_tensor(sel,
                                                          device=y.device)]
                             for t, sel in enumerate(self.pilot_sel)], dim=2)
        h_sel = h_sel.permute(0, 3, 2, 1)  # [b, pilots, T, ant]
        y_pl = y.permute(0, 3, 2, 1)  # [b, sc, sym, ant]
        inputs = tuple(x.contiguous() for x in (
            y_pl.real, y_pl.imag, h_sel.real, h_sel.imag,
            torch.ones((bits.shape[0], bits.shape[1]), device=y.device)))
        return inputs, {"bits": bits, "coded_bits": coded}


class AerialDataEvaluator:
    """Engine LLRs -> coded BER and TB-CRC pass rate."""

    def __init__(self, e2e_model):
        self.model = e2e_model
        self.rg = e2e_model.transmitter.resource_grid

    def __call__(self, llr_aerial: torch.Tensor, labels: dict,
                 mcs_idx: int = 0) -> dict:
        """llr_aerial [b, T, sc, sym, bits], sign-flipped -> {"coded_ber",
        "crc_pass_rate"} (floats), each user decoded with the flooding
        decoder."""
        llr = -llr_aerial.transpose(2, 3)
        b, t = llr.shape[:2]
        llr_flat = self.rg.demap_data(llr).reshape(b, t, -1)
        ber = ((llr_flat > 0) != (labels["coded_bits"] > 0.5)).float().mean()
        tx = self.model.transmitters[mcs_idx]
        crcs = [tb_decode(tx.configs[ue].tb, llr_flat[:, ue])[1]
                for ue in range(t)]
        return {"coded_ber": float(ber),
                "crc_pass_rate": float(torch.stack(crcs).float().mean())}


def export_static_indices(engine, path: str) -> None:
    """Write the engine's static index tables to `path` (.npz): the NN
    gather map, the FOCC pairs, the positional encoding and the pilot
    mask, for runtimes outside this package."""
    t = engine.numpy_tables()
    np.savez(path, nn_gather=t["nn_gather"], focc_pair=t["focc_pair"],
             positional_encoding=t["pe"], pilot_mask=t["pilot_mask"])
