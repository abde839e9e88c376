"""End-to-end model: transmitter -> channel -> neural receiver, for
evaluation and training.

The port's counterpart of `neural_rx_tpu/sim/e2e.py:E2EModel`. The
transmitters of the evaluated MCS are superposed through a one-hot per-user
MCS mask, inactive DMRS ports zeroed, the configuration's carrier frequency
offset applied if it has one, the configuration's channel (TDL-B100,
TDL-C300, DoubleTDL, UMi, UMa, the CIR dataset or AWGN) and the
rate-adjusted noise of the
first evaluated MCS (`Parameters.noise_variance`, one N0 per batch item
for a tensor of Eb/N0s) added. The end-to-end configurations send a
trainable constellation (`params["constellation"]`, centred and normalised
each pass) and no pilot energy (`mask_pilots`).

Eval: every DMRS port active, the configured slot, then the receiver's
`apply` (CGNN, per-user transport-block decode of the first evaluated MCS).
Training (`training=True`): a random pilot slot, the coded bits of each
MCS as labels, then the receiver's `training_loss` -> (loss_data,
loss_chest).

Randomness comes from one `torch.Generator` on the model's device, drawn in
a fixed order: at eval by `draw` (the bits of each evaluated MCS in order,
the channel, the noise), in training by `draw_training` (the bits, the
pilot slot, the frequency offsets, the channel, the noise). `forward` does
everything after the draws, so a test can feed it the JAX package's own.

On a mesh (`E2EModel(mesh=)`, `dist/`) every rank draws the global batch
from its generator, exactly as one device would (the same seed on every
rank), and keeps its data block: the bits, the channel and the noise of
its batch rows. The receiver runs its CGNN on the rank's subcarrier block
and gathers the LLRs over the grid group, so every rank of a data row
decodes that row's transport blocks (K5 per data rank); error counters
are summed over the data group by `sim_ber`. Training shards the batch
alone (`sim/training.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..channel.apply import apply_ofdm_channel
from ..channel.dataset import DatasetChannel
from ..channel.tr38901 import UMiUMaChannel
from ..dist.mesh import Mesh, constrain
from ..phy.constellation import Constellation
from ..phy.misc import binary_source, complex_awgn
from ..rx.neural_rx import mcs_mask, receiver_for, resolve_device


def sample_active_dmrs(generator: torch.Generator, batch_size: int, num_tx,
                       max_num_tx: int) -> torch.Tensor:
    """[b, max_num_tx] float32 on the generator's device: a random
    permutation mask with num_tx (an int or a 0-dim tensor) active ports per
    item, as the argsort of an argsort of uniform scores."""
    scores = torch.rand((batch_size, max_num_tx), generator=generator,
                        device=generator.device)
    rank = torch.argsort(torch.argsort(scores, dim=-1), dim=-1)
    return (rank < num_tx).float()


def eval_order(mcs_arr_eval_idx, mcs_ue_mask, num_mcs: int) -> list:
    """The evaluated MCS, in order, as the JAX eval model reads its
    arguments: without a mask one MCS index (an int); with a mask every
    MCS, or the order given as a list."""
    if mcs_ue_mask is None:
        if not isinstance(mcs_arr_eval_idx, (int, np.integer)):
            raise TypeError("without mcs_ue_mask, mcs_arr_eval_idx is one "
                            "MCS index")
        order = [int(mcs_arr_eval_idx)]
    elif isinstance(mcs_arr_eval_idx, (int, np.integer)):
        order = list(range(num_mcs))
    else:
        order = [int(i) for i in mcs_arr_eval_idx]
    if not order or not all(0 <= i < num_mcs for i in order):
        raise ValueError(f"MCS indices {order} out of range: the "
                         f"configuration has {num_mcs} MCS")
    return order


def check_mesh(mesh):
    """TypeError unless mesh is None or a `dist.mesh.Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"a multi-GPU mesh is a dist.mesh.Mesh, not "
                        f"{type(mesh).__name__}")


def refuse_unported(p, mesh=None, baseline: bool = False):
    """NotImplementedError for what the classical baselines cannot take: a
    device mesh (their multi-GPU runs go one process per rank, `sim_ber`
    without a mesh), a trainable constellation or masked pilots, which they
    cannot receive (the JAX package's baselines cannot either)."""
    why = None
    ct = p.channel_type_name
    if baseline and mesh is not None:
        why = ("the classical baselines take no mesh: a multi-GPU run gives "
               "them one process per rank (sim_ber without a mesh)")
    elif baseline and (p.custom_constellation or p.mask_pilots):
        why = ("the classical baselines send fixed QAM with pilots: no "
               "trainable constellation, no masked pilots")
    if why is not None:
        raise NotImplementedError(why)
    if p.channel_num_tx is not None and p.channel_num_tx > 1 \
            and p.channel_num_tx != p.max_num_tx:
        raise ValueError(f"{ct} is a {p.channel_num_tx}-user channel, the "
                         f"configuration has {p.max_num_tx} users")


def data_block(mesh, *tensors) -> list:
    """This rank's data block (batch rows) of each global draw; None and
    0-dim tensors pass."""
    return [x if x is None or x.dim() == 0 else constrain(x, mesh)
            for x in tensors]


def training_block(d: dict, mesh) -> dict:
    """`E2EModel.draw_training`'s dict cut to this rank's data block."""
    *bits, h, noise, fo = data_block(mesh, *d["bits"], d["h"], d["noise"],
                                     d["fo"])
    return dict(d, bits=bits, h=h, noise=noise, fo=fo)


class EvalLink:
    """The transmitters (one per MCS; `transmitter` is the first) and
    channel of one `sim.config.Parameters`, and the draws of a Monte-Carlo
    batch; the E2E models add a receiver."""

    def __init__(self, sys_parameters, device="cuda"):
        self.p = sys_parameters
        self.device = resolve_device(device)
        self.transmitters = self.p.transmitters
        self.transmitter = self.transmitters[0]
        self.num_mcs = len(self.transmitters)

    def _channel(self, generator: torch.Generator, batch_size: int
                 ) -> torch.Tensor:
        """h [b, rx_ant, T, ports, 14, sc] complex64 of one slot."""
        p = self.p
        rg = self.transmitter.resource_grid
        nsym, nsc = rg.num_ofdm_symbols, rg.num_subcarriers
        scs = p.carrier.subcarrier_spacing
        if p.channel_type_name == "AWGN":
            ports = p.num_antenna_ports
            return torch.full(
                (batch_size, p.num_rx_antennas, p.max_num_tx, ports, nsym,
                 nsc), 1.0 / np.sqrt(ports), dtype=torch.complex64,
                device=generator.device)
        if isinstance(p.channel_model, (UMiUMaChannel, DatasetChannel)):
            # any user count
            return p.channel_model(generator, batch_size, p.max_num_tx, nsym,
                                   nsc, scs)
        if p.channel_num_tx == 1:  # a single link: one draw per user
            return torch.stack([
                p.channel_model(generator, batch_size, nsym, nsc, scs)
                for _ in range(p.max_num_tx)], dim=2)
        return p.channel_model(generator, batch_size, nsym, nsc, scs)

    def _bits(self, generator, batch_size, mcs_arr_eval):
        return [binary_source((batch_size, self.p.max_num_tx,
                               self.transmitters[idx].tb_size), generator)
                for idx in mcs_arr_eval]

    def _noise(self, generator, batch_size, ebno_db, mcs_idx):
        rg = self.transmitter.resource_grid
        return complex_awgn(
            (batch_size, self.p.num_rx_antennas, rg.num_ofdm_symbols,
             rg.num_subcarriers), self.p.noise_variance(ebno_db, mcs_idx),
            generator)

    def draw(self, generator: torch.Generator, batch_size: int,
             ebno_db, mcs_arr_eval=(0,)):
        """(bits, h [b, rx_ant, T, ports, 14, sc], noise [b, rx_ant, 14, sc]
        ~ CN(0, N0)) from `generator`, in that order: bits is a list with
        one [b, T, tb_size] tensor per evaluated MCS, in the order of
        mcs_arr_eval, and N0 is that of mcs_arr_eval[0] at ebno_db (a
        number, or a tensor [b]: one N0 per item)."""
        bits = self._bits(generator, batch_size, mcs_arr_eval)
        h = self._channel(generator, batch_size)
        noise = self._noise(generator, batch_size, ebno_db, mcs_arr_eval[0])
        return bits, h, noise

    def transmit(self, bits, order, mcs_ue_mask, active=None, slot_idx=None,
                 points=None, fo=None, return_coded: bool = False):
        """x [b, T, ports, 14, sc]: each evaluated MCS's transmitter on its
        bits (bits[i] for MCS order[i]) in slot slot_idx (default: the
        configured one) with the point set points[i] (None: the fixed
        QAM), times its column of mcs_ue_mask [b, T, num_mcs], summed in
        order; inactive users (active [b, T]) zeroed; the configuration's
        frequency offset applied: the drawn offsets fo [b, T, 1, 1], or the
        constant eval offset. With return_coded also the coded bits of each
        MCS [b, T, G] (the training labels)."""
        x, coded = None, []
        for i, (b_i, idx) in enumerate(zip(bits, order)):
            tx = self.transmitters[idx]
            c_i = tx.encode(b_i)
            coded.append(c_i)
            m = mcs_ue_mask[:, :, idx].to(torch.complex64)
            x_i = tx.modulate(c_i, slot_idx, None if points is None
                              else points[i]) * m[:, :, None, None, None]
            x = x_i if x is None else x + x_i
        if active is not None:
            x = x * active.to(x.dtype)[:, :, None, None, None]
        cfo = self.p.frequency_offset
        if cfo is not None:
            x = cfo(x) if fo is None else cfo.apply(x, fo)
        return (x, coded) if return_coded else x


class E2EModel(EvalLink):
    """TX -> channel -> neural RX of one `sim.config.Parameters`.

    training: `forward` returns the training losses (the receiver's plain
    layers under autograd); otherwise the decoded bits. kernels=False: the
    eval receiver takes its kernels' plain versions on the same route (the
    kernels' oracle on the card)."""

    def __init__(self, sys_parameters, training: bool = False, mesh=None,
                 kernels: bool = True, device="cuda"):
        check_mesh(mesh)
        refuse_unported(sys_parameters)
        super().__init__(sys_parameters, device)
        self.training = training
        self.receiver = receiver_for(self.p, kernels=kernels,
                                     device=self.device)
        self.mesh = mesh
        rg = self.transmitter.resource_grid
        self._num_slots = rg.num_slots_per_frame

    @property
    def mesh(self):
        """The ("data", "grid") mesh the model runs on, or None."""
        return self._mesh

    @mesh.setter
    def mesh(self, mesh):
        check_mesh(mesh)
        self._mesh = mesh
        self.receiver.mesh = mesh

    def init_params(self, generator: torch.Generator) -> dict:
        """Seed-made parameters: the receiver's {"cgnn": tree} and, with a
        trainable constellation, "constellation": one (re, im) [2, 2^m]
        QAM point array per MCS, on the model's device."""
        params = self.receiver.init_params(generator)
        if self.p.custom_constellation:
            params["constellation"] = [
                tx.constellation.init_params(self.device)
                for tx in self.transmitters]
        return params

    def constellation_points(self, params, order):
        """The point set of each MCS of `order` (centred, unit energy) for a
        trainable constellation, else None (the fixed QAM)."""
        if not self.p.custom_constellation:
            return None
        if "constellation" not in params:
            raise ValueError(f"{self.p.label} trains its constellation: "
                             "params need a 'constellation' entry")
        return [Constellation.points(params["constellation"][idx],
                                     center=True) for idx in order]

    def draw_training(self, generator: torch.Generator, batch_size: int,
                      ebno_db: torch.Tensor, mcs_arr_eval) -> dict:
        """The draws of a training step after the per-step sampling, from
        `generator` in this order: "bits" (a [b, T, tb_size] tensor per
        MCS of mcs_arr_eval), "slot_idx" (a 0-dim tensor, uniform over the
        slots of a frame), "fo" (the users' frequency offsets, or None
        without an offset), "h", "noise" (CN(0, N0) of mcs_arr_eval[0] at
        each item's Eb/N0, ebno_db [b])."""
        bits = self._bits(generator, batch_size, mcs_arr_eval)
        slot_idx = torch.randint(0, self._num_slots, (), generator=generator,
                                 device=generator.device)
        fo = None
        if self.p.frequency_offset is not None:
            fo = self.p.frequency_offset.draw(generator, batch_size,
                                              self.p.max_num_tx)
        h = self._channel(generator, batch_size)
        noise = self._noise(generator, batch_size, ebno_db, mcs_arr_eval[0])
        return {"bits": bits, "slot_idx": slot_idx, "fo": fo, "h": h,
                "noise": noise}

    def forward(self, params, bits, h: torch.Tensor, noise: torch.Tensor,
                active_dmrs: torch.Tensor | None = None,
                fast_ldpc: bool = False, output_nrx_h_hat: bool = False,
                num_it: int | None = None, mcs_arr_eval_idx=0,
                mcs_ue_mask: torch.Tensor | None = None, slot_idx=None,
                fo: torch.Tensor | None = None,
                apply_multiloss: bool = False):
        """Everything after the draws: `transmit` the bits (a list as
        `draw` gives it, or one MCS's tensor) in slot slot_idx (default:
        the configured slot) with the inactive ports (active_dmrs [b, T],
        default all active) zeroed and the frequency offsets fo (training;
        at eval the constant offset), y = sum h x + noise, then receive.
        mcs_arr_eval_idx and mcs_ue_mask [b, T, num_mcs] as in the JAX
        package (`eval_order`): without a mask every user is on MCS
        mcs_arr_eval_idx; num_it cuts the CGNN.

        Training: returns (loss_data, loss_chest) of the receiver's
        `training_loss` on the coded bits of every evaluated MCS, with the
        readouts after every iteration if apply_multiloss.

        Eval: returns (b, b_hat, crc) as the JAX package's eval model does:
        the first evaluated MCS's bits [b, T, tb_size] and b_hat zeroed for
        inactive ports, and the error-counting CRC status [b, T] with
        inactive ports forced to pass; with output_nrx_h_hat also (h_true
        [b, T, 14, sc, 2*rx_ant], h_hat refined, h_hat of the LS estimate
        or None)."""
        bits = [bits] if isinstance(bits, torch.Tensor) else list(bits)
        order = eval_order(mcs_arr_eval_idx, mcs_ue_mask, self.num_mcs)
        if len(bits) != len(order):
            raise ValueError(f"{len(bits)} bit tensors for the evaluated "
                             f"MCS {order}")
        if active_dmrs is None:
            active_dmrs = torch.ones(bits[0].shape[:2], device=h.device)
        active = active_dmrs.to(torch.float32)
        if mcs_ue_mask is None:
            mcs_ue_mask = mcs_mask(active.shape, order[0], self.num_mcs,
                                   active.device)
        x, coded = self.transmit(bits, order, mcs_ue_mask, active, slot_idx,
                                 self.constellation_points(params, order),
                                 fo, return_coded=True)
        y = apply_ofdm_channel(x, h, None, noise=noise)
        if self.training:
            return self.receiver.training_loss(
                params, y, active, coded, h, mcs_ue_mask, mcs_arr_eval=order,
                apply_multiloss=apply_multiloss, num_it=num_it,
                slot_idx=slot_idx)
        b_hat, h_ref, h_init, crc = self.receiver.apply(
            params, y, active, mcs_arr_eval=tuple(order),
            mcs_ue_mask=mcs_ue_mask, num_it=num_it, fast_ldpc=fast_ldpc,
            slot_idx=slot_idx)
        am = active[..., None]
        b = bits[0] * am
        b_hat = b_hat * am
        crc = torch.where(active > 0, crc, torch.ones_like(crc))
        if output_nrx_h_hat:
            h_true = self.receiver.preprocess_channel_ground_truth(h)
            return b, b_hat, crc, h_true, h_ref, h_init
        return b, b_hat, crc

    def __call__(self, params, generator: torch.Generator, batch_size: int,
                 ebno_db, fast_ldpc: bool = False,
                 output_nrx_h_hat: bool = False, num_it: int | None = None,
                 mcs_arr_eval_idx=0, mcs_ue_mask: torch.Tensor | None = None,
                 active_dmrs: torch.Tensor | None = None):
        """One batch: the draws from `generator` (on the model's device),
        then `forward`. Eval: `draw`, every port active. Training:
        `draw_training` at ebno_db (a number or a tensor [b]) with the
        ports of active_dmrs [b, T] active (default all). On a mesh the
        draws are of the global batch batch_size, and this rank computes
        its data block: the returns hold its rows (mcs_ue_mask and
        active_dmrs are global too)."""
        order = eval_order(mcs_arr_eval_idx, mcs_ue_mask, self.num_mcs)
        if self._mesh is not None:
            mcs_ue_mask, active_dmrs = data_block(self._mesh, mcs_ue_mask,
                                                  active_dmrs)
        if not self.training:
            bits, h, noise = self.draw(generator, batch_size, ebno_db, order)
            if self._mesh is not None:
                *bits, h, noise = data_block(self._mesh, *bits, h, noise)
            return self.forward(params, bits, h, noise, fast_ldpc=fast_ldpc,
                                output_nrx_h_hat=output_nrx_h_hat,
                                num_it=num_it,
                                mcs_arr_eval_idx=mcs_arr_eval_idx,
                                mcs_ue_mask=mcs_ue_mask)
        ebno = torch.as_tensor(ebno_db, dtype=torch.float32,
                               device=self.device).expand(batch_size)
        d = self.draw_training(generator, batch_size, ebno, order)
        if self._mesh is not None:
            d = training_block(d, self._mesh)
        return self.forward(params, d["bits"], d["h"], d["noise"],
                            active_dmrs=active_dmrs, num_it=num_it,
                            mcs_arr_eval_idx=mcs_arr_eval_idx,
                            mcs_ue_mask=mcs_ue_mask, slot_idx=d["slot_idx"],
                            fo=d["fo"])
