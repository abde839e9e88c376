"""Site-specific CIR dataset channel.

The port's counterpart of `neural_rx_tpu/channel/dataset.py`: a dataset of
channel impulse responses (a [N, rx_ant, tx_ant, paths] complex64 path
gains, tau [N, paths] float32 delays), loaded whole, cut to its first
`max_num_examples` records, split into `num_tx` equal partitions of
n // num_tx records (one per user) and projected onto the OFDM grid in the
frequency domain, constant over the slot.

Split as `channel/tdl.py` is: `draw` takes a `torch.Generator` and returns
the record indices [b, num_tx]; `cfr` is deterministic, so a test can feed
it the indices the JAX package draws. Training with random subsampling
draws each user's record independently in its partition; otherwise (eval,
or training without it) one start per batch item picks the same position
in every partition (users at paired trajectory offsets). The records are
uploaded once per device.

As in the JAX package the gains stay raw: the configurations set
`channel_norm = True`, which this channel does not apply.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .io_native import read_cirbin

# -2 pi rounded to float32 once, as the JAX package's complex64 constant
_NEG_TWO_PI_F32 = float(np.float32(-2 * np.pi))


def load_cir_records(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(a, tau) from a `.npz` (arrays "a" and "tau") or a `.cirbin`. The
    configurations name the reference's `.tfrecord` files; a missing path
    falls back to the same basename with `.cirbin`, then `.npz`."""
    if not os.path.exists(path):
        base = os.path.splitext(path)[0]
        for ext in (".cirbin", ".npz"):
            if os.path.exists(base + ext):
                path = base + ext
                break
        else:
            raise FileNotFoundError(
                f"no CIR dataset at {path} (nor {base}.cirbin or .npz); "
                "`python -m neural_rx_tpu_torch.sim.trajectory --out DIR` "
                "writes the synthetic site datasets")
    if path.endswith(".npz"):
        with np.load(path) as d:
            return (np.asarray(d["a"], np.complex64),
                    np.asarray(d["tau"], np.float32))
    return read_cirbin(path)


class DatasetChannel:
    """CIR-dataset channel with the training and eval subsampling of the
    JAX package."""

    def __init__(self, path: str, training: bool, num_tx: int,
                 random_subsampling: bool = True, num_rx_ant: int = 4,
                 num_tx_ant: int = 2, max_num_examples: int = -1):
        a, tau = load_cir_records(path)
        if max_num_examples > 0:
            a, tau = a[:max_num_examples], tau[:max_num_examples]
        if a.shape[1:3] != (num_rx_ant, num_tx_ant):
            raise ValueError(f"{path}: records of {a.shape[1]} rx x "
                             f"{a.shape[2]} tx antennas, the configuration "
                             f"has {num_rx_ant} x {num_tx_ant}")
        self.a, self.tau = a, tau
        self.training = training
        self.random_subsampling = random_subsampling
        self.num_tx = num_tx
        part = a.shape[0] // num_tx
        self.partitions = [np.arange(i * part, (i + 1) * part)
                           for i in range(num_tx)]
        self.pair_offset = part
        self._on: dict = {}

    def _records(self, device: torch.device):
        """(a, tau) on `device`, uploaded once."""
        key = str(device)
        if key not in self._on:
            self._on[key] = (torch.as_tensor(self.a, device=device),
                             torch.as_tensor(self.tau, device=device))
        return self._on[key]

    def draw(self, generator: torch.Generator, batch_size: int,
             num_tx: int) -> torch.Tensor:
        """Record indices [b, num_tx] int64 on the generator's device: user
        u's record lies in partition u."""
        dev = generator.device
        part = self.pair_offset
        offsets = torch.arange(num_tx, device=dev)[None, :] * part
        if self.training and self.random_subsampling:
            idx = torch.randint(0, part, (batch_size, num_tx),
                                generator=generator, device=dev)
        else:
            idx = torch.randint(0, part, (batch_size, 1),
                                generator=generator, device=dev)
        return idx + offsets

    def cfr(self, idx: torch.Tensor, num_symbols: int, num_sc: int,
            subcarrier_spacing: float) -> torch.Tensor:
        """h [b, rx_ant, num_tx, tx_ant, num_symbols, num_sc] complex64 (a
        view, constant over the symbols) of the records idx [b, num_tx]:
        sum_p a_p exp(-j 2 pi f tau_p) at the centred subcarrier
        frequencies f, the phase in the JAX package's rounding order
        (fl32(-2 pi) f) tau."""
        a, tau = self._records(idx.device)
        a_b, tau_b = a[idx], tau[idx]  # [b, T, rx, x, p], [b, T, p]
        f = (torch.arange(num_sc, dtype=torch.float32, device=idx.device)
             - (num_sc - 1) / 2.0) * subcarrier_spacing
        theta = (f * _NEG_TWO_PI_F32) * tau_b[..., None]  # [b, T, p, sc]
        phase = torch.polar(torch.ones_like(theta), theta)
        h = torch.einsum("btrxp,btpf->brtxf", a_b, phase)
        return h[..., None, :].expand(h.shape[:-1] + (num_symbols, num_sc))

    def __call__(self, generator: torch.Generator, batch_size: int,
                 num_tx: int, num_symbols: int, num_sc: int,
                 subcarrier_spacing: float) -> torch.Tensor:
        """`cfr` of fresh draws."""
        return self.cfr(self.draw(generator, batch_size, num_tx),
                        num_symbols, num_sc, subcarrier_spacing)
