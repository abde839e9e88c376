"""Monte-Carlo estimate of the frequency, time and space channel
covariances that the LMMSE baseline interpolator reads.

The port's counterpart of `neural_rx_tpu/sim/covariance.py`, split as the
E2E model is: `draw` samples a batch of CFRs of the configuration's channel
from a `torch.Generator`; `accumulate` is deterministic: each link (rx
antenna, tx, port) of each sample is normalised to unit mean power, then
the three covariances are averaged over the other axes. The channel is any
ported one but AWGN: TDL, DoubleTDL, the CIR dataset, or the 38.901
UMi/UMa on which the JAX package measures them (`cli/compute_cov.py`: the
training channel at the eval width).
"""

from __future__ import annotations

import numpy as np
import torch

from ..channel.dataset import DatasetChannel
from ..channel.tr38901 import UMiUMaChannel

COV_SEED = 123  # the seed of the JAX package's estimate


def draw(p, generator: torch.Generator, batch_size: int) -> torch.Tensor:
    """One batch of CFRs of `p`'s channel at its resource grid: [b, rx_ant,
    links, 14, sc] complex64, links = (user, port) pairs of the channel (a
    single-link TDL has one user; UMi/UMa draws p.max_num_tx users)."""
    rg = p.transmitters[0].resource_grid
    nsym, nsc = rg.num_ofdm_symbols, rg.num_subcarriers
    scs = p.carrier.subcarrier_spacing
    if p.channel_model is None:
        raise ValueError(f"no channel model to draw: {p.channel_type_name}")
    if isinstance(p.channel_model, (UMiUMaChannel, DatasetChannel)):
        h = p.channel_model(generator, batch_size, p.max_num_tx, nsym, nsc,
                            scs)
    else:
        h = p.channel_model(generator, batch_size, nsym, nsc, scs)
    if h.dim() == 5:  # a single link: [b, rx_ant, ports, 14, sc]
        h = h[:, :, None]
    return h.reshape(h.shape[0], h.shape[1], -1, *h.shape[-2:])


def accumulate(h: torch.Tensor):
    """(cov_freq [sc, sc], cov_time [14, 14], cov_space [ant, ant]) of the
    CFRs h [b, ant, links, 14, sc], each link normalised to unit power."""
    b, n_ant, n_l, n_sym, n_sc = h.shape
    pw = (h.abs() ** 2).mean(dim=(-1, -2), keepdim=True)
    h = h / pw.clamp_min(1e-12).sqrt()
    hc = h.conj()
    cf = torch.einsum("balsf,balsg->fg", h, hc) / (b * n_ant * n_l * n_sym)
    ct = torch.einsum("balsf,baltf->st", h, hc) / (b * n_ant * n_l * n_sc)
    cs = torch.einsum("balsf,bclsf->ac", h, hc) / (b * n_l * n_sym * n_sc)
    return cf, ct, cs


def compute_cov_matrices(p, generator: torch.Generator,
                         num_batches: int = 8, batch_size: int = 16):
    """(cov_freq, cov_time, cov_space) as complex64 numpy arrays: the mean
    of `accumulate` over `num_batches` draws of `batch_size` from
    `generator` (on the device the work runs on)."""
    sums = None
    for _ in range(num_batches):
        covs = accumulate(draw(p, generator, batch_size))
        sums = covs if sums is None else [s + c for s, c in zip(sums, covs)]
    return tuple((s / num_batches).cpu().numpy().astype(np.complex64)
                 for s in sums)
