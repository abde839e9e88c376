"""Four small public functions of the JAX package in the PyTorch port,
against the JAX package on the CPU: `phy.misc.zf_precoder`,
`ResourceGrid.effective_subcarrier_ind` and `remove_nulled_subcarriers`
(nrx_rt's 4-PRB training grid) and `NeuralPUSCHReceiver.num_params`
(nrx_rt's committed weights). complex64 at 1e-5 (rtol and atol); indices,
grids and counts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.phy.misc import zf_precoder as jax_zf
from neural_rx_tpu.rx.neural_rx import NeuralPUSCHReceiver as JaxReceiver
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu.sim.training import load_weights
from neural_rx_tpu_torch import entry
from neural_rx_tpu_torch.phy.misc import zf_precoder
from neural_rx_tpu_torch.sim.config import Parameters


@pytest.mark.parametrize("shape", [(2, 4), (5, 2, 4), (3, 2, 3, 3)])
def test_zf_precoder_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    h = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    want = np.asarray(jax_zf(jnp.asarray(h)))
    got = zf_precoder(torch.as_tensor(h))
    assert got.dtype == torch.complex64
    assert got.shape == shape[:-2] + (shape[-1], shape[-2])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # zero forcing: h W is diagonal with the column norms' inverses
    hw = torch.as_tensor(h) @ got
    off = hw - torch.diag_embed(torch.diagonal(hw, dim1=-2, dim2=-1))
    assert off.abs().max() < 1e-4
    np.testing.assert_allclose(
        (got.abs() ** 2).sum(dim=-2).numpy(), 1.0, rtol=1e-5)


def test_effective_subcarriers_match_jax():
    jrg = JaxParameters("nrx_rt", system="nrx", training=True).transmitters[
        0].resource_grid
    rg = Parameters("nrx_rt", training=True).resource_grid
    np.testing.assert_array_equal(rg.effective_subcarrier_ind,
                                  jrg.effective_subcarrier_ind)
    assert len(rg.effective_subcarrier_ind) == rg.num_subcarriers == 48
    rng = np.random.default_rng(0)
    grid = (rng.normal(size=(2, 4, 14, 48))
            + 1j * rng.normal(size=(2, 4, 14, 48))).astype(np.complex64)
    want = np.asarray(jrg.remove_nulled_subcarriers(jnp.asarray(grid)))
    got = rg.remove_nulled_subcarriers(torch.as_tensor(grid))
    np.testing.assert_array_equal(got.numpy(), want)


def test_num_params_matches_jax():
    jp = JaxParameters("nrx_rt", system="nrx", training=True)
    jrx = JaxReceiver(
        jp.transmitters, num_rx_ant=jp.num_rx_antennas,
        max_num_tx=jp.max_num_tx, num_it=jp.num_nrx_iter, d_s=jp.d_s,
        num_units_init=jp.num_units_init, num_units_agg=jp.num_units_agg,
        num_units_state=jp.num_units_state,
        num_units_readout=jp.num_units_readout, initial_chest="ls")
    want = jrx.num_params(load_weights("weights/nrx_rt_ema_weights.pkl"))
    rx = entry.make_receiver(training=True, device="cpu")
    params = entry.load_params(device="cpu")  # packed buffers not counted
    assert rx.num_params(params) == want == 142922
    seeded = rx.init_params(torch.Generator().manual_seed(0))
    assert rx.num_params(seeded) == 142922
