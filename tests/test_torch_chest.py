"""PyTorch port vs JAX package: the dense nearest-neighbour LS estimate
(`estimate_planar_dense`) on the nrx_rt 4-PRB grid — FOCC averaging, the
comb d=1 fix at subcarrier 0 (second user, DMRS port 2) — is bit-equal in
float32 and matches the JAX rounding point with a bfloat16 out_dtype."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.phy.chest import LSChannelEstimator as JaxLS
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu_torch.phy.chest import LSChannelEstimator
from neural_rx_tpu_torch.sim.config import Parameters


@pytest.fixture(scope="module")
def estimators():
    jrg = JaxParameters("nrx_rt", system="nrx",
                        training=True).transmitters[0].resource_grid
    prg = Parameters("nrx_rt", training=True).resource_grid
    return JaxLS(jrg, "nn"), LSChannelEstimator(prg)


def _y(seed, b=3):
    return np.random.default_rng(seed).normal(
        size=(b, 4, 14, 48, 2)).astype(np.float32)


def test_comb_offsets_cover_d0_and_d1(estimators):
    _, est = estimators
    assert sorted(est._dense_combs.tolist()) == [0, 1]


@pytest.mark.parametrize("slot_idx", [None, 7])
def test_dense_f32_bit_equal(estimators, slot_idx):
    jls, pls = estimators
    y = _y(0)
    want = np.asarray(jls.estimate_planar_dense(jnp.asarray(y),
                                                slot_idx=slot_idx))
    got = pls.estimate_planar_dense(torch.as_tensor(y), slot_idx=slot_idx)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the JAX gather path (the reference NN map) agrees
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jls.estimate_planar(jnp.asarray(y),
                                                    slot_idx=slot_idx)))


def test_dense_bf16_rounding_point(estimators):
    jls, pls = estimators
    y = _y(1)
    want = np.asarray(jls.estimate_planar_dense(
        jnp.asarray(y), out_dtype=jnp.bfloat16).astype(jnp.float32))
    got = pls.estimate_planar_dense(torch.as_tensor(y),
                                    out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
