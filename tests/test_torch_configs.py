"""The PyTorch port's configurations against the JAX package's.

All 17 configuration files are in the port, byte for byte, and each builds
in training and eval modes with the JAX package's grids (pilot mask, DMRS
grids of every slot, data-RE indices), transport-block sizes, bits per
symbol, code rates, channel type, user count and channel users. The JAX
side is built as tests/test_config_matrix.py builds it (the site-specific
configurations read the synthetic CIR datasets it generates). Every
configuration that trains on UMi and every e2e_* one builds its training
model on the CPU: the UMi channel with JAX's scenario, carrier, antennas,
speeds and normalisation, the [training] section as JAX reads it, the
seed-made parameters (with the constellation where it is trained) and the
noise variance per item.
"""

import filecmp
import os

import numpy as np
import pytest

import neural_rx_tpu.sim.config as jax_config
import jax.numpy as jnp
from neural_rx_tpu.sim.e2e import E2EModel as JaxE2EModel
from neural_rx_tpu.sim.trajectory import ensure_site_datasets
from neural_rx_tpu_torch.sim.config import CONFIG_DIR, Parameters

ALL_CONFIGS = sorted(f[:-4] for f in os.listdir(jax_config.CONFIG_DIR)
                     if f.endswith(".cfg"))


def test_all_17_configs_copied_unchanged():
    assert len(ALL_CONFIGS) == 17
    port = sorted(f[:-4] for f in os.listdir(CONFIG_DIR)
                  if f.endswith(".cfg"))
    assert port == ALL_CONFIGS
    for name in ALL_CONFIGS:
        assert filecmp.cmp(os.path.join(CONFIG_DIR, name + ".cfg"),
                           os.path.join(jax_config.CONFIG_DIR,
                                        name + ".cfg"), shallow=False), name


@pytest.fixture(scope="module")
def site_datasets():
    ensure_site_datasets()


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_config_builds_as_jax(site_datasets, name, training):
    p = Parameters(name, training=training)
    jp = jax_config.Parameters(name, system="nrx", training=training)
    assert p.channel_type_name == jp.channel_type_name
    assert p.channel_num_tx == jp.channel_num_tx
    assert (p.channel_model is None) == (jp.channel_model is None)
    assert (p.frequency_offset is None) == (jp.frequency_offset is None)
    assert p.max_num_tx == jp.max_num_tx
    assert len(p.pusch_configs) == len(jp.pusch_configs)
    for per_ue, jper_ue in zip(p.pusch_configs, jp.pusch_configs):
        assert len(per_ue) == len(jper_ue)
        for c, jc in zip(per_ue, jper_ue):
            assert (c.tb_size, c.num_bits_per_symbol, c.target_coderate,
                    c.num_coded_bits) == (jc.tb_size, jc.num_bits_per_symbol,
                                          jc.target_coderate,
                                          jc.num_coded_bits)
    for tx, jtx in zip(p.transmitters, jp.transmitters):
        rg, jrg = tx.resource_grid, jtx.resource_grid
        np.testing.assert_array_equal(rg.pilot_mask, jrg.pilot_mask)
        np.testing.assert_array_equal(rg.data_ind, jrg.data_ind)
        np.testing.assert_array_equal(rg.dmrs_grids, np.asarray(
            jrg.dmrs_grids))
        assert rg.num_subcarriers == 12 * p.n_size_bwp


TRAINING_CONFIGS = [n for n in ALL_CONFIGS if n.startswith("e2e_")
                    or jax_config.Parameters(n, system="dummy",
                                             training=True).channel_type
                    == "UMi"]


def test_training_configs_are_the_umi_and_e2e_ones():
    assert len(TRAINING_CONFIGS) == 13
    assert {"e2e_rt", "e2e_large", "e2e_baseline", "nrx_rt",
            "nrx_site_specific_baseline"} <= set(TRAINING_CONFIGS)


@pytest.mark.parametrize("name", TRAINING_CONFIGS)
def test_training_model_builds_on_cpu(name):
    import torch

    from neural_rx_tpu_torch.channel.tr38901 import UMiUMaChannel
    from neural_rx_tpu_torch.sim.e2e import E2EModel

    p = Parameters(name, training=True)
    jp = jax_config.Parameters(name, system="nrx", training=True)
    for key in ("training_schedule", "eval_ebno_db_arr", "min_num_tx",
                "max_num_tx"):
        assert getattr(p, key) == getattr(jp, key), key
    for key in ("mcs_training_probs", "mcs_training_snr_db_offset"):
        assert getattr(p, key) == getattr(jp, key, None), key
    if jp.channel_type_name == "UMi":
        ch, jch = p.channel_model, jp.channel_model
        assert isinstance(ch, UMiUMaChannel)
        assert (ch.scenario, ch.fc, ch.num_rx_ant, ch.num_tx_ant,
                ch.min_speed, ch.max_speed, ch.normalize) == (
            jch.scenario, jch.fc, jch.num_rx_ant, jch.num_tx_ant,
            jch.min_speed, jch.max_speed, jch.normalize)
    model = E2EModel(p, training=True, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    assert ("constellation" in params) == bool(p.custom_constellation)
    assert model.receiver.cgnn_cfg.initial_chest == (
        p.initial_chest is not None)
    ebno = np.asarray([0.0, 5.0], np.float32)
    want = JaxE2EModel(jp, training=True)._noise_variance(
        jnp.asarray(ebno), 0)
    np.testing.assert_allclose(p.noise_variance(torch.tensor(ebno)).numpy(),
                               np.asarray(want), rtol=1e-6)
