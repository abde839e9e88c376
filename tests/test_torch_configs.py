"""The PyTorch port's configurations against the JAX package's.

All 17 configuration files are in the port, byte for byte, and each builds
in training and eval modes with the JAX package's grids (pilot mask, DMRS
grids of every slot, data-RE indices), transport-block sizes, bits per
symbol, code rates, channel type, user count and channel users. The JAX
side is built as tests/test_config_matrix.py builds it (the site-specific
configurations read the synthetic CIR datasets it generates).
"""

import filecmp
import os

import numpy as np
import pytest

import neural_rx_tpu.sim.config as jax_config
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
    assert (p.channel_model is None) == (
        jp.channel_model is None or jp.channel_type_name in (
            "UMi", "UMa", "Dataset"))
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
