"""PyTorch port vs JAX package: the static nrx_rt grid (4-PRB training
grid) — DMRS grids, pilot mask and values, positional encoding, precoding
and MCS — are array-equal."""

import numpy as np
import pytest

from neural_rx_tpu.phy.nr import dmrs as jax_dmrs
from neural_rx_tpu.rx.cgnn import pilot_positional_encoding as jax_pe
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu_torch.phy import pilot_pattern as port_pp
from neural_rx_tpu_torch.phy.nr import dmrs as port_dmrs
from neural_rx_tpu_torch.phy.nr.sequences import dmrs_c_init, gold_sequence
from neural_rx_tpu_torch.rx.cgnn import pilot_positional_encoding
from neural_rx_tpu_torch.sim.config import Parameters


@pytest.fixture(scope="module")
def grids():
    jp = JaxParameters("nrx_rt", system="nrx", training=True)
    pp = Parameters("nrx_rt", training=True)
    return jp, pp


def test_parameters_fields(grids):
    jp, pp = grids
    for key in ("n_size_bwp", "num_rx_antennas", "max_num_tx", "num_nrx_iter",
                "d_s", "num_units_init", "num_units_agg", "num_units_state",
                "num_units_readout", "mcs_index", "dmrs_port_sets"):
        assert getattr(pp, key) == getattr(jp, key), key
    assert pp.resource_grid.num_subcarriers == 48


def test_eval_grid_is_132_prb():
    pp = Parameters("nrx_rt", training=False)
    assert pp.n_size_bwp == 132
    assert pp.resource_grid.num_subcarriers == 1584
    assert pp.max_num_tx == 2


@pytest.mark.parametrize("field", ["dmrs_grids", "pilot_mask", "pilots"])
def test_resource_grid_equal(grids, field):
    jp, pp = grids
    want = getattr(jp.transmitters[0].resource_grid, field)
    got = getattr(pp.resource_grid, field)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_positional_encoding_equal(grids):
    jp, pp = grids
    jrg, prg = jp.transmitters[0].resource_grid, pp.resource_grid
    want = jax_pe(jrg.dmrs_grids[0], jrg.pilot_mask)
    got = pilot_positional_encoding(prg.dmrs_grids[0], prg.pilot_mask)
    np.testing.assert_array_equal(got, want)


def test_pusch_configs_equal(grids):
    jp, pp = grids
    for jc, pc in zip(jp.pusch_configs[0], pp.pusch_configs[0]):
        np.testing.assert_array_equal(pc.precoding_matrix(),
                                      jc.precoding_matrix())
        assert (pc.num_bits_per_symbol, pc.target_coderate) == (
            jc.num_bits_per_symbol, jc.target_coderate)
        assert pc.dmrs_symbol_indices() == jc.dmrs_symbol_indices()


@pytest.mark.parametrize("config_type,port,add_pos", [
    (1, 0, 1), (1, 3, 2), (1, 6, 0), (2, 0, 1), (2, 5, 3)])
def test_dmrs_grid_for_port_equal(config_type, port, add_pos):
    kw = dict(config_type=config_type, additional_position=add_pos,
              dmrs_port_set=(port,), num_cdm_groups_without_data=2,
              n_scid=1, n_id=(3, 7))
    args = (port, 48, (0, 14), 5)
    want = jax_dmrs.dmrs_grid_for_port(jax_dmrs.DMRSConfig(**kw), *args)
    got = port_dmrs.dmrs_grid_for_port(port_dmrs.DMRSConfig(**kw), *args)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port_dmrs.pilot_mask(port_dmrs.DMRSConfig(**kw), 48, (0, 14)),
        jax_dmrs.pilot_mask(jax_dmrs.DMRSConfig(**kw), 48, (0, 14)))


def test_gold_sequence_equal():
    from neural_rx_tpu.phy.nr import sequences as js
    c_init = dmrs_c_init(3, 11, 1, 1)
    assert c_init == js.dmrs_c_init(3, 11, 1, 1)
    np.testing.assert_array_equal(gold_sequence(c_init, 100),
                                  js.gold_sequence(c_init, 100))


def test_kronecker_pilot_pattern_equal():
    from neural_rx_tpu.phy import pilot_pattern as jax_pp
    want = jax_pp.kronecker_pilot_pattern(2, 14, 48, [2, 11], seed=4)
    got = port_pp.kronecker_pilot_pattern(2, 14, 48, [2, 11], seed=4)
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.pilots, want.pilots)
