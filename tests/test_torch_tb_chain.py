"""The PyTorch port's transmit and transport-block chain vs the JAX package.

Same inputs, made from a seed with numpy, through both packages. Everything
deterministic is held exactly: LDPC shift tables and edge lists, encode,
CRC, rate matching and recovery, code-block allocation, scrambling,
`tb_encode`, `map_bits`, `map_data` / `demap_data`, TB sizes. The
transmitter's complex64 slot at 132 PRB is held to 1e-6 absolute (its
symbols have unit energy; the constellation is normalised in complex64 on
both sides), the channel's einsum to 1e-6 of its largest output (sums of
4 complex products in another order). The flooding
decoder (`_phi` is log/exp in float32 on two back ends) is held to equal
bits and CRC flags on noiseless and decodable noisy input, and at the
waterfall to the JAX block-error count within a stated band.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.channel.apply import apply_ofdm_channel as jax_channel
from neural_rx_tpu.phy import constellation as jax_const
from neural_rx_tpu.phy import mapping as jax_mapping
from neural_rx_tpu.phy import misc as jax_misc
from neural_rx_tpu.phy.nr import crc as jax_crc
from neural_rx_tpu.phy.nr import ldpc as jax_ldpc
from neural_rx_tpu.phy.nr import ldpc_tables as jax_tables
from neural_rx_tpu.phy.nr import rate_match as jax_rm
from neural_rx_tpu.phy.nr import sequences as jax_seq
from neural_rx_tpu.phy.nr import tb as jax_tb
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu_torch.channel.apply import apply_ofdm_channel
from neural_rx_tpu_torch.phy import constellation, mapping, misc
from neural_rx_tpu_torch.phy.nr import crc, ldpc, ldpc_tables, rate_match
from neural_rx_tpu_torch.phy.nr import sequences, tb
from neural_rx_tpu_torch.sim.config import Parameters

# (bg, z) of the codes the repository's configs use: nrx_rt's eval block
# (BG1, Z = 384), its 4-PRB training block (BG2, Z = 128), the e2e
# configs' eval block (BG1, Z = 352), and a Z that is no multiple of 32.
CODES = [(1, 384), (2, 128), (1, 352), (2, 52)]
# TB configs: nrx_rt 132 PRB (5 code blocks), nrx_rt 4 PRB, QPSK small
TBS = {"nrx_rt_132prb": (40976, 76032, 4, 553 / 1024),
       "nrx_rt_4prb": (1256, 2304, 4, 553 / 1024),
       "qpsk_352": (352, 960, 2, 0.37)}


def _t(a):
    return torch.as_tensor(np.array(a))


def _jit(fn, cfg):
    """The JAX function with its static config bound, compiled: its
    unrolled LDPC encoder takes ~4x longer op by op."""
    return jax.jit(functools.partial(fn, cfg))


def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def params_132():
    return (JaxParameters("nrx_rt", system="nrx", training=False),
            Parameters("nrx_rt", training=False))


@pytest.mark.parametrize("bg", [1, 2])
@pytest.mark.parametrize("i_ls", range(8))
def test_shift_tables_equal(bg, i_ls):
    """The generated fallback tables (seeded greedy search) at the lifting
    set's largest Z."""
    z = max(ldpc_tables.LIFTING_SETS[i_ls])
    assert ldpc_tables.spec_tables_active() == \
        jax_tables.spec_tables_active()
    assert ldpc_tables.base_graph(bg, z) == jax_tables.base_graph(bg, z)


@pytest.mark.parametrize("bg,z", CODES)
def test_code_edges_equal(bg, z):
    """The shifts folded mod Z and the flat edge lists of LDPCCode."""
    got, want = ldpc.get_code(bg, z), jax_ldpc.get_code(bg, z)
    assert got.shifts == want.shifts
    for name in ("edge_row", "edge_col", "edge_shift", "to_check_idx",
                 "to_var_idx", "row_edges", "row_edge_mask",
                 "row_edge_inv"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert (got.k, got.n, got.n_full, got.max_row_deg) == (
        want.k, want.n, want.n_full, want.max_row_deg)


@pytest.mark.parametrize("bg,z", CODES[:3])
def test_encode_equal(bg, z):
    code = ldpc.get_code(bg, z)
    info = _bits((3, code.k), 10 + z)
    got = ldpc.encode(code, _t(info)).numpy()
    want = np.asarray(_jit(jax_ldpc.encode, jax_ldpc.get_code(bg, z))(
        jnp.asarray(info)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("crc_type,a", [("CRC24A", 40976), ("CRC16", 1256),
                                        ("CRC24B", 8200)])
def test_crc_attach_and_check_equal(crc_type, a):
    bits = _bits((3, a), a)
    got = crc.crc_attach(_t(bits), crc_type)
    want = jax_crc.crc_attach(jnp.asarray(bits), crc_type)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flipped = got.clone()
    flipped[1, 5] = 1.0 - flipped[1, 5]
    np.testing.assert_array_equal(
        crc.crc_check(flipped, crc_type).numpy(),
        np.asarray(jax_crc.crc_check(jnp.asarray(flipped.numpy()),
                                     crc_type)))
    assert crc.crc_check(flipped, crc_type).tolist() == [True, False, True]


@pytest.mark.parametrize("name", TBS)
def test_rate_match_and_recover_equal(name):
    got_cfg, want_cfg = tb.TBConfig(*TBS[name]), jax_tb.TBConfig(*TBS[name])
    assert got_cfg.cb_es == want_cfg.cb_es == \
        jax_rm.cb_bit_allocation(want_cfg.num_coded_bits, want_cfg.num_cbs,
                                 want_cfg.qm)
    code = got_cfg.code
    cw = _bits((2, code.n_full), 3)
    llr = np.random.default_rng(4).normal(
        size=(2, got_cfg.cb_es[-1])).astype(np.float32) * 5
    got = rate_match.rate_match(code, _t(cw), got_cfg.k_prime,
                                got_cfg.cb_es[-1], got_cfg.qm)
    want = jax_rm.rate_match(want_cfg.code, jnp.asarray(cw),
                             want_cfg.k_prime, want_cfg.cb_es[-1],
                             want_cfg.qm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = rate_match.rate_recover(code, _t(llr), got_cfg.k_prime, got_cfg.qm)
    want = jax_rm.rate_recover(want_cfg.code, jnp.asarray(llr),
                               want_cfg.k_prime, want_cfg.qm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("g,c,qm", [(76032, 5, 4), (2304, 1, 4),
                                    (1000, 3, 2), (76038, 5, 6)])
def test_cb_bit_allocation_equal(g, c, qm):
    assert rate_match.cb_bit_allocation(g, c, qm) == \
        jax_rm.cb_bit_allocation(g, c, qm)


def test_scrambling_and_tbs_equal(params_132):
    jp, pp = params_132
    np.testing.assert_array_equal(
        sequences.pusch_scrambling_sequence(1, 1, 76032),
        jax_seq.pusch_scrambling_sequence(1, 1, 76032))
    for jc, pc in zip(jp.pusch_configs[0], pp.pusch_configs[0]):
        for key in ("tb_size", "num_coded_bits", "num_data_res"):
            assert getattr(pc, key) == getattr(jc, key), key
        for key in ("tb_size", "num_coded_bits", "bg", "z", "num_cbs",
                    "k_prime", "num_filler", "cb_es", "tb_crc", "n_rnti",
                    "n_id", "num_bp_iter", "cn_type"):
            assert getattr(pc.tb, key) == getattr(jc.tb, key), key
        np.testing.assert_array_equal(pc.tb.scramb_seq, jc.tb.scramb_seq)
    assert (pp.pusch_configs[0][0].tb.num_cbs,
            pp.pusch_configs[0][0].tb.z) == (5, 384)
    got = pp.pusch_configs[0][1].clone(n_rnti=5, mcs_index=10)
    want = jp.pusch_configs[0][1].clone(n_rnti=5, mcs_index=10)
    assert (got.tb_size, got.tb.n_rnti, got.tb.qm, got.tb.n_id) == (
        want.tb_size, want.tb.n_rnti, want.tb.qm, want.tb.n_id)


@pytest.mark.parametrize("name", TBS)
def test_tb_encode_equal(name):
    cfg = tb.TBConfig(*TBS[name], n_rnti=3, n_id=7)
    bits = _bits((2, cfg.tb_size), 5)
    got = tb.tb_encode(cfg, _t(bits))
    want = _jit(jax_tb.tb_encode,
                jax_tb.TBConfig(*TBS[name], n_rnti=3, n_id=7))(
        jnp.asarray(bits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m", [2, 4, 6])
def test_map_bits_equal(m):
    np.testing.assert_array_equal(constellation.qam_points(m),
                                  jax_const.qam_points(m))
    np.testing.assert_array_equal(constellation.bit_labels(m),
                                  jax_const.bit_labels(m))
    pts = constellation.qam_points(m)
    bits = _bits((3, 60 * m), m)
    got = mapping.map_bits(_t(bits), _t(pts)).numpy()
    want = np.asarray(jax_mapping.map_bits(jnp.asarray(bits),
                                           jnp.asarray(pts)))
    np.testing.assert_array_equal(got, want)


def test_map_and_demap_data_equal(params_132):
    jp, pp = params_132
    jrg, rg = jp.transmitters[0].resource_grid, pp.resource_grid
    for name in ("data_ind", "num_data_symbols", "num_pilot_symbols",
                 "num_resource_elements", "cp_overhead"):
        np.testing.assert_array_equal(getattr(rg, name), getattr(jrg, name),
                                      err_msg=name)
    rng = np.random.default_rng(6)
    sym = (rng.normal(size=(2, rg.num_data_symbols))
           + 1j * rng.normal(size=(2, rg.num_data_symbols))).astype(
        np.complex64)
    grid = rg.map_data(_t(sym))
    np.testing.assert_array_equal(grid.numpy(),
                                  np.asarray(jrg.map_data(jnp.asarray(sym))))
    np.testing.assert_array_equal(rg.demap_data(grid).numpy(), sym)
    llr = rng.normal(size=(2, 2, 14, rg.num_subcarriers, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        rg.demap_data(_t(llr)).numpy(),
        np.asarray(jrg.demap_data(jnp.asarray(llr))))


def test_transmitter_slot_132prb_matches_jax(params_132):
    """The whole TX at nrx_rt's eval width, batch 2: TB encode of both
    users, 16-QAM, RE mapping, DMRS and precoding."""
    jp, pp = params_132
    bits = _bits((2, 2, pp.transmitters[0].tb_size), 8)
    got = pp.transmitters[0](_t(bits))
    want = np.asarray(jax.jit(jp.transmitters[0].__call__)(
        jnp.asarray(bits)))
    assert got.shape == want.shape == (2, 2, 2, 14, 1584)
    assert got.dtype == torch.complex64
    assert np.abs(got.numpy() - want).max() <= 1e-6


def test_noise_variance_and_channel_match_jax(params_132):
    jp, pp = params_132
    rg = jp.transmitters[0].resource_grid
    want_no = float(jax_misc.ebnodb2no(
        10.0, 4, 553 / 1024, rg.num_resource_elements * (1 + rg.cp_overhead),
        rg.num_data_symbols))
    assert pp.noise_variance(10.0) == pytest.approx(want_no, rel=1e-6)
    assert misc.ebnodb2no(3.0, 2, 0.5) == pytest.approx(
        float(jax_misc.ebnodb2no(3.0, 2, 0.5)), rel=1e-6)
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(2, 2, 2, 14, 48))
         + 1j * rng.normal(size=(2, 2, 2, 14, 48))).astype(np.complex64)
    h = (rng.normal(size=(2, 4, 2, 2, 14, 48))
         + 1j * rng.normal(size=(2, 4, 2, 2, 14, 48))).astype(np.complex64)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax_channel(key, jnp.asarray(x), jnp.asarray(h), 0.3))
    noise = np.asarray(jax_misc.complex_awgn(key, want.shape, 0.3))
    got = apply_ofdm_channel(_t(x), _t(h), 0.3, noise=_t(noise)).numpy()
    # sums of 4 complex products in another order
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_random_sources_are_seeded():
    g = torch.Generator().manual_seed(3)
    bits = misc.binary_source((4, 1000), g)
    assert set(bits.unique().tolist()) <= {0.0, 1.0}
    assert 0.45 < float(bits.mean()) < 0.55
    n = misc.complex_awgn((20000,), 0.5, torch.Generator().manual_seed(3))
    assert n.dtype == torch.complex64
    assert float((n.abs() ** 2).mean()) == pytest.approx(0.5, rel=0.05)
    again = misc.complex_awgn((20000,), 0.5,
                              torch.Generator().manual_seed(3))
    assert torch.equal(n, again)


def _noisy_tb_llr(cfg_args, ebno_db, batch, seed):
    """(bits, Sionna-convention LLRs [batch, G]) of 16-QAM/QPSK TBs over
    AWGN through the JAX chain, with numpy bits and noise."""
    a, g, qm, r = cfg_args
    cfg = jax_tb.TBConfig(*cfg_args)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, a)).astype(np.float32)
    pts = jnp.asarray(jax_const.qam_points(qm))
    x = jax_mapping.map_bits(_jit(jax_tb.tb_encode, cfg)(jnp.asarray(bits)),
                             pts)
    no = 1.0 / (10 ** (ebno_db / 10) * qm * a / g)
    n = ((rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
         * np.sqrt(no / 2)).astype(np.complex64)
    llr = jax_mapping.demap_maxlog(x + n, pts, jnp.asarray(no, jnp.float32))
    return bits, np.asarray(llr).reshape(batch, -1)


@pytest.mark.parametrize("name,ebno_db", [("nrx_rt_4prb", None),
                                          ("nrx_rt_4prb", 6.0)])
def test_flooding_tb_decode_equal(name, ebno_db):
    """Noiseless (+-8 LLRs) and decodable noisy input: equal bits and CRC
    flags, every block decoded. The 5-block TB at 132 PRB is decoded by
    both packages' `apply` in test_torch_eval_path.py."""
    args = TBS[name]
    batch = 4
    if ebno_db is None:
        bits = _bits((batch, args[0]), 12)
        coded = np.asarray(_jit(jax_tb.tb_encode, jax_tb.TBConfig(*args))(
            jnp.asarray(bits)))
        llr = (2.0 * coded - 1.0) * 8.0
    else:
        bits, llr = _noisy_tb_llr(args, ebno_db, batch, 13)
    got_b, got_ok = tb.tb_decode(tb.TBConfig(*args), _t(llr))
    want_b, want_ok = jax_tb.tb_decode(jax_tb.TBConfig(*args),
                                       jnp.asarray(llr))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_b.numpy(), bits)
    assert bool(got_ok.all())


def test_flooding_waterfall_block_errors_within_band():
    """At the waterfall of the 4-PRB block (3.5 dB, 32 blocks) the two
    float32 back ends may round phi differently, so blocks may flip; the
    block-error counts must lie within 3 of each other, and both detect
    every failure they make (CRC flag false iff bits differ)."""
    bits, llr = _noisy_tb_llr(TBS["nrx_rt_4prb"], 3.5, 32, 14)
    got_b, got_ok = tb.tb_decode(tb.TBConfig(*TBS["nrx_rt_4prb"]), _t(llr))
    want_b, want_ok = jax_tb.tb_decode(jax_tb.TBConfig(*TBS["nrx_rt_4prb"]),
                                       jnp.asarray(llr))
    got_err = (got_b.numpy() != bits).any(axis=1)
    want_err = (np.asarray(want_b) != bits).any(axis=1)
    assert 0 < want_err.sum() < 32, "not at the waterfall"
    assert abs(int(got_err.sum()) - int(want_err.sum())) <= 3
    np.testing.assert_array_equal(got_err, ~got_ok.numpy())
    np.testing.assert_array_equal(want_err, ~np.asarray(want_ok))


def test_minsum_flooding_decode_equal():
    code = ldpc.get_code(2, 52)
    llr = np.random.default_rng(15).normal(
        size=(3, code.n_full)).astype(np.float32) * 3
    got = ldpc.decode(code, _t(llr), 5, "minsum").numpy()
    want = np.asarray(jax_ldpc.decode(jax_ldpc.get_code(2, 52),
                                      jnp.asarray(llr), 5, "minsum"))
    np.testing.assert_array_equal(got, want)
