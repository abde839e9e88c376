"""The PyTorch port's mixed-MCS eval models and frequency offset against the
JAX package.

nrx_rt_var_mcs with its committed weights on a copy of its configuration
whose eval grid is cut to 4 PRB, in the two mixes the reference evaluates
(user 0 on QPSK and user 1 on 16-QAM, and the other way round). The JAX
`sim.mixed_mcs` models run from a key; the test rebuilds that call's draws
from their key schedule (bits of the i-th MCS of the evaluation order from
`fold_in(keys[1], i)`, `kc, kn = split(keys[4])`, the noise variance of
user 0's MCS) and feeds them to the port's `forward`:

- the neural receiver: user 0's b and crc equal, b_hat equal where the CRC
  passes, block counters equal with the flooding decoder on both sides and
  with the port's layered decoder against the NumPy oracle of the layered
  kernel on JAX's LLRs, bit counters equal with flooding;
- LS/lin + LMMSE with a max-log demap at user 0's MCS: the same;
- the eval model with a carrier frequency offset (0.1 ppm, constant at
  eval) as JAX's, given its draws;
- OFDM modulation and demodulation, and the offset applied given JAX's
  drawn offset, within 1e-5 of max |JAX|;
- the default schedule, and `entry.mixed_mcs_entry` at 132 PRB on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_rx_tpu.phy.mapping as jax_mapping
import neural_rx_tpu.phy.nr.tb as jax_tb
import neural_rx_tpu.rx.baselines as jax_baselines
from neural_rx_tpu.channel.cfo import FrequencyOffset as JaxFrequencyOffset
from neural_rx_tpu.phy.ofdm import ofdm_demodulate as jax_ofdm_demodulate
from neural_rx_tpu.phy.ofdm import ofdm_modulate as jax_ofdm_modulate
from neural_rx_tpu.rx import neural_rx as jax_neural_rx
from neural_rx_tpu.sim import mixed_mcs as jax_mixed_mcs
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu.sim.e2e import E2EModel as JaxE2EModel
from neural_rx_tpu.sim.training import load_weights
from neural_rx_tpu_torch import entry as port_entry
from neural_rx_tpu_torch.channel.cfo import FrequencyOffset
from neural_rx_tpu_torch.phy.ofdm import ofdm_demodulate, ofdm_modulate
from neural_rx_tpu_torch.sim.config import CONFIG_DIR, Parameters
from neural_rx_tpu_torch.sim.e2e import E2EModel
from neural_rx_tpu_torch.sim.mixed_mcs import (MixedMCSBaselineModel,
                                               MixedMCSE2EModel)
from neural_rx_tpu_torch.weights import from_jax_numpy
from test_torch_var_mcs import (BATCH, EBNO_DB, PARITY_SEED, VAR, VAR_PKL,
                                _jax_draws, assert_parity,
                                jax_call_both_decoders,
                                jitted_jax_cgnn,  # noqa: F401 (fixture)
                                with_jitted_stages)

# (evaluation order, one-hot MCS rows of users 0 and 1)
MIXES = {"ue0_qpsk": ([0, 1], [[1.0, 0.0], [0.0, 1.0]]),
         "ue0_16qam": ([1, 0], [[0.0, 1.0], [1.0, 0.0]])}
# the baseline's mixed slot (its 16-QAM demap is held to JAX on MCS 1 in
# tests/test_torch_var_mcs.py)
BASELINE_MIX = "ue0_qpsk"
CFO_PPM = 0.1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cfg_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg4")
    with open(os.path.join(CONFIG_DIR, VAR + ".cfg")) as f:
        text = f.read()
    assert "n_size_bwp_eval = 132\n" in text
    with open(os.path.join(d, VAR + ".cfg"), "w") as f:
        f.write(text.replace("n_size_bwp_eval = 132\n",
                             "n_size_bwp_eval = 4\n"))
    return str(d)


@pytest.fixture(scope="module")
def sides(cfg_dir):
    """(JAX parameters, port parameters, JAX weights, port weights, a JAX
    eval model whose jitted stages every JAX model of the file shares)."""
    jp = JaxParameters(VAR, system="nrx", training=False, config_dir=cfg_dir)
    p = Parameters(VAR, training=False, config_dir=cfg_dir)
    jparams = load_weights(VAR_PKL)
    return (jp, p, jparams, {"cgnn": from_jax_numpy(jparams["cgnn"])},
            with_jitted_stages(JaxE2EModel(jp, training=False)))


def _oracle_user(want, ue=0):
    """JAX's mixed-model outputs with the layered oracle's decode reduced
    to user `ue` (the neural receiver decodes every user, the baseline
    user `ue` alone)."""
    b, b_hat, crc = want[True]
    i = ue if b_hat.shape[1] > 1 else 0
    return {False: want[False], True: (b, b_hat[:, i], crc[:, i])}


@pytest.fixture(scope="module")
def mixed_parity(sides):
    """{(system, mix): (JAX {fast: outputs}, port {fast: outputs})}; JAX's
    baseline detection as jitted programs."""
    jp, p, jparams, params, like = sides
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_baselines, "lmmse_equalize",
               jax.jit(jax_baselines.lmmse_equalize))
    mp.setattr(jax_mapping, "demap_maxlog", jax.jit(jax_mapping.demap_maxlog))
    out = {}
    for mix, (order, rows) in MIXES.items():
        key = jax.random.PRNGKey(PARITY_SEED + 10)
        jmask = jnp.asarray([rows], jnp.float32)
        tmask = torch.tensor([rows])
        jm = with_jitted_stages(jax_mixed_mcs.MixedMCSE2EModel(
            jp, order, ue_return=0, mcs_ue_mask=jmask), like)
        bits, h, noise = _jax_draws(jm, key, order)
        model = MixedMCSE2EModel(p, order, mcs_ue_mask=tmask, device="cpu")
        port = {fast: [a.numpy() for a in model.forward(
            params, bits, h, noise, fast_ldpc=fast)] for fast in (False, True)}
        want = jax_call_both_decoders(jax_neural_rx, lambda: jm(
            jparams, key, BATCH, np.float32(EBNO_DB)))
        out["nrx", mix] = (_oracle_user(want), port)
        if mix != BASELINE_MIX:
            continue
        jb = with_jitted_stages(jax_mixed_mcs.MixedMCSBaselineModel(
            jp, order, ue_return=0, mcs_ue_mask=jmask), like)
        jb._channel = jm._channel  # the CFRs drawn above
        jb.ls = jax.jit(jb.ls.__call__)
        base = MixedMCSBaselineModel(p, order, mcs_ue_mask=tmask,
                                     device="cpu")
        no = p.noise_variance(EBNO_DB, order[0])
        port = {fast: [a.numpy() for a in base.forward(
            {}, bits, h, noise, no, fast_ldpc=fast)] for fast in (False, True)}
        want = jax_call_both_decoders(jax_tb, lambda: jb(
            {}, key, BATCH, np.float32(EBNO_DB)))
        out["lslin", mix] = (_oracle_user(want), port)
    mp.undo()
    return out


@pytest.mark.parametrize("fast", [False, True], ids=["flooding", "layered"])
@pytest.mark.parametrize("system,mix", [("nrx", m) for m in sorted(MIXES)]
                         + [("lslin", BASELINE_MIX)])
def test_mixed_mcs_matches_jax_given_its_draws(mixed_parity, system, mix,
                                               fast):
    want, got = mixed_parity[system, mix]
    assert got[fast][0].shape == (BATCH, want[False][0].shape[-1])
    assert_parity(want, got, fast)


def test_e2e_with_frequency_offset_matches_jax(cfg_dir, sides):
    """The eval model with a constant 0.1 ppm offset, given JAX's draws,
    with the flooding decoder: the same bits, CRCs and counters."""
    _, _, jparams, params, like = sides
    over = {"cfo_offset_ppm": CFO_PPM}
    jp = JaxParameters(VAR, system="nrx", training=False, config_dir=cfg_dir,
                       overrides=over)
    p = Parameters(VAR, training=False, config_dir=cfg_dir, overrides=over)
    assert p.frequency_offset.max_rel_offset == pytest.approx(
        jp.frequency_offset.max_rel_offset, rel=1e-12)
    assert p.frequency_offset.min_rel_offset == \
        p.frequency_offset.max_rel_offset
    jm = with_jitted_stages(JaxE2EModel(jp, training=False), like)
    key = jax.random.PRNGKey(PARITY_SEED + 20)
    bits, h, noise = _jax_draws(jm, key, [0])
    got = {False: [a.numpy() for a in E2EModel(p, device="cpu").forward(
        params, bits, h, noise)]}
    want = {False: [np.asarray(a) for a in jm(jparams, key, BATCH,
                                              np.float32(EBNO_DB))]}
    assert_parity(want, got, False)
    assert Parameters(VAR, training=False,
                      config_dir=cfg_dir).frequency_offset is None


def _grid(seed, shape=(2, 2, 1, 14, 48)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert np.max(np.abs(np.asarray(got) - want)) <= tol * np.max(
        np.abs(want))


@pytest.mark.parametrize("cp", [0, 6])
def test_ofdm_modulate_demodulate_match_jax(cp):
    x = _grid(cp)
    xt = ofdm_modulate(torch.as_tensor(x), cp)
    jxt = jax_ofdm_modulate(jnp.asarray(x), cp)
    assert xt.shape == jxt.shape == (2, 2, 1, 14 * (48 + cp))
    _close(xt.numpy(), jxt)
    back = ofdm_demodulate(torch.as_tensor(np.asarray(jxt)), 48, cp)
    _close(back.numpy(), jax_ofdm_demodulate(jxt, 48, cp))
    _close(back.numpy(), x)


@pytest.mark.parametrize("constant", [False, True])
def test_frequency_offset_matches_jax_given_its_offset(constant):
    x = _grid(3)
    rel = 2.4e-4
    jfo = JaxFrequencyOffset(rel, cp_length=0, constant_offset=constant)
    key = jax.random.PRNGKey(7)
    want = jfo(key, jnp.asarray(x))
    fo_j = jax.random.uniform(key, x.shape[:2] + (1, 1),
                              minval=jfo.min_rel_offset,
                              maxval=max(jfo.max_rel_offset,
                                         jfo.min_rel_offset + 1e-30))
    port = FrequencyOffset(rel, cp_length=0, constant_offset=constant)
    got = port.apply(torch.as_tensor(x), torch.as_tensor(np.asarray(fo_j)))
    _close(got.numpy(), want)
    if constant:
        _close(port(torch.as_tensor(x)).numpy(), want)
    else:
        fo = port.draw(torch.Generator().manual_seed(0), 64, 2)
        assert fo.shape == (64, 2, 1, 1)
        assert float(fo.min()) >= -rel and float(fo.max()) <= rel
        assert float(fo.min()) < 0 < float(fo.max())
    xt = torch.as_tensor(x)
    assert FrequencyOffset(0.0)(xt) is xt


def test_default_schedule_and_order_checks(sides):
    p = sides[1]
    model = MixedMCSE2EModel(p, [1, 0], device="cpu")
    np.testing.assert_array_equal(model.mask(3).numpy(),
                                  [[[0, 1], [1, 0]]] * 3)
    for order in ([0, 0], [0], [0, 2]):
        with pytest.raises(ValueError, match="each of the"):
            MixedMCSE2EModel(p, order, device="cpu")
    with pytest.raises(ValueError, match="lslin or lsnn"):
        MixedMCSBaselineModel(p, [0, 1], chest_type="lmmse", device="cpu")


@pytest.mark.parametrize("system", ["nrx", "lslin"])
def test_mixed_mcs_entry_on_cpu(system):
    """mixed_mcs_entry at 132 PRB, batch 1, 20 dB: user 0's QPSK block is
    counted and decodes."""
    fn, args = port_entry.mixed_mcs_entry(system=system, device="cpu",
                                          batch=1, ebno_db=20.0)
    counts = fn(*args)
    tb = Parameters(VAR).transmitters[0].tb_size
    assert counts.tolist() == [0, tb, 0, 1]
