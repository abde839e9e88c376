"""The PyTorch port's eval E2E model against the JAX package.

nrx_rt with its eval channel (DoubleTDLlow), float32 and the committed EMA
weights, on a copy of its configuration whose eval grid is cut to 4 PRB
(`n_size_bwp_eval = 4`; the 132-PRB path is `chip_smoke.py`'s). JAX
`E2EModel(p, training=False)` runs at batch 6 from a key; the test rebuilds
that call's bits, CFRs and noise from the key schedule of
`neural_rx_tpu/sim/e2e.py` (`split(key, 8)`, bits from `fold_in(keys[1],
0)`, `kc, kn = split(keys[4])`) and feeds them to the port's
`E2EModel.forward`, at a waterfall Eb/N0 and at 10 dB:

- b and crc equal, b_hat equal where the CRC passes, block-error counters
  equal; with the flooding decoder on both sides (bit-error counters equal
  too), and with the port's layered decoder (its plain version on the
  CPU) against JAX `tb_decode` with the NumPy oracle of the layered kernel
  on the LLRs of the same JAX call. The bits of a block that fails depend
  on rounding: the LLRs of the two packages differ in the last bits (the
  transmitter's constellation is normalised, and the channel's sum runs,
  in another order), and a layered decode that does not converge carries
  that into its bits (995 against 1,027 wrong bits in the 4 failed blocks
  at the waterfall point; the JAX Pallas kernel in interpret mode gives
  1,014).
- the true channel in the estimates' layout equals JAX's; inactive ports
  count no errors; a second Monte-Carlo step uploads no table; what the
  slice does not port raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.kernels import ldpc_pallas as jax_k5
from neural_rx_tpu.phy.misc import binary_source as jax_binary_source
from neural_rx_tpu.phy.misc import complex_awgn as jax_complex_awgn
from neural_rx_tpu.phy.nr.tb import tb_decode as jax_tb_decode
from neural_rx_tpu.rx import neural_rx as jax_neural_rx
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu.sim.e2e import E2EModel as JaxE2EModel
from neural_rx_tpu.sim.training import load_weights
from neural_rx_tpu_torch import entry as port_entry
from neural_rx_tpu_torch import tables, weights
from neural_rx_tpu_torch.dist.mesh import make_mesh
from neural_rx_tpu_torch.sim import simber
from neural_rx_tpu_torch.sim.config import CONFIG_DIR, Parameters
from neural_rx_tpu_torch.sim.e2e import E2EModel

BATCH = 6
WATERFALL_DB = 2.0
# seed of the JAX key, fixed before the first run
PARITY_SEED = 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch in one thread for this module: the suite runs one worker per
    core or so, and threads that outnumber the cores slow the decoders'
    many small ops by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cut_to_4_prb(directory, label):
    """Parameters of `label` in eval mode from a copy of its configuration
    in `directory` whose eval grid is cut to 4 PRB."""
    with open(os.path.join(CONFIG_DIR, label + ".cfg")) as f:
        text = f.read()
    assert "n_size_bwp_eval = 132\n" in text
    with open(os.path.join(directory, label + ".cfg"), "w") as f:
        f.write(text.replace("n_size_bwp_eval = 132\n",
                             "n_size_bwp_eval = 4\n"))
    return Parameters(label, training=False, config_dir=str(directory))


@pytest.fixture(scope="module")
def cfg_dir(tmp_path_factory):
    """A directory holding nrx_rt.cfg with its eval grid cut to 4 PRB."""
    d = tmp_path_factory.mktemp("cfg4")
    _cut_to_4_prb(d, "nrx_rt")
    return str(d)


@pytest.fixture(scope="module")
def jax_side(cfg_dir):
    jp = JaxParameters("nrx_rt", system="nrx", training=False,
                       config_dir=cfg_dir)
    return JaxE2EModel(jp, training=False), load_weights(
        "weights/nrx_rt_ema_weights.pkl")


@pytest.fixture(scope="module")
def port_side(cfg_dir):
    p = Parameters("nrx_rt", training=False, config_dir=cfg_dir)
    assert p.channel_type_name == "DoubleTDLlow"
    assert p.resource_grid.num_subcarriers == 48
    return E2EModel(p, device="cpu"), port_entry.load_params(
        dtype=p.nrx_dtype, device="cpu")


def _jax_draws(jm, key, ebno_db):
    """The bits, CFRs and noise JAX `E2EModel.__call__` draws from key."""
    p = jm.p
    rg = p.transmitters[0].resource_grid
    nsym, nsc = rg.num_ofdm_symbols, rg.num_subcarriers
    keys = jax.random.split(key, 8)
    bits = jax_binary_source(jax.random.fold_in(keys[1], 0),
                             (BATCH, p.max_num_tx, p.transmitters[0].tb_size))
    kc, kn = jax.random.split(keys[4])
    h = p.channel_model(kc, BATCH, nsym, nsc, p.carrier.subcarrier_spacing)
    noise = jax_complex_awgn(kn, (BATCH, p.num_rx_antennas, nsym, nsc),
                             jm._noise_variance(ebno_db, 0))
    return [torch.as_tensor(np.array(a)) for a in (bits, h, noise)]


def _counters(b, b_hat):
    errs = (np.asarray(b) != np.asarray(b_hat)).sum(axis=-1)
    return int(errs.sum()), int((errs > 0).sum())


def _oracle_tb_decode_fast(cfg, llr, num_iter=20):
    """JAX tb_decode with the NumPy oracle of the layered kernel."""
    def decoder(full):
        full = np.asarray(full)
        flat = full.reshape(-1, cfg.code.n_full)
        return jnp.asarray(np.stack([
            jax_k5.reference_layered_decode(cfg.code, row, num_iter)
            for row in flat]).reshape(full.shape))
    return jax_tb_decode(cfg, llr, decoder=decoder)


def _jax_e2e_both_decoders(jm, jparams, key, ebno):
    """{fast_ldpc: (b, b_hat, crc)} of one JAX E2E eval call (flooding)
    whose per-user decode also runs the oracle on the same LLRs (every
    port is active at eval, so the E2E masking leaves both alike)."""
    fast = []

    def both(cfg, llr):
        fast.append([np.asarray(a) for a in _oracle_tb_decode_fast(cfg, llr)])
        return jax_tb_decode(cfg, llr)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_neural_rx, "tb_decode", both)
    try:
        b, b_hat, crc = [np.asarray(a) for a in jm(jparams, key, BATCH,
                                                   np.float32(ebno))]
    finally:
        mp.undo()
    return {False: (b, b_hat, crc),
            True: (b, np.stack([x for x, _ in fast], 1),
                   np.stack([c for _, c in fast], 1))}


@pytest.fixture(scope="module")
def parity(jax_side, port_side):
    """{ebno: ({fast: (b, b_hat, crc)} of JAX, the same of the port, the
    draws)}."""
    jm, jparams = jax_side
    model, params = port_side
    out = {}
    for ebno in (WATERFALL_DB, 10.0):
        key = jax.random.PRNGKey(PARITY_SEED)
        draws = _jax_draws(jm, key, ebno)
        port = {fast: [a.numpy() for a in model.forward(
            params, *draws, fast_ldpc=fast)] for fast in (False, True)}
        out[ebno] = (_jax_e2e_both_decoders(jm, jparams, key, ebno), port,
                     draws)
    return out


@pytest.mark.parametrize("ebno", [WATERFALL_DB, 10.0])
@pytest.mark.parametrize("fast", [False, True], ids=["flooding", "layered"])
def test_e2e_matches_jax_given_its_draws(parity, ebno, fast):
    jax_out, port, _ = parity[ebno]
    jb, jb_hat, jcrc = jax_out[fast]
    b, b_hat, crc = port[fast]
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(crc, jcrc)
    for i, u in zip(*np.nonzero(crc)):
        np.testing.assert_array_equal(b_hat[i, u], jb_hat[i, u])
    bits, blocks = _counters(b, b_hat)
    jbits, jblocks = _counters(jb, jb_hat)
    assert blocks == jblocks
    if not fast:
        assert bits == jbits
    if ebno == WATERFALL_DB:
        assert not crc.all()


def test_ground_truth_channel_matches_jax(jax_side, port_side, parity):
    jm, _ = jax_side
    model, _ = port_side
    h = parity[10.0][2][1]
    want = np.asarray(jm.receiver.preprocess_channel_ground_truth(
        jnp.asarray(h.numpy())))
    got = model.receiver.preprocess_channel_ground_truth(h).numpy()
    assert got.shape == want.shape == (BATCH, 2, 14, 48, 8)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_inactive_ports_count_no_errors(port_side, parity):
    model, params = port_side
    bits, h, noise = parity[WATERFALL_DB][2]
    active = torch.ones((BATCH, 2))
    active[:, 1] = 0.0
    b, b_hat, crc = model.forward(params, bits, h, noise, active_dmrs=active)
    assert not b[:, 1].any() and not b_hat[:, 1].any()
    assert crc[:, 1].all()


def test_second_step_builds_no_table(port_side, monkeypatch):
    """A Monte-Carlo step after the first uploads no static table."""
    model, params = port_side
    gen = torch.Generator().manual_seed(0)
    steps = [simber.make_eval_step(model, fast_ldpc=f) for f in (True, False)]
    for step in steps:
        step(params, gen, 2, 3.0)
    built = tables.built
    uploads = []
    for name in ("as_tensor", "tensor", "from_numpy"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, **k: (
            uploads.append(1), _r(*a, **k))[1])
    for step in steps:
        counts = step(params, gen, 2, 3.0)
        assert counts[1] == 2 * 2 * 1256 and counts[3] == 4
    assert tables.built == built and not uploads


@pytest.mark.parametrize("change,match", [
    ({"mesh": object()}, "multi-GPU"),
    # the Dataset channel is ported; a mesh of the wrong type still raises
    ({"mesh": object(), "channel_type_name": "Dataset"}, "multi-GPU")])
def test_e2e_refuses_what_is_not_ported(cfg_dir, change, match):
    """A mesh is ported (`dist/`): the model takes a `dist.mesh.Mesh` and
    refuses anything else as its mesh."""
    p = Parameters("nrx_rt", training=False, config_dir=cfg_dir)
    kwargs = {k: change.pop(k) for k in ("training", "mesh") if k in change}
    for k, v in change.items():
        setattr(p, k, v)
    with pytest.raises(TypeError, match=match):
        E2EModel(p, device="cpu", **kwargs)
    model = E2EModel(p, device="cpu", mesh=make_mesh())
    assert model.receiver.mesh is model.mesh
    with pytest.raises(TypeError, match=match):
        model.mesh = object()


@pytest.mark.parametrize("label,bits", [("nrx_rt_qpsk", 2),
                                        ("nrx_rt_64qam", 6)])
def test_other_mcs_configs_decode_at_high_snr(tmp_path, label, bits):
    """nrx_rt_qpsk (MCS 9) and nrx_rt_64qam (MCS 19) with their own
    committed weights, 4 PRB, 12 dB: every transport block decodes."""
    p = _cut_to_4_prb(tmp_path, label)
    assert p.transmitters[0].num_bits_per_symbol == bits
    model = E2EModel(p, device="cpu")
    params = port_entry.load_params(dtype=p.nrx_dtype, device="cpu",
                                    path=weights.ema_weights(label))
    b, b_hat, crc = model(params, torch.Generator().manual_seed(0), 4, 12.0,
                          fast_ldpc=True)
    assert b.shape == (4, 2, p.transmitters[0].tb_size)
    assert bool(crc.all()) and torch.equal(b, b_hat)



@pytest.mark.parametrize("label,channel,users", [
    ("e2e_baseline", "TDL-B100", 1), ("nrx_rt", "DoubleTDLlow", 2),
    ("nrx_rt", "AWGN", 2)])
def test_draws_of_each_channel(tmp_path, label, channel, users):
    """bits, h and noise of one batch have the configuration's shapes;
    a single-link TDL draws each user's link, AWGN is the flat 1/sqrt(2)
    channel of the JAX package."""
    p = _cut_to_4_prb(tmp_path, label)
    if channel == "AWGN":
        p.channel_type_name, p.channel_model, p.channel_num_tx = (
            "AWGN", None, None)
    assert p.channel_type_name == channel and p.max_num_tx == users
    model = E2EModel(p, device="cpu")
    (bits,), h, noise = model.draw(torch.Generator().manual_seed(0), 3, 4.0)
    assert bits.shape == (3, users, model.transmitter.tb_size)
    assert h.shape == (3, 4, users, 2, 14, 48) and h.dtype == torch.complex64
    assert noise.shape == (3, 4, 14, 48)
    assert abs(float(noise.abs().pow(2).mean()) - p.noise_variance(4.0)) \
        < 0.2 * p.noise_variance(4.0)
    if channel == "AWGN":
        assert torch.equal(h, torch.full_like(h, 2 ** -0.5))
    else:
        assert abs(float(h.abs().pow(2).mean()) - 1.0) < 0.5
