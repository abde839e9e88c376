"""The PyTorch port's baseline E2E model against the JAX package.

nrx_rt with its eval channel (DoubleTDLlow) on a copy of its configuration
whose eval grid is cut to 4 PRB (`n_size_bwp_eval = 4`; the 132-PRB path is
`chip_smoke.py`'s), batch 6, Eb/N0 4 dB, for each of the six baseline
systems. The port computes the LMMSE estimate's covariances into a
temporary directory (never `weights/`), and the JAX model reads the same
files. JAX `BaselineE2EModel` runs from a key; the test rebuilds that
call's bits, CFRs and noise from the key schedule of
`neural_rx_tpu/sim/baseline_e2e.py`: `split(key, 8)`, the bits drawn from
`keys[1]` itself (the neural model's `fold_in(keys[1], 0)` would feed other
bits), `kc, kn = split(keys[4])`, the noise variance of the evaluated MCS.
The port's `forward` gets those draws:

- with the flooding decoder on both sides, every system gives JAX's bits,
  CRCs and decoded blocks;
- with the layered decoder (its plain version on the CPU) against JAX
  `tb_decode` with the NumPy oracle of the layered kernel on the LLRs of
  the same JAX call (LS/lin + LMMSE): the same CRCs and the same blocks
  where they decode. The bits inside a block that fails in both may
  differ: the LLRs of the two packages differ in their last bits, and a
  layered decode that does not converge carries that into its bits.

Also: the evaluate CLI on the CPU at 132 PRB writes a pickle JAX reads;
`sim_ber` and `entry.baseline_entry` run a baseline; a second step uploads
no table; what the slice does not port raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.channel.apply import \
    apply_ofdm_channel as jax_apply_ofdm_channel
from neural_rx_tpu.kernels import ldpc_pallas as jax_k5
from neural_rx_tpu.phy.misc import binary_source as jax_binary_source
from neural_rx_tpu.phy.misc import complex_awgn as jax_complex_awgn
from neural_rx_tpu.phy.nr.tb import tb_decode as jax_tb_decode
from neural_rx_tpu.sim import baseline_e2e as jax_baseline_e2e
from neural_rx_tpu.sim import metrics as jax_metrics
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu_torch import entry, tables
from neural_rx_tpu_torch.cli import evaluate as port_cli
from neural_rx_tpu_torch.sim import simber
from neural_rx_tpu_torch.sim.baseline_e2e import SYSTEMS, BaselineE2EModel
from neural_rx_tpu_torch.sim.config import CONFIG_DIR, Parameters

BATCH = 6
EBNO_DB = 4.0
# seed of the JAX key, fixed before the first run
PARITY_SEED = 5
LAYERED = "baseline_lslin_lmmse"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch in one thread for this module: the suite runs one worker per
    core or so, and threads that outnumber the cores slow the decoders'
    many small ops by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(config dir with nrx_rt.cfg and e2e_baseline.cfg cut to 4 PRB, an
    empty covariance dir)."""
    d = tmp_path_factory.mktemp("cfg4")
    for label in ("nrx_rt", "e2e_baseline"):
        with open(os.path.join(CONFIG_DIR, label + ".cfg")) as f:
            text = f.read()
        assert "n_size_bwp_eval = 132\n" in text
        with open(d / (label + ".cfg"), "w") as f:
            f.write(text.replace("n_size_bwp_eval = 132\n",
                                 "n_size_bwp_eval = 4\n"))
    return str(d), str(tmp_path_factory.mktemp("cov"))


def _port(dirs, system, label="nrx_rt", **kwargs):
    cfg_dir, cov_dir = dirs
    p = Parameters(label, system=system, training=False, config_dir=cfg_dir)
    return BaselineE2EModel(p, system, cov_dir=cov_dir, device="cpu",
                            **kwargs)


def _jax_draws(jm, key):
    """The bits, CFRs, noise and noise variance JAX
    `BaselineE2EModel.__call__` draws from key."""
    p = jm.p
    rg = p.transmitters[0].resource_grid
    nsym, nsc = rg.num_ofdm_symbols, rg.num_subcarriers
    no = jm._noise_variance(np.float32(EBNO_DB), 0)

    @jax.jit
    def draws(key):
        keys = jax.random.split(key, 8)
        bits = jax_binary_source(keys[1], (BATCH, p.max_num_tx,
                                           p.transmitters[0].tb_size))
        kc, kn = jax.random.split(keys[4])
        h = p.channel_model(kc, BATCH, nsym, nsc,
                            p.carrier.subcarrier_spacing)
        noise = jax_complex_awgn(kn, (BATCH, p.num_rx_antennas, nsym, nsc),
                                 no)
        return bits, h, noise

    return [torch.as_tensor(np.array(a)) for a in draws(key)] + [
        float(np.asarray(no))]


class _Jitted:
    """A JAX transmitter whose call runs as one jitted program: op by op,
    JAX compiles each of the LDPC encoder's many small ops on the first
    call, which takes several times longer."""

    def __init__(self, tx):
        self._tx = tx
        self._call = jax.jit(tx.__call__)

    def __getattr__(self, name):
        return getattr(self._tx, name)

    def __call__(self, bits):
        return self._call(bits)


def _oracle_tb_decode_fast(cfg, llr, num_iter=20):
    """JAX tb_decode with the NumPy oracle of the layered kernel."""
    def decoder(full):
        full = np.asarray(full)
        flat = full.reshape(-1, cfg.code.n_full)
        return jnp.asarray(np.stack([
            jax_k5.reference_layered_decode(cfg.code, row, num_iter)
            for row in flat]).reshape(full.shape))
    return jax_tb_decode(cfg, llr, decoder=decoder)


def _jax_call(jm, key, with_oracle):
    """{fast_ldpc: (b, b_hat, crc)} of one JAX call (flooding); with_oracle:
    the per-user decode also runs the oracle on the same LLRs."""
    fast = []

    def both(cfg, llr):
        fast.append([np.asarray(a) for a in _oracle_tb_decode_fast(cfg, llr)])
        return jax_tb_decode(cfg, llr)

    mp = pytest.MonkeyPatch()
    if with_oracle:
        mp.setattr(jax_baseline_e2e, "tb_decode", both)
    try:
        b, b_hat, crc = [np.asarray(a) for a in jm({}, key, BATCH,
                                                   np.float32(EBNO_DB))]
    finally:
        mp.undo()
    out = {False: (b, b_hat, crc)}
    if with_oracle:
        out[True] = (b, np.stack([x for x, _ in fast], 1),
                     np.stack([c for _, c in fast], 1))
    return out


@pytest.fixture(scope="module")
def parity(dirs):
    """{system: ({fast: (b, b_hat, crc)} of JAX, the same of the port)}.
    The port's LMMSE model runs first and writes the covariances JAX
    reads."""
    out = {}
    key = jax.random.PRNGKey(PARITY_SEED)
    # the JAX model's receiver stages as jitted programs (faster to compile
    # than op by op); one JAX configuration, transmitter and channel for all
    # six systems, and one estimate for each channel estimator, each
    # compiled once
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_baseline_e2e, "lmmse_equalize",
               jax.jit(jax_baseline_e2e.lmmse_equalize))
    mp.setattr(jax_baseline_e2e, "demap_maxlog",
               jax.jit(jax_baseline_e2e.demap_maxlog))
    mp.setattr(jax_baseline_e2e, "kbest_detect",
               jax.jit(jax_baseline_e2e.kbest_detect, static_argnums=3,
                       static_argnames="k"))
    jp = JaxParameters("nrx_rt", system="baseline_lslin_lmmse",
                       training=False, config_dir=dirs[0])
    transmitters = [_Jitted(jp.transmitters[0])]
    estimates = {}
    # one port configuration for the six systems too
    p = Parameters("nrx_rt", training=False, config_dir=dirs[0])
    draws = None
    for system in SYSTEMS:
        model = BaselineE2EModel(p, system, cov_dir=dirs[1], device="cpu")
        jm = jax_baseline_e2e.BaselineE2EModel(jp, system=system,
                                               cov_dir=dirs[1])
        jm.transmitters = transmitters
        if draws is None:
            *draws, no = _jax_draws(jm, key)
            h = jnp.asarray(draws[1].numpy())

        def channel(k, batch_size, x, no_):
            """JAX `E2EModel._channel` (DoubleTDL) with the CFRs of `key`
            drawn once above."""
            return jax_apply_ofdm_channel(jax.random.split(k)[1], x, h,
                                          no_), h
        jm._channel = channel
        jm._estimate = estimates.setdefault(jm.chest_type,
                                            jax.jit(jm._estimate))
        fasts = (False, True) if system == LAYERED else (False,)
        port = {fast: [a.numpy() for a in model.forward(
            {}, *draws, no, fast_ldpc=fast)] for fast in fasts}
        out[system] = (_jax_call(jm, key, system == LAYERED), port)
    mp.undo()
    return out


def _counters(b, b_hat):
    errs = (b != b_hat).sum(axis=-1)
    return int(errs.sum()), int((errs > 0).sum())


@pytest.mark.parametrize("system,fast", [(s, False) for s in SYSTEMS]
                         + [(LAYERED, True)])
def test_baseline_matches_jax_given_its_draws(parity, system, fast):
    jax_out, port = parity[system]
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
    assert 0 < crc.sum() < crc.size  # the point is on the waterfall


def test_covariances_computed_into_cov_dir(dirs, parity):
    for name, n in (("freq", 48), ("time", 14), ("space", 4)):
        c = np.load(os.path.join(dirs[1], f"nrx_rt_{name}_cov_mat.npy"))
        assert c.shape == (n, n) and c.dtype == np.complex64
        np.testing.assert_allclose(c, c.conj().T, atol=1e-6)


def test_sim_ber_and_second_step(dirs, monkeypatch):
    """`sim_ber` runs a baseline with params {}; a step after the first
    uploads no static table."""
    model = _port(dirs, "baseline_lmmse_kbest")
    _, bler, errs, blocks = simber.sim_ber(
        model, {}, [EBNO_DB], 2, max_mc_iter=1, verbose=False,
        fast_ldpc=True, return_counts=True)
    assert blocks[0] == 4 and 0.0 <= bler[0] <= 1.0
    step = simber.make_eval_step(model, fast_ldpc=True)
    gen = torch.Generator().manual_seed(0)
    step({}, gen, 2, EBNO_DB)
    built = tables.built
    uploads = []
    for name in ("as_tensor", "tensor", "from_numpy"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, **k: (
            uploads.append(1), _r(*a, **k))[1])
    counts = step({}, gen, 2, EBNO_DB)
    assert counts[1] == 2 * 2 * 1256 and counts[3] == 4
    assert tables.built == built and not uploads


def test_evaluate_cli_baseline_on_cpu(tmp_path):
    """132 PRB, batch 2, one step: the pickle is keyed by the system name,
    as the JAX CLI keys it, and JAX reads it."""
    port_cli.main(["--config", "nrx_rt", "--system", "baseline_lslin_lmmse",
                   "--snr", "6", "--max-iter", "1", "--batch-size", "2",
                   "--device", "cpu", "--results-dir", str(tmp_path)])
    ebno, ber, bler = jax_metrics.load_results(
        str(tmp_path / "nrx_rt_results.pkl"))
    np.testing.assert_array_equal(ebno, [6.0])
    key = ("baseline_lslin_lmmse", 2, 0)
    assert 0.0 <= bler[key][0] <= 1.0 and 0.0 <= ber[key][0] <= 1.0


def test_baseline_entry_on_cpu():
    """One Monte-Carlo step of nrx_rt (132 PRB, DoubleTDLlow) with LS/nn +
    LMMSE, batch 1, flooding decoder: at 12 dB both blocks decode."""
    fn, args = entry.baseline_entry(
        "baseline_lsnn_lmmse", device="cpu", batch=1, ebno_db=12.0,
        fast_ldpc=False)
    counts = fn(*args)
    assert counts.dtype == np.int64 and counts[3] == 2
    assert counts[1] == 2 * Parameters("nrx_rt").transmitters[0].tb_size
    assert counts[0] == counts[2] == 0


@pytest.mark.parametrize("change,match", [
    ({"mesh": object()}, "multi-GPU"),
    # the Dataset channel is ported; with a mesh the mesh still raises
    ({"mesh": object(), "channel_type_name": "Dataset"}, "multi-GPU"),
    ({"mask_pilots": True}, "masked pilots"),
    ({"custom_constellation": True}, "constellation")])
def test_baseline_refuses_what_is_not_ported(dirs, change, match):
    p = Parameters("nrx_rt", system="baseline_lsnn_lmmse", training=False,
                   config_dir=dirs[0])
    mesh = change.pop("mesh", None)
    for k, v in change.items():
        setattr(p, k, v)
    with pytest.raises(NotImplementedError, match=match):
        BaselineE2EModel(p, "baseline_lsnn_lmmse", device="cpu", mesh=mesh)


def test_baseline_system_names(dirs):
    with pytest.raises(ValueError, match="unknown baseline system"):
        _port(dirs, "baseline_ls_mmse")
    # the neural receiver's own switches do not concern a classical one
    p = Parameters("nrx_rt", system="baseline_lsnn_lmmse", training=False,
                   config_dir=dirs[0])
    p.initial_chest = None
    model = BaselineE2EModel(p, "baseline_lsnn_lmmse", device="cpu")
    assert (model.chest_type, model.det_type) == ("lsnn", "lmmse")
    model = _port(dirs, "baseline_perf_csi_kbest")
    assert (model.chest_type, model.det_type) == ("perf", "kbest")
