"""The PyTorch port's several-MCS eval against the JAX package.

nrx_rt_var_mcs (MCS 9 and 14, QPSK and 16-QAM, one init stack and one LLR
readout per MCS) with its committed weights, converted in memory from the
JAX pickle, and nrx_large_var_mcs_64qam_masking (three MCS, one shared init
stack and readout cut to each MCS's bits, 8 iterations) with JAX-initialised
parameters, each on a copy of its configuration whose eval grid is cut to
4 PRB (the 132-PRB path is `chip_smoke.py`'s):

- `cgnn_apply` on seeded random inputs, every user on one MCS or on mixed
  MCS, after 1 and 2 iterations (all 8 on the masking configuration), on
  the route the receiver takes at batch 2 (stack kernels) and 6 (iteration
  kernel): every MCS's LLRs and the channel readout within 1e-4 of max
  |JAX| (float32, the bar of `tests/test_torch_slice.py`);
- `init_cgnn_params`: JAX's tree, leaf names and shapes for all 17
  configurations, glorot-uniform kernels and zero biases, 142,922 values
  for nrx_rt;
- the eval E2E models on MCS 1 given JAX's draws (`neural_rx_tpu/sim/
  e2e.py`'s key schedule: bits of the i-th evaluated MCS from
  `fold_in(keys[1], i)`; the baseline's from `keys[1]`): b and crc equal,
  b_hat equal where the CRC passes, block counters equal with the flooding
  decoder on both sides and with the port's layered decoder against the
  NumPy oracle of the layered kernel on JAX's LLRs, bit counters equal
  with flooding; the noise variance of the evaluated MCS equal to JAX's;
- `sim_ber` with mcs_arr_eval_idx 1 and `save_results` keyed by MCS 1,
  read by JAX; the evaluate CLI with --mcs-idx 1 at 132 PRB on the CPU;
  `apply` with a cut iteration count; an out-of-range MCS raises.
"""

import dataclasses
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
from neural_rx_tpu.phy.nr.mcs import mcs_to_qm_rate as jax_mcs_to_qm_rate
from neural_rx_tpu.phy.nr.tb import tb_decode as jax_tb_decode
from neural_rx_tpu.rx import neural_rx as jax_neural_rx
from neural_rx_tpu.rx.cgnn import CGNNConfig as JaxCGNNConfig
from neural_rx_tpu.rx.cgnn import cgnn_apply as jax_cgnn_apply
from neural_rx_tpu.rx.cgnn import init_cgnn_params as jax_init_cgnn_params
from neural_rx_tpu.sim import baseline_e2e as jax_baseline_e2e
from neural_rx_tpu.sim import metrics as jax_metrics
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu.sim.e2e import E2EModel as JaxE2EModel
from neural_rx_tpu.sim.training import load_weights
from neural_rx_tpu_torch import entry as port_entry
from neural_rx_tpu_torch.cli import evaluate as port_cli
from neural_rx_tpu_torch.rx.cgnn import cgnn_apply, count_params
from neural_rx_tpu_torch.rx.neural_rx import mcs_mask, receiver_for
from neural_rx_tpu_torch.sim import simber
from neural_rx_tpu_torch.sim.baseline_e2e import BaselineE2EModel
from neural_rx_tpu_torch.sim.config import CONFIG_DIR, Parameters
from neural_rx_tpu_torch.sim.e2e import E2EModel
from neural_rx_tpu_torch.weights import flatten, from_jax_numpy

VAR = "nrx_rt_var_mcs"
MASKING = "nrx_large_var_mcs_64qam_masking"
VAR_PKL = "weights/nrx_rt_var_mcs_weights.pkl"
ALL_CONFIGS = sorted(n[:-4] for n in os.listdir(CONFIG_DIR)
                     if n.endswith(".cfg"))
BATCH = 2
EBNO_DB = 2.0  # MCS 1 (16-QAM) of nrx_rt_var_mcs fails some blocks here
# seed of the JAX key, fixed before the first run
PARITY_SEED = 5
MASKS = {"mcs0": [[1, 0], [1, 0]], "mcs1": [[0, 1], [0, 1]],
         "mixed": [[1, 0], [0, 1]]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch in one thread: the suite runs one worker per core or so, and
    threads that outnumber the cores slow the decoders' small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cfg_dir(tmp_path_factory):
    """A directory holding both configurations with the eval grid cut to
    4 PRB."""
    d = tmp_path_factory.mktemp("cfg4")
    for label in (VAR, MASKING):
        with open(os.path.join(CONFIG_DIR, label + ".cfg")) as f:
            text = f.read()
        assert "n_size_bwp_eval = 132\n" in text
        with open(os.path.join(d, label + ".cfg"), "w") as f:
            f.write(text.replace("n_size_bwp_eval = 132\n",
                                 "n_size_bwp_eval = 4\n"))
    return str(d)


def _jax_receiver(jp):
    return JaxE2EModel(jp, training=False).receiver


class Jitted:
    """A JAX transmitter whose call runs as one jitted program: op by op,
    JAX compiles each of the LDPC encoder's many small ops on the first
    call, which takes several times longer."""

    def __init__(self, tx):
        self._tx = tx
        self._call = jax.jit(tx.__call__, static_argnames=("slot_idx",))

    def __getattr__(self, name):
        return getattr(self._tx, name)

    def __call__(self, bits, slot_idx=None, constellation_points=None):
        return self._call(bits, slot_idx=slot_idx,
                          constellation_points=constellation_points)


def with_jitted_stages(jm, like=None):
    """A JAX eval model whose transmitters and receiver input stage (LS
    estimate) run as jitted programs (op by op, JAX compiles each of the
    LDPC encoder's many small ops on the first call, which takes several
    times longer): those of `like`, another model of the same
    configuration (compiled once for both), or its own."""
    if like is None:
        jm.transmitters = [Jitted(tx) for tx in jm.transmitters]
        jm.receiver._prepare_inputs = jax.jit(jm.receiver._prepare_inputs,
                                              static_argnames="slot_idx")
    else:
        jm.transmitters = like.transmitters
        jm.receiver._prepare_inputs = like.receiver._prepare_inputs
    return jm


def jax_eval_model(jp):
    return with_jitted_stages(JaxE2EModel(jp, training=False))


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_cgnn():
    """JAX's receiver runs its CGNN as one jitted program (the same
    function, compiled once per shape instead of op by op)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_neural_rx, "cgnn_apply", jax.jit(
        jax_cgnn_apply, static_argnums=1,
        static_argnames=("num_it", "training", "apply_multiloss", "dtype")))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def var_side(cfg_dir):
    """(JAX model, JAX params, port model, port params) of nrx_rt_var_mcs
    at 4 PRB with the committed weights."""
    jp = JaxParameters(VAR, system="nrx", training=False, config_dir=cfg_dir)
    jparams = load_weights(VAR_PKL)
    p = Parameters(VAR, training=False, config_dir=cfg_dir)
    assert p.resource_grid.num_subcarriers == 48
    return (jax_eval_model(jp), jparams,
            E2EModel(p, device="cpu"),
            {"cgnn": from_jax_numpy(jparams["cgnn"])})


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cgnn_inputs(batch, seed, n_rx=4, t=2):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(batch, 14, 48, 2 * n_rx)).astype(np.float32)
    h = rng.normal(size=(batch, t, 14, 48, 2 * n_rx)).astype(np.float32)
    return y, h


def _both_cgnn(jrx, jparams, rx, params, batch, mask_rows, num_it, seed):
    """(JAX, port) cgnn_apply outputs on the same inputs; the port on the
    route its receiver takes at this batch."""
    y, h = _cgnn_inputs(batch, seed)
    pe = np.asarray(jrx.pe, np.float32)
    mm = np.broadcast_to(np.asarray(mask_rows, np.float32)[None],
                         (batch,) + np.shape(mask_rows)).copy()
    act = np.ones((batch, 2), np.float32)
    want = jax_cgnn_apply(jparams, jrx.cgnn_cfg,
                          *map(jnp.asarray, (y, pe, h, act, mm)),
                          num_it=num_it)
    cfg = dataclasses.replace(rx.cgnn_cfg, fused_iteration=batch > 4)
    got = cgnn_apply(params, cfg, *map(torch.as_tensor, (y, pe, h, act, mm)),
                     num_it=num_it)
    return want, got


@pytest.mark.parametrize("num_it", [1, 2])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("batch", [2, 6])
def test_cgnn_apply_var_mcs_matches_jax(var_side, batch, mask, num_it):
    jm, jparams, model, params = var_side
    want, got = _both_cgnn(jm.receiver, jparams["cgnn"], model.receiver,
                           params["cgnn"], batch, MASKS[mask], num_it,
                           seed=batch + num_it)
    assert len(got[0]) == len(want[0]) == 1 and len(got[0][0]) == 2
    for g, w in zip(got[0][0] + [got[1][0]], want[0][0] + [want[1][0]]):
        assert g.shape == w.shape
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-4


@pytest.fixture(scope="module")
def masking_side(cfg_dir):
    jp = JaxParameters(MASKING, system="nrx", training=False,
                       config_dir=cfg_dir)
    jrx = _jax_receiver(jp)
    jparams = jax.jit(lambda k: jax_init_cgnn_params(k, jrx.cgnn_cfg))(
        jax.random.PRNGKey(2))
    rx = receiver_for(Parameters(MASKING, training=False, config_dir=cfg_dir),
                      device="cpu")
    return jrx, jparams, rx, from_jax_numpy(jparams)


@pytest.mark.parametrize("num_it", [2, 8])
@pytest.mark.parametrize("mcs", [0, 1, 2])
def test_cgnn_apply_masking_matches_jax(masking_side, mcs, num_it):
    """One shared init stack (no mask product) and the single readout cut
    to each MCS's 2, 4 and 6 bits."""
    jrx, jparams, rx, params = masking_side
    rows = [[float(i == mcs) for i in range(3)]] * 2
    want, got = _both_cgnn(jrx, jparams, rx, params, 2, rows, num_it,
                           seed=10 + mcs)
    assert [g.shape[-1] for g in got[0][0]] == [2, 4, 6]
    for g, w in zip(got[0][0] + [got[1][0]], want[0][0] + [want[1][0]]):
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-4


def _jax_cgnn_config(name):
    """The CGNNConfig the JAX receiver builds for a configuration, from the
    parsed file alone."""
    jp = JaxParameters(name, system="dummy", training=True)
    return JaxCGNNConfig(
        num_bits_per_symbol=tuple(jax_mcs_to_qm_rate(m, jp.mcs_table)[0]
                                  for m in jp.mcs_index),
        num_rx_ant=jp.num_rx_antennas, num_it=jp.num_nrx_iter, d_s=jp.d_s,
        num_units_init=tuple(jp.num_units_init),
        num_units_agg=tuple(tuple(u) for u in jp.num_units_agg),
        num_units_state=tuple(tuple(u) for u in jp.num_units_state),
        num_units_readout=tuple(jp.num_units_readout),
        layer_type_conv=jp.layer_type_conv,
        var_mcs_masking=jp.mcs_var_mcs_masking,
        initial_chest=jp.initial_chest in ("ls", "nn"))


@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_init_cgnn_params_tree_as_jax(name):
    """Tree, leaf names and shapes of JAX's init for every configuration;
    glorot-uniform kernels inside their limit, zero biases; the draw
    follows the generator's seed."""
    jcfg = _jax_cgnn_config(name)
    want = jax.eval_shape(lambda k: jax_init_cgnn_params(k, jcfg),
                          jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten(want).items()}
    rx = receiver_for(Parameters(name, training=True), device="cpu")
    tree = rx.init_params(torch.Generator().manual_seed(1))["cgnn"]
    got = flatten(tree)
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    for k, v in got.items():
        assert v.dtype == torch.float32
        if k.endswith(".b"):
            assert not v.any()
        else:
            shape = v.shape
            fan = ((9, 9) if k.endswith(".dw") else
                   (9 * shape[2], 9 * shape[3]) if len(shape) == 4 else
                   tuple(shape))
            limit = np.sqrt(6.0 / sum(fan))
            assert float(v.abs().max()) <= limit and float(v.std()) > 0
    again = flatten(rx.init_params(torch.Generator().manual_seed(1))["cgnn"])
    other = flatten(rx.init_params(torch.Generator().manual_seed(2))["cgnn"])
    key = "iterations.0.agg.out.w"
    assert torch.equal(again[key], got[key])
    assert not torch.equal(other[key], got[key])
    if name == "nrx_rt":
        assert count_params(tree) == 142_922


@pytest.mark.parametrize("mcs", [0, 1])
def test_noise_variance_of_evaluated_mcs_as_jax(var_side, mcs):
    jm, _, model, _ = var_side
    for ebno in (-1.0, 2.0, 5.5):
        want = float(np.asarray(jm._noise_variance(np.float32(ebno), mcs)))
        assert model.p.noise_variance(ebno, mcs) == pytest.approx(
            want, rel=1e-6)
    assert model.p.noise_variance(2.0, 1) != model.p.noise_variance(2.0, 0)


def _jax_draws(jm, key, order, batch=BATCH, ebno=EBNO_DB, fold=True):
    """The bits (one per evaluated MCS), CFRs and noise a JAX eval model
    draws from key (as one jitted program). The model's channel then
    reuses these CFRs, so its call does not draw them op by op again."""
    p = jm.p
    rg = p.transmitters[0].resource_grid
    nsym, nsc = rg.num_ofdm_symbols, rg.num_subcarriers
    no = jm._noise_variance(np.float32(ebno), order[0])

    @jax.jit
    def draws(key):
        keys = jax.random.split(key, 8)
        bits = [jax_binary_source(
            jax.random.fold_in(keys[1], i) if fold else keys[1],
            (batch, p.max_num_tx, p.transmitters[idx].tb_size))
            for i, idx in enumerate(order)]
        kc, kn = jax.random.split(keys[4])
        h = p.channel_model(kc, batch, nsym, nsc,
                            p.carrier.subcarrier_spacing)
        noise = jax_complex_awgn(kn, (batch, p.num_rx_antennas, nsym, nsc),
                                 no)
        return bits, h, noise

    bits, h, noise = draws(key)

    def channel(k, batch_size, x, no_):
        """JAX `E2EModel._channel` (DoubleTDL) with the CFRs drawn above."""
        return jax_apply_ofdm_channel(jax.random.split(k)[1], x, h, no_), h

    jm._channel = channel
    return ([torch.as_tensor(np.array(b)) for b in bits],
            torch.as_tensor(np.array(h)), torch.as_tensor(np.array(noise)))


def _oracle_tb_decode_fast(cfg, llr, num_iter=20):
    """JAX tb_decode with the NumPy oracle of the layered kernel."""
    def decoder(full):
        full = np.asarray(full)
        flat = full.reshape(-1, cfg.code.n_full)
        return jnp.asarray(np.stack([
            jax_k5.reference_layered_decode(cfg.code, row, num_iter)
            for row in flat]).reshape(full.shape))
    return jax_tb_decode(cfg, llr, decoder=decoder)


def jax_call_both_decoders(module, call):
    """{fast_ldpc: (b, b_hat, crc)} of one JAX eval call (flooding) whose
    per-user decode, `module.tb_decode`, also runs the oracle on the same
    LLRs (the oracle's blocks stacked user after user: [b, T, tb])."""
    fast = []

    def both(cfg, llr):
        fast.append([np.asarray(a) for a in _oracle_tb_decode_fast(cfg, llr)])
        return jax_tb_decode(cfg, llr)

    mp = pytest.MonkeyPatch()
    mp.setattr(module, "tb_decode", both)
    try:
        b, b_hat, crc = [np.asarray(a) for a in call()]
    finally:
        mp.undo()
    return {False: (b, b_hat, crc),
            True: (b, np.stack([x for x, _ in fast], 1),
                   np.stack([c for _, c in fast], 1))}


def counters(b, b_hat):
    errs = (np.asarray(b) != np.asarray(b_hat)).sum(axis=-1)
    return int(errs.sum()), int((errs > 0).sum())


def assert_parity(want, got, fast):
    """b and crc equal, b_hat equal where the CRC passes, block counters
    equal, and bit counters too with the flooding decoder."""
    (jb, jbh, jcrc), (b, b_hat, crc) = want[fast], got[fast]
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(crc, jcrc)
    ok = np.asarray(crc, bool)
    np.testing.assert_array_equal(np.asarray(b_hat)[ok], np.asarray(jbh)[ok])
    c, jc = counters(b, b_hat), counters(jb, jbh)
    assert c[1] == jc[1]
    if not fast:
        assert c == jc


@pytest.fixture(scope="module")
def nrx_parity(var_side):
    """{mcs: (JAX {fast: outputs}, port {fast: outputs})} of the neural
    E2E model with every user on MCS mcs."""
    jm, jparams, model, params = var_side
    out = {}
    for mcs in (0, 1):
        key = jax.random.PRNGKey(PARITY_SEED + mcs)
        bits, h, noise = _jax_draws(jm, key, [mcs])
        port = {fast: [a.numpy() for a in model.forward(
            params, bits, h, noise, fast_ldpc=fast, mcs_arr_eval_idx=mcs)]
            for fast in (False, True)}
        out[mcs] = (jax_call_both_decoders(
            jax_neural_rx, lambda: jm(jparams, key, BATCH,
                                      np.float32(EBNO_DB),
                                      mcs_arr_eval_idx=mcs)), port)
    return out


@pytest.mark.parametrize("fast", [False, True], ids=["flooding", "layered"])
@pytest.mark.parametrize("mcs", [0, 1])
def test_e2e_on_each_mcs_matches_jax(nrx_parity, mcs, fast):
    want, got = nrx_parity[mcs]
    assert got[fast][1].shape[-1] == want[fast][1].shape[-1]
    assert_parity(want, got, fast)


@pytest.fixture(scope="module")
def baseline_parity(cfg_dir, var_side):
    """JAX's and the port's LS/lin + LMMSE baseline on MCS 1; JAX's
    detection stages as jitted programs."""
    jp = JaxParameters(VAR, system="baseline_lslin_lmmse", training=False,
                       config_dir=cfg_dir)
    jm = with_jitted_stages(jax_baseline_e2e.BaselineE2EModel(
        jp, system="baseline_lslin_lmmse"), var_side[0])
    jm._estimate = jax.jit(jm._estimate)
    p = Parameters(VAR, system="baseline_lslin_lmmse", training=False,
                   config_dir=cfg_dir)
    model = BaselineE2EModel(p, "baseline_lslin_lmmse", device="cpu")
    key = jax.random.PRNGKey(PARITY_SEED)
    (bits,), h, noise = _jax_draws(jm, key, [1], fold=False)
    no = p.noise_variance(EBNO_DB, 1)
    port = {fast: [a.numpy() for a in model.forward(
        {}, bits, h, noise, no, fast_ldpc=fast, mcs_arr_eval_idx=1)]
        for fast in (False, True)}
    mp = pytest.MonkeyPatch()
    for name in ("lmmse_equalize", "demap_maxlog"):
        mp.setattr(jax_baseline_e2e, name,
                   jax.jit(getattr(jax_baseline_e2e, name)))
    try:
        want = jax_call_both_decoders(
            jax_baseline_e2e, lambda: jm({}, key, BATCH, np.float32(EBNO_DB),
                                         mcs_arr_eval_idx=1))
    finally:
        mp.undo()
    return want, port


@pytest.mark.parametrize("fast", [False, True], ids=["flooding", "layered"])
def test_baseline_on_mcs1_matches_jax(baseline_parity, fast):
    want, got = baseline_parity
    assert got[fast][1].shape[-1] == want[fast][1].shape[-1]
    assert_parity(want, got, fast)


def test_sim_ber_on_mcs1_and_results_read_by_jax(var_side, tmp_path):
    _, _, model, params = var_side
    ber, bler = simber.sim_ber(model, params, [EBNO_DB], 2, max_mc_iter=1,
                               mcs_arr_eval_idx=1, verbose=False,
                               fast_ldpc=True)
    path = str(tmp_path / "r.pkl")
    simber.save_results(path, VAR, "Neural Receiver", 2, 1, [EBNO_DB], ber,
                        bler)
    ebno, jber, jbler = jax_metrics.load_results(path)
    np.testing.assert_array_equal(ebno, [EBNO_DB])
    assert list(jbler) == [("Neural Receiver", 2, 1)]
    assert jbler[("Neural Receiver", 2, 1)][0] == bler[0]
    step = simber.make_eval_step(model, fast_ldpc=True, mcs_arr_eval_idx=1)
    counts = step(params, torch.Generator().manual_seed(0), 1, EBNO_DB)
    assert counts[1] == 2 * model.transmitters[1].tb_size != \
        2 * model.transmitters[0].tb_size


def test_apply_cuts_iterations_and_refuses_unknown_mcs(var_side):
    _, _, model, params = var_side
    rx = model.receiver
    (bits,), h, noise = model.draw(torch.Generator().manual_seed(3), 1, 8.0,
                                   [1])
    x = model.transmit([bits], [1], mcs_mask((1, 2), 1, 2, "cpu"))
    y = torch.einsum("batpsc,btpsc->basc", h, x) + noise
    act = torch.ones((1, 2))
    for num_it in (1, 2):
        b_hat, h_hat, _, crc = rx.apply(params, y, act, mcs_arr_eval=(1,),
                                        num_it=num_it, fast_ldpc=True)
        assert b_hat.shape == bits.shape and h_hat.shape[-1] == 8
    for kwargs in ({"mcs_arr_eval": (2,)}, {"num_it": 3}, {"num_it": 0}):
        with pytest.raises(ValueError):
            rx.apply(params, y, act, **kwargs)


def test_evaluate_cli_mcs1_on_cpu_writes_a_pickle_jax_reads(tmp_path):
    port_cli.main(["--config", VAR, "--mcs-idx", "1", "--snr", "3",
                   "--max-iter", "1", "--batch-size", "1", "--fast-ldpc",
                   "--device", "cpu", "--results-dir", str(tmp_path)])
    ebno, ber, bler = jax_metrics.load_results(
        str(tmp_path / f"{VAR}_results.pkl"))
    np.testing.assert_array_equal(ebno, [3.0])
    assert list(bler) == [("Neural Receiver", 2, 1)]
    assert 0.0 <= bler[("Neural Receiver", 2, 1)][0] <= 1.0
    with pytest.raises(ValueError, match="out of range"):
        port_cli.main(["--config", VAR, "--mcs-idx", "2", "--device", "cpu"])


def test_mc_entry_on_mcs1_on_cpu():
    """mc_entry of nrx_rt_var_mcs on MCS 1 at 132 PRB, batch 1, one
    iteration: 16-QAM's transport blocks are counted."""
    fn, args = port_entry.mc_entry(device="cpu", batch=1, ebno_db=20.0,
                                   config=VAR, mcs_idx=1, num_it=1)
    counts = fn(*args)
    p = Parameters(VAR)
    assert counts[3] == 2 and counts[1] == 2 * p.transmitters[1].tb_size
