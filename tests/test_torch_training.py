"""The PyTorch port's training path against the JAX package.

- The training forward given JAX's draws (`neural_rx_tpu/sim/e2e.py`'s key
  schedule in training: bits of MCS i from `fold_in(keys[1], i)`, the pilot
  slot from `randint(keys[2])`, the channel from `split(keys[4])[0]`, the
  noise from `split(keys[4])[1]` at one N0 per item), with JAX's seed-made
  parameters, on nrx_rt (UMi, 2 users, one inactive), nrx_rt_var_mcs (UMi,
  users on different MCS, multiloss) and e2e_rt (TDL-C300, the trainable
  constellation, masked pilots, no LS estimate), at the training width (4
  PRB), batch 2, and on nrx_rt with a 0.5 ppm frequency offset drawn per
  user (`uniform(keys[3])`): loss_data and loss_chest within 1e-5 relative,
  and the
  gradient of loss_data + 0.02 loss_chest for every leaf, the
  constellation's included, within 1e-4 of max |JAX grad| of the leaf.
- One Adam step on equal gradients equals `optax.adam`'s within 1e-6.
- The samplers at the statistics of tests/test_training.py; the masked-pilot
  noise variance per item equals JAX's; `merge_matching_leaves` copies what
  tests/test_warm_start.py says.
- Weights saved and loaded round trip, into `cli/evaluate.py`'s loader;
  checkpoints round trip; `cli/train.py --smoke --device cpu`; the training
  step never takes a kernel route.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_rx_tpu.phy.misc import binary_source as jax_binary_source
from neural_rx_tpu.phy.misc import complex_awgn as jax_complex_awgn
from neural_rx_tpu.rx import neural_rx as jax_neural_rx
from neural_rx_tpu.rx.cgnn import cgnn_apply as jax_cgnn_apply
from neural_rx_tpu.sim import training as jax_training
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu.sim.e2e import E2EModel as JaxE2EModel
from neural_rx_tpu_torch import entry, weights
from neural_rx_tpu_torch.cli import evaluate as cli_evaluate
from neural_rx_tpu_torch.cli import train as cli_train
from neural_rx_tpu_torch.kernels import cgnn_iter, sepconv
from neural_rx_tpu_torch.sim import training
from neural_rx_tpu_torch.sim.config import Parameters
from neural_rx_tpu_torch.sim.e2e import E2EModel, sample_active_dmrs

BATCH = 2
LOSS_BAR = 1e-5
GRAD_BAR = 1e-4
WEIGHTING = 0.02  # nrx_rt's phase-0 double-readout weight
# (config, Eb/N0 per item, active ports, MCS mask rows per item, multiloss,
# overrides)
CASES = {
    "nrx_rt": ("nrx_rt", [3.0, 9.0], [[1, 1], [1, 0]],
               [[[1], [1]], [[1], [1]]], False, {}),
    "nrx_rt_var_mcs": ("nrx_rt_var_mcs", [2.0, 6.0], [[1, 1], [0, 1]],
                       [[[1, 0], [0, 1]], [[0, 1], [1, 0]]], True, {}),
    "e2e_rt": ("e2e_rt", [3.5, 3.5], [[1], [1]], [[[1]], [[1]]], False, {}),
    # a carrier frequency offset drawn per user in training (every shipped
    # configuration sets 0 ppm)
    "nrx_rt_cfo": ("nrx_rt", [6.0, 6.0], [[1, 1], [1, 1]],
                   [[[1], [1]], [[1], [1]]], False,
                   {"cfo_offset_ppm": 0.5}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch in one thread: the suite runs one worker per core or so."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_cgnn():
    """JAX's receiver runs its CGNN as one jitted program."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_neural_rx, "cgnn_apply", jax.jit(
        jax_cgnn_apply, static_argnums=1,
        static_argnames=("num_it", "training", "apply_multiloss", "dtype")))
    yield
    mp.undo()


def jax_training_draws(jm, key, batch, ebno):
    """The draws JAX's training `E2EModel.__call__` makes from `key`: (bits
    per MCS, slot, CFR, noise, frequency offsets or None)."""
    p = jm.p
    keys = jax.random.split(key, 8)
    bits = [jax_binary_source(jax.random.fold_in(keys[1], i),
                              (batch, p.max_num_tx, tx.tb_size))
            for i, tx in enumerate(jm.transmitters)]
    slot = jax.random.randint(keys[2], (), 0, jm._num_slots)
    rg = jm.transmitters[0].resource_grid
    nsym, nsc = rg.num_ofdm_symbols, rg.num_subcarriers
    scs = p.carrier.subcarrier_spacing
    kc, kn = jax.random.split(keys[4])
    if p.channel_type_name in ("TDL-B100", "TDL-C300"):
        h = jnp.stack([p.channel_model(k, batch, nsym, nsc, scs)
                       for k in jax.random.split(kc, p.max_num_tx)], axis=2)
    else:
        h = p.channel_model(kc, batch, p.max_num_tx, nsym, nsc, scs)
    no = jm._noise_variance(ebno, 0)
    noise = jax_complex_awgn(kn, (batch, p.num_rx_antennas, nsym, nsc),
                             no.reshape(batch, 1, 1, 1))
    fo = None
    cfo = p.frequency_offset
    if cfo is not None:
        fo = jax.random.uniform(
            keys[3], (batch, p.max_num_tx, 1, 1), minval=cfo.min_rel_offset,
            maxval=max(cfo.max_rel_offset, cfo.min_rel_offset + 1e-30))
    return bits, slot, h, noise, fo


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v) for v in tree]
    return torch.tensor(np.asarray(tree))


class Side:
    """JAX's and the port's training models of one case, JAX's seed-made
    parameters, JAX's draws, losses and gradients."""

    def __init__(self, name):
        label, ebno, active, mask, multiloss, overrides = CASES[name]
        self.multiloss = multiloss
        jp = JaxParameters(label, system="nrx", training=True,
                           overrides=overrides)
        self.jm = JaxE2EModel(jp, training=True)
        self.jparams = self.jm.init_params(jax.random.PRNGKey(0))
        self.p = Parameters(label, training=True, overrides=overrides)
        self.model = E2EModel(self.p, training=True, device="cpu")
        self.ebno = np.asarray(ebno, np.float32)
        self.active = np.asarray(active, np.float32)
        self.mask = np.asarray(mask, np.float32)
        key = jax.random.PRNGKey(7)
        jm = self.jm

        def loss(params):
            ld, lc = jm(params, key, BATCH, jnp.asarray(self.ebno),
                        num_tx=jp.max_num_tx,
                        active_dmrs=jnp.asarray(self.active),
                        mcs_ue_mask=jnp.asarray(self.mask),
                        apply_multiloss=multiloss)
            return ld + WEIGHTING * lc, (ld, lc)

        def run(params):  # one program for the gradients and the draws
            return (jax.value_and_grad(loss, has_aux=True)(params),
                    jax_training_draws(jm, key, BATCH,
                                       jnp.asarray(self.ebno)))

        ((_, (ld, lc)), grads), self.draws = jax.jit(run)(self.jparams)
        self.want = (float(ld), float(lc))
        self.jgrads = weights.flatten(jax.tree.map(np.asarray, grads))

    def port_params(self):
        return training.trainable(to_torch(self.jparams))

    def port_forward(self, params):
        bits, slot, h, noise, fo = self.draws
        return self.model.forward(
            params, [to_torch(b) for b in bits], to_torch(h),
            to_torch(noise), active_dmrs=torch.tensor(self.active),
            mcs_ue_mask=torch.tensor(self.mask), slot_idx=int(slot),
            fo=None if fo is None else to_torch(fo),
            apply_multiloss=self.multiloss)


_SIDES = {}


def side(name):
    if name not in _SIDES:
        _SIDES[name] = Side(name)
    return _SIDES[name]


@pytest.mark.parametrize("name", list(CASES))
def test_training_losses_and_gradients_match_jax(name):
    s = side(name)
    params = s.port_params()
    ld, lc = s.port_forward(params)
    assert np.isfinite(s.want).all()
    np.testing.assert_allclose([ld.item(), lc.item()], s.want, rtol=LOSS_BAR,
                               atol=0)
    (ld + WEIGHTING * lc).backward()
    got = {k: v.grad for k, v in weights.flatten(params).items()}
    assert got.keys() == s.jgrads.keys()
    if s.p.custom_constellation:
        assert "constellation.0" in got
    for k, g in got.items():
        want = s.jgrads[k]
        assert g is not None and g.shape == want.shape, k
        scale = np.abs(want).max()
        err = np.abs(g.numpy() - want).max()
        # with one user the aggregation MLP's gradient is exactly zero
        assert err <= GRAD_BAR * scale if scale > 0 else err == 0.0, (
            k, err, scale)


def test_training_step_takes_no_kernel_route(monkeypatch):
    """Whatever the route flags say, the training forward runs the plain
    layers: every kernel wrapper and plain kernel version raises here."""
    def refuse(*a, **k):
        raise AssertionError("a kernel route in training")
    for mod, names in ((sepconv, ("fused_conv_stack",)),
                       (cgnn_iter, ("fused_iteration", "fused_cgnn_full",
                                    "fused_iteration_reference",
                                    "fused_cgnn_full_reference"))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)
    s = side("nrx_rt")
    rx = s.model.receiver
    for flags in ({"fused_iteration": True, "fused_readout": True},
                  {"fused_full": True}):
        monkeypatch.setattr(rx, "cgnn_cfg", rx.cgnn_cfg.__class__(
            **{**rx.cgnn_cfg.__dict__, **flags}))
        ld, lc = s.port_forward(s.port_params())
        np.testing.assert_allclose([ld.item(), lc.item()], s.want,
                                   rtol=LOSS_BAR)


def test_adam_step_equals_optax():
    s = side("e2e_rt")
    params = s.port_params()
    opt = training.make_adam(params, 1e-3)
    jopt = optax.adam(1e-3)
    jparams = s.jparams
    jstate = jopt.init(jparams)
    update = jax.jit(jopt.update)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: rng.normal(size=np.shape(x)).astype(np.float32),
            jparams)
        flat = weights.flatten(grads)
        for k, v in weights.flatten(params).items():
            v.grad = torch.tensor(flat[k])
        opt.step()
        updates, jstate = update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    want = weights.flatten(jax.tree.map(np.asarray, jparams))
    for k, v in weights.flatten(params).items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=0,
                                   atol=1e-6, err_msg=k)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_triangular_sample_biased_to_the_maximum():
    g = _gen(0)
    xs = np.asarray([int(training.triangular_sample(g, 1, 2))
                     for _ in range(400)])
    assert set(xs) <= {1, 2}
    assert (xs == 2).mean() > 0.6


def test_mcs_assignment_uniform_and_by_probabilities():
    _, mask = training.sample_mcs_assignment(_gen(1), 64, 2, [0, 1], 2)
    m = mask.numpy()
    assert m.shape == (64, 2, 2)
    np.testing.assert_allclose(m.sum(-1), 1.0)
    assert 0.3 < m[..., 0].mean() < 0.7
    _, mask = training.sample_mcs_assignment(
        _gen(2), 256, 2, [0, 1], 2, num_tx=torch.tensor(2), min_num_tx=1,
        mcs_training_probs=[[0.5, 0.5], [0.9, 0.1]])
    assert float(mask[..., 0].mean()) > 0.8


def test_active_dmrs_has_num_tx_active_ports():
    act = sample_active_dmrs(_gen(3), 500, torch.tensor(1), 2).numpy()
    np.testing.assert_array_equal(act.sum(1), 1.0)
    assert 0.4 < act[:, 0].mean() < 0.6


def test_step_sampling_statistics():
    """One step's sampling on nrx_rt_var_mcs: the per-MCS Eb/N0 offsets of
    the active users, indexed by the user count (0 dB on MCS 0; on MCS 1 4 dB
    with 1 user, 2 dB with 2), added to the phase's Eb/N0."""
    s = side("nrx_rt_var_mcs")
    step = training.make_step(s.model, s.p, None, [0, 1], 512, True, 0.02,
                              False, False)
    step.set_snr_range([1.0, 1.0], [1.0, 1.0])
    g = _gen(4)
    for _ in range(3):
        snr, active, mm = step.sample(g)
        n_act = int(active[0].sum())
        off = {1: (0.0, 4.0), 2: (0.0, 2.0)}[n_act]
        want = 1.0 + (torch.tensor(off)[mm.argmax(-1)] * active).sum(1)
        np.testing.assert_allclose(snr.numpy(), want.numpy(), rtol=1e-6)


def test_masked_pilot_noise_variance_per_item_as_jax():
    s = side("e2e_rt")
    ebno = np.asarray([0.0, 3.5, 7.0], np.float32)
    got = s.p.noise_variance(torch.tensor(ebno))
    want = np.asarray(s.jm._noise_variance(jnp.asarray(ebno), 0))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_merge_matching_leaves_as_warm_start():
    gen = _gen(5)
    src = E2EModel(Parameters("nrx_rt", training=True), training=True,
                   device="cpu").init_params(gen)
    n = len(weights.flatten(src))
    zeros = {k: torch.zeros_like(v) for k, v in weights.flatten(src).items()}
    merged, copied, kept = training.merge_matching_leaves(
        weights.unflatten(zeros), src)
    assert (copied, kept) == (n, 0)
    for k, v in weights.flatten(merged).items():
        assert torch.equal(v, weights.flatten(src)[k])
    dst = E2EModel(Parameters("nrx_rt_qpsk", training=True), training=True,
                   device="cpu").init_params(gen)
    merged, copied, kept = training.merge_matching_leaves(dst, src)
    assert (copied, kept) == (n - 2, 2)
    fm, fs = weights.flatten(merged), weights.flatten(src)
    for k in fm:
        if "readout_llrs" not in k:
            assert torch.equal(fm[k], fs[k]), k
    assert fm["cgnn.readout_llrs.0.out.w"].shape[-1] == 2


def test_weights_round_trip_into_the_evaluate_loader(tmp_path):
    s = side("e2e_rt")
    params = s.port_params()
    path = str(tmp_path / "w.npz")
    written = training.save_weights(path, params)
    # e2e_rt's tree (with its constellation) is over weights.PART_LIMIT
    assert written == [weights.part_path(path, i) for i in range(2)]
    back = training.load_weights(path)
    loaded = entry.load_params(dtype=torch.float32, device="cpu", path=path)
    flat = weights.flatten(params)
    assert weights.flatten(back).keys() == flat.keys()
    for k, v in weights.flatten(back).items():
        assert torch.equal(v, flat[k].detach()), k
    assert torch.equal(loaded["constellation"][0], flat["constellation.0"])
    names = set()
    for part in written:
        with np.load(part) as f:
            names |= set(f.files)
    assert "s_init.0.hidden.0.dw" in names
    assert "constellation.0" in names


def test_checkpoint_round_trip(tmp_path):
    s = side("nrx_rt")
    params = s.port_params()
    opt = training.make_adam(params, 1e-3)
    ld, lc = s.port_forward(params)
    (ld + lc).backward()
    opt.step()
    path = str(tmp_path / "ck.pt")
    training.save_checkpoint(path, params, opt, 17)
    back, state, step = training.load_checkpoint(path)
    assert step == 17
    for k, v in weights.flatten(back).items():
        assert torch.equal(v, weights.flatten(params)[k].detach()), k
    opt2 = training.make_adam(training.trainable(back), 1e-3)
    opt2.load_state_dict(state)
    assert opt2.state_dict()["state"][0]["step"] == 1


def test_train_cli_smoke_on_cpu_and_evaluate_loads_its_weights(tmp_path):
    wdir, ldir = str(tmp_path / "w"), str(tmp_path / "logs")
    cli_train.main(["--config", "nrx_rt", "--smoke", "--device", "cpu",
                    "--iters", "20", "--weights-dir", wdir, "--log-dir",
                    ldir, "--seed", "1"])
    path = os.path.join(wdir, "nrx_rt_smoke_weights.npz")
    assert os.path.exists(path)
    assert os.path.exists(os.path.join(wdir, "nrx_rt_smoke_ckpt.pt"))
    assert os.path.exists(os.path.join(ldir, "nrx_rt_smoke.jsonl"))
    cli_train.main(["--config", "nrx_rt", "--smoke", "--device", "cpu",
                    "--iters", "10", "--weights-dir", wdir, "--log-dir",
                    ldir, "--warm-start", path])
    cli_evaluate.main(["--config", "nrx_rt", "--weights", path, "--snr",
                       "8", "--max-iter", "1", "--batch-size", "1",
                       "--fast-ldpc", "--device", "cpu", "--results-dir",
                       str(tmp_path / "r")])
    assert os.path.exists(str(tmp_path / "r" / "nrx_rt_results.pkl"))


def test_training_loop_phases_log_and_snapshots(tmp_path):
    """Two phases, a fresh Adam each, one log line a chunk, the named
    snapshot and the final weights."""
    p = Parameters("nrx_rt", training=True, overrides={"channel_type":
                                                       "AWGN"})
    p.training_schedule = dict(p.training_schedule, num_iter=[4, 4],
                               batch_size=[2, 2])
    model = E2EModel(p, training=True, device="cpu")
    params = model.init_params(_gen(6))
    out = training.training_loop(
        model, p, params, "t", results_dir=str(tmp_path),
        log_dir=str(tmp_path), chunk=2, verbose=False,
        weight_saving_schedule=[3])
    with open(tmp_path / "t.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["phase"] for r in recs] == [0, 0, 1, 1]
    assert [r["iter"] for r in recs] == [2, 4, 6, 8]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert os.path.exists(tmp_path / "t_weights_iter_3.npz")
    back = training.load_weights(str(tmp_path / "t_weights.npz"))
    for k, v in weights.flatten(back).items():
        assert torch.equal(v, weights.flatten(out)[k].detach()), k


def test_leaf_names_cover_the_jax_tree():
    """The port's `.npz` and checkpoints name leaves by `weights.flatten`
    (the JAX tree's paths; JAX's pickles hold a PyTreeDef instead): one name
    per leaf of JAX's seed-made training parameters, and JAX's
    `merge_matching_leaves` of a tree onto itself copies as many."""
    jp = JaxParameters("nrx_rt", system="nrx", training=True)
    jparams = JaxE2EModel(jp, training=True).init_params(
        jax.random.PRNGKey(0))
    names = weights.flatten(jax.tree.map(np.asarray, jparams))
    assert len(names) == len(jax.tree.leaves(jparams))
    assert jax_training.merge_matching_leaves(jparams, jparams)[1] == len(
        names)


def test_e2e_rt_eval_given_jax_draws_matches_jax(tmp_path):
    """e2e_rt at eval (the learned constellation at the transmitter, no
    pilot energy, a CGNN without the LS estimate), its eval grid cut to 4
    PRB, JAX's seed-made parameters with the constellation moved off QAM,
    JAX's draws (bits from `fold_in(keys[1], 0)`, the TDL-B100 channel per
    user from `split(split(keys[4])[0])`, the noise from
    `split(keys[4])[1]`): the refined channel estimate within 1e-4 of max
    |JAX|, the true channel, bits and CRC equal."""
    from neural_rx_tpu_torch.sim.config import CONFIG_DIR
    with open(os.path.join(CONFIG_DIR, "e2e_rt.cfg")) as f:
        text = f.read()
    assert "n_size_bwp_eval = 132\n" in text
    (tmp_path / "e2e_rt.cfg").write_text(
        text.replace("n_size_bwp_eval = 132\n", "n_size_bwp_eval = 4\n"))
    jp = JaxParameters("e2e_rt", system="nrx", training=False,
                       config_dir=str(tmp_path))
    jm = JaxE2EModel(jp, training=False)
    jparams = jm.init_params(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    jparams["constellation"] = [
        c + 0.05 * rng.normal(size=np.shape(c)).astype(np.float32)
        for c in jparams["constellation"]]
    key = jax.random.PRNGKey(3)
    ebno = 6.0
    want = jm(jparams, key, BATCH, ebno, output_nrx_h_hat=True)
    keys = jax.random.split(key, 8)
    bits = jax_binary_source(jax.random.fold_in(keys[1], 0),
                             (BATCH, 1, jm.transmitters[0].tb_size))
    kc, kn = jax.random.split(keys[4])
    rg = jm.transmitters[0].resource_grid
    h = jnp.stack([jp.channel_model(k, BATCH, 14, rg.num_subcarriers,
                                    jp.carrier.subcarrier_spacing)
                   for k in jax.random.split(kc, 1)], axis=2)
    noise = jax_complex_awgn(kn, (BATCH, 4, 14, rg.num_subcarriers),
                             jm._noise_variance(ebno, 0))
    p = Parameters("e2e_rt", training=False, config_dir=str(tmp_path))
    model = E2EModel(p, device="cpu")
    got = model.forward(to_torch(jparams), to_torch(bits), to_torch(h),
                        to_torch(noise), output_nrx_h_hat=True)
    b, _, crc, h_true, h_ref, h_init = got
    assert h_init is None and want[5] is None
    np.testing.assert_array_equal(b.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(crc.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(h_true.numpy(), np.asarray(want[3]),
                               rtol=0, atol=1e-6)
    jh = np.asarray(want[4])
    assert np.abs(h_ref.numpy() - jh).max() <= 1e-4 * np.abs(jh).max()


def test_eval_loss_monitor_and_train_entry():
    p = Parameters("nrx_rt", training=True,
                   overrides={"channel_type": "AWGN"})
    model = E2EModel(p, training=True, device="cpu")
    params = training.trainable(model.init_params(_gen(7)))
    out = training.make_eval_loss_fn(model, p, batch_size=2)(params,
                                                              _gen(8))
    assert list(out) == ["eval_loss_mcs0"] and np.isfinite(
        out["eval_loss_mcs0"])
    fn, (params, gen) = entry.train_entry("e2e_rt", device="cpu", batch=2)
    before = {k: v.detach().clone()
              for k, v in weights.flatten(params).items()}
    losses = fn(params, gen)
    assert all(np.isfinite(float(x)) for x in losses)
    for k, v in weights.flatten(params).items():
        assert not torch.equal(v.detach(), before[k]) or "agg" in k, k


def test_masking_cgnn_training_readouts_and_gradients_match_jax():
    """`cgnn_apply(training=True, apply_multiloss=True)` of
    nrx_large_var_mcs_64qam_masking (one shared init stack and readout cut
    to each of its 3 MCS's bits), JAX's seed-made parameters, the first 2
    of its 8 iterations, users on different MCS, one inactive: every
    readout point's LLRs and channel readout within 1e-5 of max |JAX|, and
    the gradient of a fixed weighted sum of them within 1e-4 of max |JAX
    grad| per leaf."""
    from neural_rx_tpu.rx.cgnn import init_cgnn_params as jax_init
    from neural_rx_tpu_torch.rx.cgnn import cgnn_apply
    from neural_rx_tpu_torch.rx.neural_rx import receiver_for

    label = "nrx_large_var_mcs_64qam_masking"
    jcfg = JaxE2EModel(JaxParameters(label, system="nrx", training=True),
                       training=True).receiver.cgnn_cfg
    cfg = receiver_for(Parameters(label, training=True),
                       device="cpu").cgnn_cfg
    assert cfg.var_mcs_masking and cfg.num_mcs == 3
    jparams = jax_init(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(9)
    y = rng.normal(size=(1, 14, 48, 8)).astype(np.float32)
    h = rng.normal(size=(1, 2, 14, 48, 8)).astype(np.float32)
    pe = rng.normal(size=(2, 14, 48, 2)).astype(np.float32)
    act = np.asarray([[1.0, 0.0]], np.float32)
    mm = np.asarray([[[0, 1, 0], [0, 0, 1]]], np.float32)
    w_llr = [rng.normal(size=(1, 2, 14, 48, nb)).astype(np.float32)
             for nb in (2, 4, 6)]
    w_h = rng.normal(size=(1, 2, 14, 48, 8)).astype(np.float32)

    def objective(llrs, h_hats, cast):
        total = 0.0
        for per_mcs, hh in zip(llrs, h_hats):
            total = total + sum((llr * cast(w)).mean()
                                for llr, w in zip(per_mcs, w_llr))
            total = total + (hh * cast(w_h)).mean()
        return total

    def jax_fn(params):
        llrs, h_hats = jax_cgnn_apply(params, jcfg, *map(
            jnp.asarray, (y, pe, h, act, mm)), num_it=2, training=True,
            apply_multiloss=True)
        return objective(llrs, h_hats, jnp.asarray), (llrs, h_hats)

    (_, (jllrs, jh)), jgrads = jax.jit(jax.value_and_grad(
        jax_fn, has_aux=True))(jparams)
    params = training.trainable(to_torch(jparams))
    llrs, h_hats = cgnn_apply(params, cfg, *map(torch.tensor, (
        y, pe, h, act, mm)), num_it=2, training=True, apply_multiloss=True)
    assert len(llrs) == len(h_hats) == 2
    for got_it, want_it in zip(llrs, jllrs):
        for got, want in zip(got_it, want_it):
            want = np.asarray(want)
            assert got.shape == want.shape
            assert np.abs(got.detach().numpy() - want).max() <= (
                1e-5 * np.abs(want).max())
    for got, want in zip(h_hats, jh):
        want = np.asarray(want)
        assert np.abs(got.detach().numpy() - want).max() <= (
            1e-5 * np.abs(want).max())
    objective(llrs, h_hats, torch.tensor).backward()
    want = weights.flatten(jax.tree.map(np.asarray, jgrads))
    for k, v in weights.flatten(params).items():
        scale = np.abs(want[k]).max()
        g = v.grad.numpy() if v.grad is not None else np.zeros(v.shape)
        err = np.abs(g - want[k]).max()
        assert err <= GRAD_BAR * scale if scale > 0 else err == 0.0, (
            k, err, scale)
