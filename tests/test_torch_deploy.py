"""The PyTorch port's deploy engine (`neural_rx_tpu_torch/deploy/`) against
the JAX package's (`neural_rx_tpu/deploy/`).

On JAX's `tests/data/test_small.cfg` (the nrx_rt widths: 2 users, 4 rx
antennas, 14 symbols) at 3 and 4 PRB, float32, with JAX's seed-made
parameters whose biases are made nonzero (as
tests/test_bucketed_dispatch.py does, so that bleed into a bucket's padding
would show), carried across by `weights.from_jax_numpy`:

- the static tables equal JAX's `AerialNRX`'s exactly (nn_gather,
  focc_pair, pilot_sc, uniq_pilot_sc, freq_dist, pe, pad_dispatch_exact),
  and the per-symbol `nn_gather_map` equals the brute-force argmin;
- `dynamic_pe` at a padded and at the full width within 1e-6 of JAX's
  `_dynamic_pe`;
- the engine's (llr, h_hat) on inputs from a NumPy seed within 1e-5 of max
  |JAX| (JAX on its plain XLA route, the port on the export's route through
  the kernels' plain versions: the kernels are held against JAX in
  test_torch_{sepconv,cgnn_iter}.py); in bfloat16 within
  test_torch_slice.py's bars, JAX on the export's route (Pallas interpret);
- pad-to-bucket dispatch: 3 PRB in the 4-PRB bucket equals the 3-PRB
  engine's exact bucket bit for bit; the exact bucket passes through; a pilot-count
  mismatch and an engine that is not pad-exact raise ValueError; CPU
  engines refuse graph mode;
- the engine file round-trips; the export CLI runs on the CPU;
- `AerialDataGenerator`'s inputs from JAX's draws (bits, CFRs, noise of its
  key schedule) within 1e-5 of JAX's, and `AerialDataEvaluator`'s coded
  BER and CRC pass rate equal to JAX's on the same LLRs.
"""

import json
import os
import re
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.deploy.aerial import AerialNRX as JaxAerialNRX
from neural_rx_tpu.deploy.data_tools import AerialDataEvaluator as JaxEval
from neural_rx_tpu.deploy.data_tools import AerialDataGenerator as JaxGen
from neural_rx_tpu.phy.misc import binary_source as jax_binary_source
from neural_rx_tpu.phy.misc import complex_awgn as jax_complex_awgn
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu.sim.e2e import E2EModel as JaxE2EModel
from neural_rx_tpu_torch import entry, weights
from neural_rx_tpu_torch.cli import export as cli_export
from neural_rx_tpu_torch.deploy import aerial, aot, data_tools
from neural_rx_tpu_torch.rx.neural_rx import receiver_for
from neural_rx_tpu_torch.sim.config import Parameters
from neural_rx_tpu_torch.sim.e2e import E2EModel

TEST_CFG_DIR = os.path.join(os.path.dirname(__file__), "data")
BATCH = 2
F32_BAR = 1e-5
ROUTE = {"fused_convs": True, "fused_iteration": True}  # the export's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch in one thread: the suite runs one worker per core or so."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params_at(n_prb):
    src = open(os.path.join(TEST_CFG_DIR, "test_small.cfg")).read()
    src = re.sub(r"n_size_bwp_eval = \d+", f"n_size_bwp_eval = {n_prb}",
                 src)
    with tempfile.TemporaryDirectory() as td:
        with open(os.path.join(td, "test_small.cfg"), "w") as f:
            f.write(src)
        p = JaxParameters("test_small", system="nrx", training=False,
                          config_dir=td)
    p.nrx_dtype = jnp.float32
    return p


def _randomize_biases(params, key):
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(treedef, [
        0.5 * jax.random.normal(k, leaf.shape, leaf.dtype)
        if leaf.ndim == 1 else leaf for leaf, k in zip(leaves, keys)])


class Width:
    """JAX's and the port's models and float32 engines at one width."""

    def __init__(self, n_prb):
        self.jm = JaxE2EModel(_jax_params_at(n_prb), training=False)
        jrx = self.jm.receiver
        self.jeng = JaxAerialNRX(jrx.rg, jrx.cgnn_cfg, dtype=jnp.float32)
        self.p = Parameters("test_small", training=False,
                            config_dir=TEST_CFG_DIR,
                            overrides={"n_size_bwp": n_prb})
        self.model = E2EModel(self.p, device="cpu")
        self.cfg = aot.engine_config(self.model.receiver.cgnn_cfg, **ROUTE)
        self.eng = self.engine(torch.float32)

    def engine(self, dtype, tables=None):
        return aerial.AerialNRX(
            tables or aerial.engine_tables(self.model.receiver.rg), self.cfg,
            num_it=self.p.num_nrx_iter_eval, dtype=dtype, device="cpu")


@pytest.fixture(scope="module")
def widths():
    return {n: Width(n) for n in (3, 4)}


@pytest.fixture(scope="module")
def jparams(widths):
    return _randomize_biases(widths[4].jm.init_params(jax.random.PRNGKey(0)),
                             jax.random.PRNGKey(7))


def _port_params(jparams, dtype=torch.float32):
    return entry.pack_params(
        {"cgnn": weights.from_jax_numpy(jax.tree.map(np.asarray,
                                                     jparams["cgnn"]))},
        dtype)


def _inputs(w, seed=0):
    """Seeded normal engine inputs of width w (numpy)."""
    rng = np.random.default_rng(seed)
    sc, ant, t = w.eng.n_sc, 4, w.eng.num_layers
    shapes = [(BATCH, sc, 14, ant)] * 2 + [(BATCH, w.eng.num_pilots, t,
                                            ant)] * 2
    return [rng.normal(size=s).astype(np.float32) for s in shapes] + [
        np.ones((BATCH, t), np.float32)]


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n_prb", [3, 4])
def test_static_tables_equal_jax(widths, n_prb):
    w = widths[n_prb]
    got = aerial.engine_tables(w.model.receiver.rg)
    for name in ("nn_gather", "focc_pair", "pilot_sc", "uniq_pilot_sc",
                 "freq_dist", "pe"):
        want = getattr(w.jeng, name)
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert got["pad_dispatch_exact"] is True
    assert got["pad_dispatch_exact"] == w.jeng.pad_dispatch_exact
    np.testing.assert_array_equal(got["pilot_mask"], w.jeng.rg.pilot_mask)


@pytest.mark.parametrize("n_sym,n_sc,n_pil,seed", [
    (14, 48, 48, 0), (5, 37, 11, 1), (9, 20, 60, 2)])
def test_nn_gather_chunked_equals_brute_force(n_sym, n_sc, n_pil, seed):
    rng = np.random.default_rng(seed)
    ip = rng.integers(0, n_sym, n_pil)
    jp = rng.integers(0, n_sc, n_pil)  # ties and repeats included
    d = (np.abs(np.arange(n_sym)[:, None, None] - ip[None, None])
         + np.abs(np.arange(n_sc)[None, :, None] - jp[None, None]))
    np.testing.assert_array_equal(aerial.nn_gather_map(ip, jp, n_sym, n_sc),
                                  np.argmin(d, -1))


@pytest.mark.parametrize("num_valid_sc", [36, 48])
def test_dynamic_pe_matches_jax(widths, num_valid_sc):
    w = widths[4]
    t = w.eng.tables
    got = aerial.dynamic_pe(t["pe"], t["uniq_pilot_sc"], t["freq_dist"],
                            num_valid_sc)
    want = np.asarray(w.jeng._dynamic_pe(jnp.int32(num_valid_sc)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert not got[:, :, num_valid_sc:].any()


@pytest.mark.parametrize("n_prb", [3, 4])
def test_engine_f32_matches_jax(widths, jparams, n_prb):
    w = widths[n_prb]
    x = _inputs(w)
    want = w.jeng(jparams, *[jnp.asarray(a) for a in x])
    got = w.eng(_port_params(jparams), *[torch.as_tensor(a) for a in x])
    for g, wnt, name in zip(got, want, ("llr", "h_hat")):
        assert g.shape == wnt.shape and g.dtype == torch.float32, name
        assert _rel(g.numpy(), wnt) <= F32_BAR, name


def test_engine_bf16_matches_jax(widths, jparams):
    """bfloat16 at 4 PRB within test_torch_slice.py's bars; JAX on the
    export's route (its Pallas kernels in interpret mode)."""
    import dataclasses
    w = widths[4]
    x = _inputs(w, seed=1)
    jx = [jnp.asarray(a) for a in x]
    jeng = JaxAerialNRX(w.jm.receiver.rg, dataclasses.replace(
        w.jm.receiver.cgnn_cfg, **ROUTE), dtype=jnp.bfloat16)
    want = jax.jit(jeng.__call__)(jparams, *jx)
    ref32 = w.jeng(jparams, *jx)
    got = w.engine(torch.bfloat16)(_port_params(jparams, torch.bfloat16),
                                   *[torch.as_tensor(a) for a in x])
    for g, wnt, r32, name in zip(got, want, ref32, ("llr", "h_hat")):
        g, wnt, r32 = g.numpy(), np.asarray(wnt, np.float32), np.asarray(r32)
        assert _rel(g, wnt) <= 0.1, name
        assert np.abs(g - wnt).mean() / np.abs(wnt).max() <= 3e-3, name
        assert _rel(g, r32) <= 1.5 * _rel(wnt, r32), name


def _receiver(widths, params, buckets, tables=None):
    engines = {n: widths[n].engine(torch.float32, tables)
               for n in buckets}
    return aot.BucketedReceiver(engines.__getitem__, params, BATCH, buckets)


def test_padded_matches_direct(widths, jparams):
    """3 PRB through the 4-PRB bucket = the 3-PRB engine's exact bucket
    bit for bit, on inputs of the generator; cropped outputs of the
    request's width."""
    params = _port_params(jparams)
    gen = data_tools.AerialDataGenerator(widths[3].model)
    inputs3, _ = gen(torch.Generator().manual_seed(1), BATCH, 10.0)
    padded = _receiver(widths, params, (4,))
    assert padded.bucket_for(3) == 4
    got = padded.run(3, *inputs3)
    want = _receiver(widths, params, (3,)).run(3, *inputs3)
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape and g.shape[2] == 36
        assert torch.equal(g, wnt)  # every reduction over valid columns


def test_exact_bucket_passes_through(widths, jparams):
    params = _port_params(jparams)
    rx = _receiver(widths, params, (4,))
    x = rx.example_inputs(4)
    got = rx.run(4, *x)
    want = widths[4].eng(params, *x, num_valid_sc=48)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


def test_dispatch_refusals(widths, jparams):
    params = _port_params(jparams)
    rx = _receiver(widths, params, (4,))
    x4 = rx.example_inputs(4)
    with pytest.raises(ValueError, match="pilots"):
        rx.run(2, *x4)  # the 4-PRB pilot axis for a 2-PRB request
    with pytest.raises(ValueError, match="exceeds"):
        rx.run(5, *x4)
    tables = widths[4].eng.numpy_tables()
    tables["pad_dispatch_exact"] = False
    inexact = _receiver(widths, params, (4,), tables)
    with pytest.raises(ValueError, match="padding"):
        inexact.run(3, *inexact.example_inputs(3))
    assert torch.equal(inexact.run(4, *x4)[0], rx.run(4, *x4)[0])
    with pytest.raises(ValueError, match="CUDA"):
        aot.BucketedReceiver({4: widths[4].eng}.__getitem__, params, BATCH,
                             (4,), graphs=True)


def test_engine_file_roundtrip(widths, jparams, tmp_path):
    w = widths[4]
    params = _port_params(jparams)
    path = str(tmp_path / "e.nrxengine")
    assert aot.save_engine(path, w.eng, params) > 100_000
    eng, params2 = aot.load_engine(path, device="cpu")
    assert eng.n_sc == 48 and eng.cfg == w.eng.cfg and eng.num_it == 2
    assert eng.pad_dispatch_exact and eng.dtype == torch.float32
    x = [torch.as_tensor(a) for a in _inputs(w, seed=2)]
    for g, wnt in zip(eng(params2, *x, num_valid_sc=36),
                      w.eng(params, *x, num_valid_sc=36)):
        assert torch.equal(g, wnt)
    npz = str(tmp_path / "idx.npz")
    data_tools.export_static_indices(eng, npz)
    with np.load(npz) as f:
        np.testing.assert_array_equal(f["nn_gather"], w.jeng.nn_gather)
        np.testing.assert_array_equal(f["positional_encoding"], w.jeng.pe)


def _jax_generator_draws(jm, key, batch, ebno):
    """The bits, CFRs and noise JAX's AerialDataGenerator draws from key."""
    p = jm.p
    rg = p.transmitters[0].resource_grid
    nsym, nsc = rg.num_ofdm_symbols, rg.num_subcarriers
    keys = jax.random.split(key, 6)
    bits = jax_binary_source(keys[0], (batch, p.max_num_tx,
                                       jm.transmitters[0].tb_size))
    kc, kn = jax.random.split(keys[2])
    h = p.channel_model(kc, batch, nsym, nsc, p.carrier.subcarrier_spacing)
    noise = jax_complex_awgn(kn, (batch, p.num_rx_antennas, nsym, nsc),
                             jm._noise_variance(jnp.float32(ebno)))
    return bits, h, noise


def test_generator_and_evaluator_match_jax(widths, jparams):
    w = widths[4]
    key = jax.random.PRNGKey(3)
    jgen = JaxGen(w.jm, w.jeng)
    jinputs, jlabels = jax.jit(lambda k: jgen(k, BATCH, 6.0))(key)
    draws = [torch.as_tensor(np.array(a))
             for a in _jax_generator_draws(w.jm, key, BATCH, 6.0)]
    inputs, labels = data_tools.AerialDataGenerator(w.model).forward(*draws)
    for g, wnt in zip(inputs, jinputs):
        assert g.shape == wnt.shape
        assert _rel(g.numpy(), wnt) <= F32_BAR
    np.testing.assert_array_equal(labels["coded_bits"].numpy(),
                                  np.asarray(jlabels["coded_bits"]))
    # the evaluator on the JAX engine's LLRs of that slot, JAX's labels
    llr = w.jeng(jparams, *jinputs)[0]
    want = JaxEval(w.jm)(llr, jlabels)
    got = data_tools.AerialDataEvaluator(w.model)(
        torch.as_tensor(np.asarray(llr)),
        {k: torch.as_tensor(np.asarray(v)) for k, v in jlabels.items()})
    assert got["coded_ber"] == pytest.approx(want["coded_ber"], abs=0)
    assert got["crc_pass_rate"] == want["crc_pass_rate"]


def test_export_cli_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "deploy")
    assert cli_export.main(["--config", "nrx_rt", "--buckets", "4",
                            "--device", "cpu", "--out", out]) == 0
    with open(os.path.join(out, "nrx_rt_manifest.json")) as f:
        manifest = json.load(f)
    stats = manifest["buckets"]["4"]
    assert manifest["mode"] == "eager" and stats["event_ms"] is None
    assert stats["p50_ms"] > 0 and stats["engine_bytes"] > 100_000
    eng, params = aot.load_engine(os.path.join(out, stats["engine_file"]),
                                  device="cpu")
    assert eng.n_sc == 48 and eng.dtype == torch.bfloat16
    assert eng.cfg.fused_iteration and not eng.cfg.fused_full
    want = weights.load_tree(weights.NRX_RT_EMA, device="cpu")["cgnn"]
    got = weights.flatten(params["cgnn"])
    for k, v in weights.flatten(want).items():
        assert torch.equal(got[k], v), k


def test_deploy_entry_on_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        entry.deploy_entry(buckets=(4,), device="cpu")
    rx, examples = entry.deploy_entry(buckets=(4, 16), graphs=False,
                                      device="cpu", dtype=torch.float32)
    assert rx.bucket_for(10) == 16 and set(examples) == {4, 16}
    llr, h_hat = rx.run(4, *examples[4])
    assert llr.shape == (1, 2, 48, 14, 4) and h_hat.shape == (1, 2, 48, 14,
                                                               8)
    p = Parameters("nrx_rt", training=False, overrides={"n_size_bwp": 16})
    assert rx.engines[16].n_sc == 192 == receiver_for(
        p, device="cpu").rg.num_subcarriers
