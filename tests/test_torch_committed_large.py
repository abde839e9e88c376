"""The committed weights of nrx_large and e2e_rt in the port: weight files
in parts under 1,000,000 B (`weights.write_npz`, `load_tree`), equal leaf
for leaf to the JAX package's pickles, nrx_large's CGNN at 8 iterations
with them against JAX's `cgnn_apply`, e2e_rt's learned constellation
against JAX's mapper, and the evaluate CLI finding nrx_large's parts.

- `weights/nrx_large_weights.part*.npz` come from `nrx_large_weights.pkl`
  (the file the JAX evaluate CLI loads), `weights/e2e_rt_ema_weights.part*
  .npz` from `e2e_rt_ema.pkl` with its constellation
  (`scripts/torch_port_export_weights.py`).
- The CGNN: nrx_large's 4-PRB training grid (14 x 48), batch 2, both users
  active, float32, every fused flag off; bar 1e-4 of max |JAX| (the float32
  bar of tests/test_torch_slice.py).
- The mapper: the points centred and normalised as JAX computes them, bits
  mapped to symbols; bar 1e-6 (complex64 rounding of the mean and norm).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.phy.constellation import Constellation as JaxConstellation
from neural_rx_tpu.phy.mapping import map_bits as jax_map_bits
from neural_rx_tpu.rx import cgnn as jax_cgnn
from neural_rx_tpu.sim.training import load_weights
from neural_rx_tpu_torch import weights
from neural_rx_tpu_torch.cli import evaluate
from neural_rx_tpu_torch.phy.mapping import map_bits
from neural_rx_tpu_torch.rx import cgnn as port_cgnn
from neural_rx_tpu_torch.rx.neural_rx import receiver_for
from neural_rx_tpu_torch.sim import simber
from neural_rx_tpu_torch.sim.config import Parameters
from neural_rx_tpu_torch.sim.e2e import E2EModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WDIR = os.path.join(ROOT, "weights")
# (port file, JAX pickle, leaves in the port's file)
COMMITTED = {"nrx_large": ("nrx_large_weights.npz", "nrx_large_weights.pkl",
                           121),
             "e2e_rt": ("e2e_rt_ema_weights.npz", "e2e_rt_ema.pkl", 70)}
CGNN_BAR = 1e-4
MAP_BAR = 1e-6
B = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_leaves(tree) -> dict:
    return {k: np.asarray(v) for k, v in weights.flatten(
        jax.tree.map(np.asarray, tree)).items()}


@pytest.mark.parametrize("label", COMMITTED)
def test_parts_equal_the_jax_pickle(label):
    npz, pkl, n_leaves = COMMITTED[label]
    path = os.path.join(WDIR, npz)
    assert not os.path.exists(path) and weights.exists(path)
    assert len(glob.glob(os.path.join(WDIR, npz[:-4] + ".part*.npz"))) == 2
    assert weights.committed_weights(label) == path
    got = weights.load_tree(path, device="cpu")
    want = load_weights(os.path.join(WDIR, pkl))
    assert set(got) == set(want)
    flat = {k: v.numpy() for k, v in weights.flatten(got).items()}
    ref = _jax_leaves(want)
    assert set(flat) == set(ref) and len(flat) == n_leaves
    for k, v in ref.items():
        assert flat[k].dtype == np.float32 and flat[k].shape == v.shape, k
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    if label == "e2e_rt":
        assert tuple(got["constellation"][0].shape) == (2, 16)


def test_every_weight_file_is_under_the_limit():
    files = glob.glob(os.path.join(WDIR, "*.npz"))
    assert len(files) >= 9
    for f in files:
        assert os.path.getsize(f) < weights.PART_LIMIT, f


def _big_tree():
    gen = torch.Generator().manual_seed(4)
    return {"cgnn": {"a": [torch.randn(300, 300, generator=gen)
                           for _ in range(3)],
                     "b": {"w": torch.randn(200, 100, generator=gen)}},
            "constellation": [torch.randn(2, 16, generator=gen)]}


@pytest.mark.parametrize("case", ["round_trip", "missing_part",
                                  "leaf_twice", "single_file_replaces"])
def test_save_writes_parts_that_load_tree_reads(tmp_path, case):
    """A tree of 1.2 MB goes to two parts and back leaf for leaf; a
    missing part or a leaf in two parts raises; a small tree saved at the
    same path replaces the parts."""
    tree = _big_tree()
    path = str(tmp_path / "big_weights.npz")
    written = weights.save(path, tree)
    assert written == [weights.part_path(path, i) for i in range(2)]
    assert all(os.path.getsize(f) < weights.PART_LIMIT for f in written)
    if case == "round_trip":
        back = weights.load_tree(path, device="cpu")
        want = weights.flatten(tree)
        got = weights.flatten(back)
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        assert weights.exists(path) and not os.path.exists(path)
    elif case == "missing_part":
        os.remove(written[1])
        with pytest.raises(FileNotFoundError, match="missing"):
            weights.load_tree(path, device="cpu")
    elif case == "leaf_twice":
        with np.load(written[0]) as f:
            first = {k: f[k] for k in f.files}
        with np.load(written[1]) as f:
            second = {k: f[k] for k in f.files}
        name = next(k for k in first if k != weights.PART_KEY)
        np.savez(written[1], **second, **{name: first[name]})
        with pytest.raises(ValueError, match="two parts"):
            weights.load_tree(path, device="cpu")
    else:
        small = {"cgnn": {"w": torch.ones(3)}}
        assert weights.save(path, small) == [path]
        assert not glob.glob(str(tmp_path / "big_weights.part*.npz"))
        assert torch.equal(weights.load_tree(path, device="cpu")["cgnn"]["w"],
                           torch.ones(3))


def test_nrx_large_cgnn_8_iterations_matches_jax():
    """The committed nrx_large weights through the port's CGNN (plain
    route) and JAX's cgnn_apply on the same inputs, 8 iterations."""
    rx = receiver_for(Parameters("nrx_large", training=True),
                      nrx_dtype=torch.float32, kernels=False, device="cpu")
    cfg = dataclasses.replace(rx.cgnn_cfg, fused_convs=False,
                              fused_iteration=False, fused_readout=False,
                              fused_full=False)
    assert cfg.num_it == 8
    jcfg = jax_cgnn.CGNNConfig(**{f: getattr(cfg, f) for f in (
        "num_bits_per_symbol", "num_rx_ant", "num_it", "d_s",
        "num_units_init", "num_units_agg", "num_units_state",
        "num_units_readout", "layer_type_conv", "var_mcs_masking",
        "initial_chest")})
    params = weights.load_tree(weights.committed_weights("nrx_large"),
                               device="cpu")["cgnn"]
    jparams = load_weights(os.path.join(WDIR, "nrx_large_weights.pkl"))[
        "cgnn"]
    pe = rx.pe.numpy()
    t, h, w = pe.shape[:3]
    assert (t, h, w) == (2, 14, 48)
    rng = np.random.default_rng(8)
    y = rng.normal(size=(B, h, w, 8)).astype(np.float32)
    h_ls = (0.5 * rng.normal(size=(B, t, h, w, 8))).astype(np.float32)
    act = np.ones((B, t), np.float32)
    mm = np.ones((B, t, 1), np.float32)
    llrs, h_hats = port_cgnn.cgnn_apply(
        params, cfg, *map(torch.as_tensor, (y, pe, h_ls, act, mm)))
    jllrs, jh = jax.jit(lambda p, *a: jax_cgnn.cgnn_apply(p, jcfg, *a))(
        jparams, *map(jnp.asarray, (y, pe, h_ls, act, mm)))
    for got, want in ((llrs[-1][0], jllrs[-1][0]), (h_hats[-1], jh[-1])):
        want = np.asarray(want)
        assert got.shape == want.shape
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= CGNN_BAR, err


def test_e2e_rt_mapped_symbols_match_jax():
    """e2e_rt's transmitter points from the committed constellation, and
    random bits mapped through them, against JAX's."""
    model = E2EModel(Parameters("e2e_rt", training=False), device="cpu")
    params = weights.load_tree(weights.committed_weights("e2e_rt"),
                               device="cpu")
    jparams = load_weights(os.path.join(WDIR, "e2e_rt_ema.pkl"))
    (pts,) = model.constellation_points(params, [0])
    jpts = JaxConstellation.points(jnp.asarray(jparams["constellation"][0]),
                                   center=True)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0,
                               atol=MAP_BAR)
    assert abs(complex(pts.mean())) < MAP_BAR
    assert abs(float((pts.abs() ** 2).mean()) - 1.0) < MAP_BAR
    bits = np.random.default_rng(9).integers(0, 2, (3, 400)).astype(
        np.float32)
    got = map_bits(torch.as_tensor(bits), pts).numpy()
    want = np.asarray(jax_map_bits(jnp.asarray(bits), jpts))
    assert got.shape == want.shape == (3, 100)
    np.testing.assert_allclose(got, want, rtol=0, atol=MAP_BAR)


def test_evaluate_cli_finds_the_nrx_large_parts(monkeypatch, tmp_path):
    """The evaluate CLI on nrx_large loads the committed parts and runs the
    configuration's 8 iterations (sim_ber stubbed: no step runs)."""
    seen = {}

    def fake_sim_ber(model, params, ebno_dbs, **kwargs):
        seen["params"], seen["num_it"] = params, kwargs["num_it"]
        return [0.0] * len(ebno_dbs), [0.0] * len(ebno_dbs)
    monkeypatch.setattr(simber, "sim_ber", fake_sim_ber)
    monkeypatch.setattr(simber, "save_results", lambda *a: None)
    evaluate.main(["--config", "nrx_large", "--snr", "2", "--max-iter", "1",
                   "--batch-size", "1", "--device", "cpu", "--results-dir",
                   str(tmp_path)])
    assert seen["num_it"] == 8
    got = weights.flatten(seen["params"]["cgnn"])
    want = _jax_leaves(load_weights(os.path.join(
        WDIR, "nrx_large_weights.pkl"))["cgnn"])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
