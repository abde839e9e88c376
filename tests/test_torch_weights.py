"""Weights bridge: the committed `weights/nrx_rt{,_qpsk,_64qam}_ema_weights.npz`
read by the PyTorch port equal the JAX package's pickled trees leaf for
leaf, and `from_jax_numpy` round-trips a JAX parameter tree exactly."""

import jax
import numpy as np
import pytest

from neural_rx_tpu.rx.cgnn import CGNNConfig, init_cgnn_params
from neural_rx_tpu.sim.training import load_weights
from neural_rx_tpu_torch import weights
from neural_rx_tpu_torch.rx.cgnn import count_params

NRX_RT = dict(num_bits_per_symbol=(4,), num_rx_ant=4, num_it=2, d_s=56,
              num_units_init=(128, 128), num_units_agg=((64,), (64,)),
              num_units_state=((128, 128), (128, 128)),
              num_units_readout=(128,))


def _jax_leaves(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def port_tree():
    return weights.load(weights.NRX_RT_EMA, device="cpu")


def test_param_count_142922(port_tree):
    assert count_params(port_tree) == 142922
    assert len(weights.flatten(port_tree)) == 43


def test_every_leaf_equals_jax(port_tree):
    want = _jax_leaves(load_weights("weights/nrx_rt_ema_weights.pkl")["cgnn"])
    got = {k: v.numpy() for k, v in weights.flatten(port_tree).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("label,bits", [("nrx_rt_qpsk", 2),
                                        ("nrx_rt_64qam", 6)])
def test_other_mcs_weights_equal_jax(label, bits):
    tree = weights.load(weights.ema_weights(label), device="cpu")
    want = _jax_leaves(load_weights(f"weights/{label}_ema_weights.pkl")[
        "cgnn"])
    got = {k: v.numpy() for k, v in weights.flatten(tree).items()}
    assert len(got) == 43 and set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert tuple(tree["readout_llrs"][0]["out"]["w"].shape) == (128, bits)


def test_depthwise_layout_kept(port_tree):
    assert tuple(port_tree["s_init"][0]["hidden"][0]["dw"].shape) == (
        3, 3, 1, 18)
    assert tuple(port_tree["iterations"][1]["update"]["out"]["dw"].shape) \
        == (3, 3, 1, 128)


def test_from_jax_numpy_round_trip():
    tree = init_cgnn_params(jax.random.PRNGKey(3), CGNNConfig(**NRX_RT))
    port = weights.from_jax_numpy(jax.tree.map(np.asarray, tree))
    assert count_params(port) == 142922
    back = {k: v.numpy() for k, v in weights.flatten(port).items()}
    want = _jax_leaves(tree)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # and through the named-leaf form the npz uses
    again = weights.unflatten(weights.flatten(port))
    assert weights.flatten(again).keys() == weights.flatten(port).keys()


def test_default_device_needs_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.load(weights.NRX_RT_EMA)
