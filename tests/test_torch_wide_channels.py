"""The kernels' plain versions at e2e_rt's widths, past 128 input channels,
vs the JAX Pallas kernels in interpret mode.

e2e_rt and e2e_large (d_s 64, no LS input) have update stacks of 2 x 64 + 2
= 130 input channels (130 -> 128 -> 128 -> 64), an init stack 10 -> 128 ->
128 -> 64, aggregation MLPs 64 -> 128 -> 64 and readouts 64 -> 128 -> 4 / 8.
The CUDA kernels take such products in bfloat16 in their wide instances
(csrc/nrx_tile.cuh, kWide), held bit for bit against these plain versions by
chip_smoke.py on the card. Here, on a 14 x 24 grid with JAX's seed-made
parameters and randomized biases:

- K1 (`fused_conv_stack`): the 130-channel update stack;
- K3 (`fused_iteration`): state mode, and readout mode with both readouts,
  one user inactive;
- K4 (`fused_cgnn_full`): e2e_rt's 4 iterations;

each in float32 and bfloat16. Bars, those of tests/test_torch_slice.py
(relative to max |JAX|): float32 1e-4; bfloat16 0.1, and no further from
JAX's float32 result than 1.5x JAX's own bfloat16 result is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.kernels.cgnn_iter_pallas import (fused_cgnn_full as
                                                    jax_full,
                                                    fused_iteration as
                                                    jax_iteration)
from neural_rx_tpu.kernels.sepconv_pallas import (fused_conv_stack as
                                                  jax_stack)
from neural_rx_tpu.rx.cgnn import CGNNConfig, init_cgnn_params
from neural_rx_tpu_torch.kernels import cgnn_iter, sepconv
from neural_rx_tpu_torch.weights import from_jax_numpy

B, T, H, W, D_S = 1, 2, 14, 24, 64
NUM_IT = 4
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
KERNELS = ("k1_update", "k3_state", "k3_readout", "k4")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wide():
    """e2e_rt's CGNN widths (JAX's init, biases from a normal), inputs from
    numpy, and each kernel's outputs: JAX (interpret mode) and the port's
    plain version, per dtype."""
    cfg = CGNNConfig(num_bits_per_symbol=(4,), num_rx_ant=4, num_it=NUM_IT,
                     d_s=D_S, num_units_init=(128, 128),
                     num_units_agg=((128,),) * NUM_IT,
                     num_units_state=((128, 128),) * NUM_IT,
                     num_units_readout=(128,), initial_chest=False)
    assert cfg.in_channels == 10
    leaves, treedef = jax.tree.flatten(
        init_cgnn_params(jax.random.PRNGKey(6), cfg))
    rng = np.random.default_rng(6)
    jp = jax.tree.unflatten(treedef, [
        0.2 * rng.normal(size=x.shape).astype(np.float32) if x.ndim == 1
        else np.asarray(x) for x in leaves])
    tp = from_jax_numpy(jp)
    assert tp["iterations"][0]["update"]["hidden"][0]["pw"].shape == (130,
                                                                      128)
    x = rng.normal(size=(B * T, H, W, 2 * D_S + 2)).astype(np.float32)
    s = (4.0 * rng.normal(size=(B, T, H, W, D_S))).astype(np.float32)
    pe = rng.normal(size=(T, H, W, 2)).astype(np.float32)
    z0 = rng.normal(size=(B, T, H, W, 10)).astype(np.float32)
    act = np.array([[1.0, 0.0]], np.float32)
    ro = ("readout_llrs", "readout_chest")
    it1 = 1

    def jax_side(dt):
        def c(a):
            return jnp.asarray(a).astype(dt)
        return {
            "k1_update": (jax_stack(jp["iterations"][0]["update"], c(x),
                                    interpret=True),),
            "k3_state": (jax_iteration(jp["iterations"][0], c(s), c(pe),
                                       jnp.asarray(act), interpret=True),),
            "k3_readout": jax_iteration(
                jp["iterations"][it1], c(s), c(pe), jnp.asarray(act),
                interpret=True, readout_p=jp[ro[0]][0], chest_p=jp[ro[1]]),
            "k4": jax_full(jp, c(z0), c(pe), jnp.asarray(act),
                           interpret=True)}

    def port_side(dt):
        def c(a):
            return torch.as_tensor(a).to(dt)
        return {
            "k1_update": (sepconv.sepconv_stack_reference(
                tp["iterations"][0]["update"], c(x)),),
            "k3_state": (cgnn_iter.fused_iteration_reference(
                tp["iterations"][0], c(s), c(pe), torch.as_tensor(act)),),
            "k3_readout": cgnn_iter.fused_iteration_reference(
                tp["iterations"][it1], c(s), c(pe), torch.as_tensor(act),
                None, tp[ro[0]][0], tp[ro[1]]),
            "k4": cgnn_iter.fused_cgnn_full_reference(
                tp, c(z0), c(pe), torch.as_tensor(act), num_it=NUM_IT)}
    return {(side, key): fn(dts[i]) for key, dts in DTYPES.items()
            for side, fn, i in (("port", port_side, 0),
                                ("jax", jax_side, 1))}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("key", DTYPES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_versions_past_128_channels_match_jax(wide, kernel, key):
    got, want = wide["port", key][kernel], wide["jax", key][kernel]
    want32 = wide["jax", "f32"][kernel]
    assert len(got) == len(want)
    for g, w, w32 in zip(got, want, want32):
        assert g.dtype == DTYPES[key][0]
        g, w, w32 = _np(g), _np(w), _np(w32)
        assert g.shape == w.shape and np.isfinite(g).all()
        if key == "f32":
            assert _rel(g, w) <= 1e-4
        else:
            assert _rel(g, w) <= 0.1
            assert _rel(g, w32) <= 1.5 * _rel(w, w32)


def test_iteration_wrapper_refuses_more_than_256_in_bf16(monkeypatch):
    """The iteration wrapper refuses a bfloat16 product of more than 256
    input channels (the tensor-core tile's bound) before any launch."""
    from neural_rx_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("launched"))
    it_p = {"agg": {"hidden": [{"w": torch.zeros(64, 257),
                                "b": torch.zeros(257)}],
                    "out": {"w": torch.zeros(257, 64),
                            "b": torch.zeros(64)}},
            "update": {"hidden": [], "out": {
                "dw": torch.zeros(3, 3, 1, 130), "pw": torch.zeros(130, 64),
                "b": torch.zeros(64)}}}
    s = torch.zeros((B, T, H, W, D_S), dtype=torch.bfloat16)
    pe = torch.zeros((T, H, W, 2))
    with pytest.raises(ValueError, match="256 input channels"):
        cgnn_iter._launch_iteration(it_p, s, pe, torch.ones(B, T), None,
                                    None, None)
    assert sepconv.MMA_MAX_K == 256
