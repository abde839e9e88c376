"""The port's full 3x3 conv layers (`layer_type_conv = "conv"`) vs the JAX
package's.

JAX computes such a layer with `_apply_conv` (an XLA convolution) on every
route: no Pallas kernel takes it, and every fused route of its cgnn_apply
falls back to those layers. The port computes it as one im2col product
(`rx/cgnn.py:conv_stack`) on every route. On small widths (d_s 8, a 14 x 48
grid, 2 users), JAX's seed-made tree with randomized biases:

- one stack, float32 and bfloat16, without and with a valid range;
- cgnn_apply on every flag set (none, fused_convs, fused_iteration, with
  fused_readout, fused_full), float32 and bfloat16, a bucket-padded grid
  and one inactive user, against JAX on the same flags and bit for bit
  against the port's own plain route;
- every parameter's gradient through cgnn_apply(training=True,
  apply_multiloss=True) against jax.grad;
- the init tree's leaves and shapes against JAX's, and a JAX tree carried
  across by `from_jax_numpy` and the `.npz` weights unchanged.

Bars (relative to max |JAX|), those of tests/test_torch_slice.py and
tests/test_torch_training.py: float32 1e-4 (stack and routes; 1e-5 for
the training readouts, 1e-4 for the gradients); bfloat16 0.1 on the
largest element and no further from JAX's float32 result than 1.5x JAX's
own bfloat16 result is.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.rx import cgnn as jax_cgnn
from neural_rx_tpu_torch import entry, weights
from neural_rx_tpu_torch.rx import cgnn as port_cgnn
from neural_rx_tpu_torch.sim import training

B, T, H, W, D_S, SC_VALID = 2, 2, 14, 48, 8, 40
WIDTHS = dict(num_bits_per_symbol=(4,), num_rx_ant=4, num_it=2, d_s=D_S,
              num_units_init=(16,), num_units_agg=((8,),) * 2,
              num_units_state=((16,),) * 2, num_units_readout=(8,),
              layer_type_conv="conv")
FLAG_SETS = {"plain": {}, "fused_convs": {"fused_convs": True},
             "fused_iteration": {"fused_convs": True,
                                 "fused_iteration": True},
             "fused_readout": {"fused_convs": True, "fused_iteration": True,
                               "fused_readout": True},
             "fused_full": {"fused_convs": True, "fused_full": True}}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
LOSS_BAR, GRAD_BAR = 1e-5, 1e-4  # tests/test_torch_training.py's


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def conv_params():
    """JAX's seed-made conv-layer tree with biases drawn from a normal
    (so that the layers' bias reaches the padded columns), as numpy leaves
    for JAX and the port's torch tree."""
    cfg = jax_cgnn.CGNNConfig(**WIDTHS)
    leaves, treedef = jax.tree.flatten(
        jax_cgnn.init_cgnn_params(jax.random.PRNGKey(2), cfg))
    rng = np.random.default_rng(3)
    tree = jax.tree.unflatten(treedef, [
        0.3 * rng.normal(size=x.shape).astype(np.float32) if x.ndim == 1
        else np.asarray(x) for x in leaves])
    return tree, weights.from_jax_numpy(tree)


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, W, 8)).astype(np.float32),
            rng.normal(size=(T, H, W, 2)).astype(np.float32),
            rng.normal(size=(B, T, H, W, 8)).astype(np.float32),
            np.array([[1.0, 1.0], [1.0, 0.0]], np.float32),
            np.ones((B, T, 1), np.float32))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, want32, key, bar=1e-4):
    """got (port) against want (JAX in the same dtype) at the slice bars;
    want32: JAX's float32 result on the same inputs."""
    got, want, want32 = _np(got), _np(want), _np(want32)
    assert got.shape == want.shape
    if key == "f32":
        assert _rel(got, want) <= bar
    else:
        assert _rel(got, want) <= 0.1
        assert _rel(got, want32) <= 1.5 * _rel(want, want32)


@pytest.mark.parametrize("key", DTYPES)
@pytest.mark.parametrize("sc_valid", [None, SC_VALID])
def test_conv_stack_matches_jax(conv_params, key, sc_valid):
    jp, tp = conv_params
    tdt, jdt = DTYPES[key]
    p = jp["iterations"][0]["update"]
    x = np.random.default_rng(4).normal(
        size=(3, H, W, 2 * D_S + 2)).astype(np.float32)
    scv = None if sc_valid is None else jnp.int32(sc_valid)

    def jax_stack(dt):
        return jax_cgnn._apply_conv_stack(p, jnp.asarray(x).astype(dt),
                                          "conv", sc_valid=scv)
    got = port_cgnn.conv_stack(tp["iterations"][0]["update"],
                               torch.as_tensor(x).to(tdt), sc_valid)
    assert got.dtype == tdt
    _check(got, jax_stack(jdt), jax_stack(jnp.float32), key)
    if sc_valid is not None:
        assert not got[:, :, sc_valid:].any()


@pytest.fixture(scope="module")
def jax_routes(conv_params):
    """JAX cgnn_apply on every flag set and dtype (and float32 once)."""
    jp, _ = conv_params
    args = tuple(map(jnp.asarray, _inputs()))
    out = {}
    for name, flags in FLAG_SETS.items():
        cfg = jax_cgnn.CGNNConfig(**WIDTHS, **flags)
        for key, (_, jdt) in DTYPES.items():
            llrs, hh = jax_cgnn.cgnn_apply(jp, cfg, *args, dtype=jdt,
                                           sc_valid=jnp.int32(SC_VALID))
            out[name, key] = (llrs[-1][0], hh[-1])
    return out


def _port_route(tp, key, **flags):
    cfg = port_cgnn.CGNNConfig(**WIDTHS, **flags)
    llrs, hh = port_cgnn.cgnn_apply(
        tp, cfg, *map(torch.as_tensor, _inputs()), dtype=DTYPES[key][0],
        sc_valid=SC_VALID)
    assert len(llrs) == len(hh) == 1
    return llrs[-1][0], hh[-1]


@pytest.mark.parametrize("key", DTYPES)
@pytest.mark.parametrize("name", FLAG_SETS)
def test_cgnn_apply_conv_layers_match_jax(conv_params, jax_routes, name,
                                          key, monkeypatch):
    """Every route runs (no NotImplementedError), takes no kernel wrapper,
    matches JAX on the same flags and equals the port's plain route."""
    from neural_rx_tpu_torch.kernels import cgnn_iter
    _, tp = conv_params
    called = []
    for mod, fn in ((port_cgnn, "fused_conv_stack"),
                    (cgnn_iter, "fused_iteration"),
                    (cgnn_iter, "fused_cgnn_full")):
        monkeypatch.setattr(mod, fn, lambda *a, _fn=fn, **k:
                            called.append(_fn))
    got = _port_route(tp, key, **FLAG_SETS[name])
    assert not called, called
    plain = _port_route(tp, key)
    for g, p_, w, w32 in zip(got, plain, jax_routes[name, key],
                             jax_routes[name, "f32"]):
        assert g.dtype == torch.float32
        assert torch.equal(g, p_)
        _check(g, w, w32, key)


def test_conv_layer_gradients_match_jax(conv_params):
    """cgnn_apply(training=True, apply_multiloss=True): every readout
    point within LOSS_BAR of JAX, the gradient of a fixed weighted sum of
    them within GRAD_BAR of max |JAX grad| per leaf."""
    jp, _ = conv_params
    y, pe, h, act, mm = _inputs(12)
    rng = np.random.default_rng(13)
    w_llr = rng.normal(size=(B, T, H, W, 4)).astype(np.float32)
    w_h = rng.normal(size=(B, T, H, W, 8)).astype(np.float32)
    jcfg = jax_cgnn.CGNNConfig(**WIDTHS)
    cfg = port_cgnn.CGNNConfig(**WIDTHS)

    def objective(llrs, h_hats, cast):
        return sum((per_mcs[0] * cast(w_llr)).mean() + (hh * cast(w_h)).mean()
                   for per_mcs, hh in zip(llrs, h_hats))

    def jax_fn(params):
        llrs, h_hats = jax_cgnn.cgnn_apply(
            params, jcfg, *map(jnp.asarray, (y, pe, h, act, mm)),
            training=True, apply_multiloss=True)
        return objective(llrs, h_hats, jnp.asarray), (llrs, h_hats)

    (_, (jllrs, jh)), jgrads = jax.jit(jax.value_and_grad(
        jax_fn, has_aux=True))(jp)
    params = training.trainable(weights.from_jax_numpy(jp))
    llrs, h_hats = port_cgnn.cgnn_apply(
        params, cfg, *map(torch.as_tensor, (y, pe, h, act, mm)),
        training=True, apply_multiloss=True)
    assert len(llrs) == len(h_hats) == 2
    for got, want in zip([l[0] for l in llrs] + h_hats,
                         [l[0] for l in jllrs] + list(jh)):
        assert _rel(_np(got), _np(want)) <= LOSS_BAR
    objective(llrs, h_hats, torch.as_tensor).backward()
    want = weights.flatten(jax.tree.map(np.asarray, jgrads))
    got = weights.flatten(params)
    assert set(got) == set(want)
    assert any(k.endswith(".w") and "update" in k for k in got)
    for k, v in got.items():
        scale = np.abs(want[k]).max()
        err = np.abs(v.grad.numpy() - want[k]).max()
        assert scale > 0 and err <= GRAD_BAR * scale, (k, err, scale)


def test_conv_init_tree_and_weights_carry_across(conv_params, tmp_path):
    """The port's seed-made conv tree has JAX's leaves and shapes; a JAX
    conv tree reaches the port unchanged through from_jax_numpy and through
    the .npz weights, and packing it for the kernels touches no conv
    stack."""
    jp, tp = conv_params
    cfg = port_cgnn.CGNNConfig(**WIDTHS)
    mine = weights.flatten(port_cgnn.init_cgnn_params(
        cfg, torch.Generator().manual_seed(0)))
    theirs = weights.flatten(jax.tree.map(np.asarray, jp))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in theirs.items()}
    assert mine["s_init.0.out.w"].shape == (3, 3, 16, D_S)
    for k, v in weights.flatten(tp).items():
        assert np.array_equal(v.numpy(), theirs[k]), k
    path = str(tmp_path / "conv_weights.npz")
    weights.save(path, {"cgnn": tp})
    back = entry.pack_params(weights.load_tree(path, device="cpu"),
                             torch.bfloat16)
    for stack in back["cgnn"]["s_init"] + [
            it["update"] for it in back["cgnn"]["iterations"]]:
        assert "packed" not in stack
    assert "packed" in back["cgnn"]["iterations"][0]["agg"]
    for k, v in weights.flatten(back["cgnn"]).items():
        assert np.array_equal(v.numpy(), theirs[k]), k
    llr, hh = _port_route(back["cgnn"], "f32", fused_convs=True)
    ref = _port_route(tp, "f32")
    assert torch.equal(llr, ref[0]) and torch.equal(hh, ref[1])


def test_unknown_layer_type_raises(conv_params):
    _, tp = conv_params
    cfg = dataclasses.replace(port_cgnn.CGNNConfig(**WIDTHS),
                              layer_type_conv="dense")
    with pytest.raises(ValueError, match="unknown layer type"):
        port_cgnn.cgnn_apply(tp, cfg, *map(torch.as_tensor, _inputs()))
