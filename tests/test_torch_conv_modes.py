"""The JAX package's three other ways of computing a separable conv, in the
PyTorch port, against the JAX package on the CPU.

- `conv_mxu`, the folded-tap form of K1/K2: the port's plain version
  (`sepconv_stack_reference(mxu=True)`, the CUDA kernel's oracle and CPU
  path) against JAX `fused_conv_stack(mxu=True)` and
  `fused_conv_stack_blocked(w_blk=32, mxu=True)` in Pallas interpret mode,
  at nrx_rt's init (18 -> 128 -> 128 -> 56) and update (114 -> 128 -> 128 ->
  56) widths on a 14 x 48 grid, sc_valid None and (5, 40). float32: rtol =
  atol = 2e-5, JAX's own bar (tests/test_sepconv_pallas.py); bfloat16: the
  bar of tests/test_torch_sepconv.py, max abs error <= 2**-6 of max |ref|
  and < 1 % of elements differing.
- `lp_stencil`, the depthwise taps summed in the activation dtype: K1, K3
  (state and readout modes, users active (1, 1) and (1, 0)) and K4 in
  bfloat16 against JAX at the same bfloat16 bar; in float32, where the mode
  changes nothing, bit for bit equal to the port's normal mode.
- The refusals: `fused_iteration` raises ValueError on mxu, as JAX's does,
  also through the NRX_CONV_MXU knob; the knobs resolve None.
- `cgnn_apply` on the routes the modes change, against JAX `cgnn_apply`
  with the same flags and env knobs: the bars of tests/test_torch_slice.py
  (float32: 1e-4 of max |JAX|; bfloat16: 0.1 of max |JAX| on the largest
  element, 3e-3 on the mean, and no further from JAX's float32 result than
  1.5 x JAX's own bfloat16 result is).
- The folded lowering of the plain layers (`NRX_SEPCONV_FOLDED=1`), forward
  and the gradients of every dw, pw and b, against JAX `_apply_conv_stack`
  and `jax.grad` with `_SEPCONV_FOLDED` set: forward within 1e-5 of max
  |JAX|, each gradient within 1e-4 of its leaf's max |JAX grad| (LOSS_BAR
  and GRAD_BAR of tests/test_torch_training.py); training reaches it.
- On CPU tensors no mode launches a kernel.

The CUDA kernels in each mode are held against the same plain versions on
the GPU by chip_smoke.py (phase modes_path).
"""

import ctypes
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_rx_tpu.rx.cgnn as jax_cgnn
from neural_rx_tpu.kernels.cgnn_iter_pallas import (fused_cgnn_full as
                                                    jax_full,
                                                    fused_iteration as
                                                    jax_iteration)
from neural_rx_tpu.kernels.sepconv_pallas import (fused_conv_stack as
                                                  jax_stack,
                                                  fused_conv_stack_blocked)
from neural_rx_tpu_torch.kernels import _build, cgnn_iter, sepconv
from neural_rx_tpu_torch.rx import cgnn as port_cgnn
from neural_rx_tpu_torch.weights import from_jax_numpy

B, T, H, W, D_S = 2, 2, 14, 48, 24
BF = torch.bfloat16
STACKS = {"init": (18, [128, 128], 56), "update": (114, [128, 128], 56)}
WIDTHS = dict(num_bits_per_symbol=(4,), num_rx_ant=4, num_it=2, d_s=D_S,
              num_units_init=(32,), num_units_agg=((16,),) * 2,
              num_units_state=((32,),) * 2, num_units_readout=(16,))


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """One torch thread (several test workers share the cores) and no mode
    knob leaking in from the environment."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in ("NRX_CONV_MXU", "NRX_STENCIL_LP", "NRX_SEPCONV_FOLDED"):
        monkeypatch.delenv(k, raising=False)
    yield
    torch.set_num_threads(n)


def _stack(seed, c_in, hidden, c_out):
    """Random stack in the JAX layout, with non-zero biases."""
    rng = np.random.default_rng(seed)
    widths = [c_in] + list(hidden) + [c_out]
    layers = [{"dw": rng.normal(size=(3, 3, 1, ci)).astype(np.float32) / 3,
               "pw": rng.normal(size=(ci, co)).astype(np.float32)
               / np.sqrt(ci),
               "b": rng.normal(size=(co,)).astype(np.float32) * 0.1}
              for ci, co in zip(widths[:-1], widths[1:])]
    return {"hidden": layers[:-1], "out": layers[-1]}


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.detach().float().numpy()


def _bf16_bar(got, want):
    assert np.abs(got - want).max() <= 2.0**-6 * np.abs(want).max()
    assert np.mean(got != want) < 0.01


@pytest.fixture(scope="module")
def cgnn_params():
    """Small CGNN tree (d_s 24, 1-hidden MLPs) with randomized biases, as
    numpy leaves for JAX and as the port's torch tree."""
    cfg = jax_cgnn.CGNNConfig(**WIDTHS)
    leaves, treedef = jax.tree.flatten(
        jax_cgnn.init_cgnn_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    tree = jax.tree.unflatten(treedef, [
        0.5 * rng.normal(size=x.shape).astype(np.float32) if x.ndim == 1
        else np.asarray(x) for x in leaves])
    return tree, from_jax_numpy(tree)


# ---------------------------------------------------------------- K1/K2


@pytest.mark.parametrize("dtype,stack,sc_valid", [
    ("f32", "init", None), ("f32", "update", None),
    ("f32", "init", (5, 40)), ("f32", "update", (5, 40)),
    ("bf16", "init", (5, 40)), ("bf16", "update", None)])
def test_stack_mxu_matches_jax(dtype, stack, sc_valid):
    c_in, hidden, c_out = STACKS[stack]
    p, x = _stack(0, c_in, hidden, c_out), _x(1, (2, H, W, c_in))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" \
        else (jnp.bfloat16, BF)
    scv = None if sc_valid is None else jnp.asarray(sc_valid, jnp.int32)
    want = _np(jax_stack(p, jnp.asarray(x).astype(jdt), interpret=True,
                         sc_valid=scv, mxu=True))
    got = sepconv.fused_conv_stack(from_jax_numpy(p),
                                   torch.as_tensor(x).to(tdt), sc_valid,
                                   mxu=True)
    assert got.dtype == tdt
    got = _np(got)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        _bf16_bar(got, want)
    if sc_valid is not None:
        lo, hi = sc_valid
        assert not got[:, :, :lo].any() and not got[:, :, hi:].any()


def test_stack_mxu_matches_jax_blocked():
    p, x = _stack(2, 18, [128, 128], 56), _x(3, (2, H, W, 18))
    want = _np(fused_conv_stack_blocked(p, jnp.asarray(x), w_blk=32,
                                        interpret=True, mxu=True))
    got = _np(sepconv.sepconv_stack_reference(
        from_jax_numpy(p), torch.as_tensor(x), mxu=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("stack,sc_valid", [("init", None),
                                            ("update", (5, 40))])
def test_stack_lp_bf16_matches_jax(stack, sc_valid):
    c_in, hidden, c_out = STACKS[stack]
    p, x = _stack(4, c_in, hidden, c_out), _x(5, (2, H, W, c_in))
    scv = None if sc_valid is None else jnp.asarray(sc_valid, jnp.int32)
    want = _np(jax_stack(p, jnp.asarray(x).astype(jnp.bfloat16),
                         interpret=True, sc_valid=scv, lp_stencil=True))
    got = _np(sepconv.fused_conv_stack(from_jax_numpy(p),
                                       torch.as_tensor(x).to(BF), sc_valid,
                                       lp_stencil=True))
    _bf16_bar(got, want)
    # and the mode does change the bfloat16 result
    normal = _np(sepconv.sepconv_stack_reference(
        from_jax_numpy(p), torch.as_tensor(x).to(BF), sc_valid))
    assert np.mean(normal != got) > 0.01


def test_stack_lp_f32_is_the_normal_mode():
    p = from_jax_numpy(_stack(6, 18, [128, 128], 56))
    x = torch.as_tensor(_x(7, (2, H, W, 18)))
    for scv in (None, (5, 40)):
        torch.testing.assert_close(
            sepconv.fused_conv_stack(p, x, scv, lp_stencil=True),
            sepconv.fused_conv_stack(p, x, scv), rtol=0, atol=0)


def test_mxu_wins_over_lp():
    """Both modes on: the folded form, as JAX's _run_stack takes it."""
    p = from_jax_numpy(_stack(8, 10, [16], 8))
    x = torch.as_tensor(_x(9, (1, 7, 20, 10))).to(BF)
    torch.testing.assert_close(
        sepconv.fused_conv_stack(p, x, mxu=True, lp_stencil=True),
        sepconv.sepconv_stack_reference(p, x, mxu=True), rtol=0, atol=0)
    assert sepconv.mode_of(True, True) == "mxu"


# ---------------------------------------------------------------- K3/K4


def _inputs(seed, c_last=D_S):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(B, T, H, W, c_last)).astype(np.float32)
    pe = rng.normal(size=(T, H, W, 2)).astype(np.float32)
    return s, pe


def _iteration(params, mode, active, dtype, lp, jax_side=True):
    jp, tp = params
    s, pe = _inputs(1)
    act = np.broadcast_to(np.asarray(active, np.float32), (B, T)).copy()
    ro = {}, {}
    if mode == "readout":
        ro = ({"readout_p": jp["readout_llrs"][0],
               "chest_p": jp["readout_chest"]},
              {"readout_p": tp["readout_llrs"][0],
               "chest_p": tp["readout_chest"]})
    got = cgnn_iter.fused_iteration(
        tp["iterations"][0], torch.as_tensor(s).to(dtype),
        torch.as_tensor(pe), torch.as_tensor(act), lp_stencil=lp, **ro[1])
    got = [_np(g) for g in (got if mode == "readout" else (got,))]
    if not jax_side:
        return got
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_iteration(jp["iterations"][0], jnp.asarray(s).astype(jdt),
                         jnp.asarray(pe), jnp.asarray(act), interpret=True,
                         lp_stencil=lp, **ro[0])
    return got, [_np(w) for w in (want if mode == "readout" else (want,))]


@pytest.mark.parametrize("active", [(1, 1), (1, 0)])
@pytest.mark.parametrize("mode", ["state", "readout"])
def test_iteration_lp_bf16_matches_jax(cgnn_params, mode, active):
    got, want = _iteration(cgnn_params, mode, active, BF, True)
    for g, w in zip(got, want):
        _bf16_bar(g, w)


def _full(params, dtype, lp, jax_side=True):
    jp, tp = params
    z0, pe = _inputs(2, c_last=18)
    act = np.asarray([[1.0, 1.0], [1.0, 0.0]], np.float32)
    got = cgnn_iter.fused_cgnn_full(tp, torch.as_tensor(z0).to(dtype),
                                    torch.as_tensor(pe).to(dtype),
                                    torch.as_tensor(act), lp_stencil=lp)
    got = [_np(g) for g in got]
    if not jax_side:
        return got
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_full(jp, jnp.asarray(z0).astype(jdt),
                    jnp.asarray(pe).astype(jdt), jnp.asarray(act),
                    interpret=True, lp_stencil=lp)
    return got, [_np(w) for w in want]


def test_full_lp_bf16_matches_jax(cgnn_params):
    got, want = _full(cgnn_params, BF, True)
    for g, w in zip(got, want):
        _bf16_bar(g, w)


def test_iteration_and_full_lp_f32_are_the_normal_mode(cgnn_params):
    for mode in ("state", "readout"):
        for a, b in zip(*(_iteration(cgnn_params, mode, (1, 1),
                                     torch.float32, lp, jax_side=False)
                          for lp in (True, False))):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(*(_full(cgnn_params, torch.float32, lp, jax_side=False)
                      for lp in (True, False))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- refusals


def test_iteration_refuses_mxu_as_jax_does(cgnn_params, monkeypatch):
    jp, tp = cgnn_params
    s, pe = _inputs(3)
    act = np.ones((B, T), np.float32)
    with pytest.raises(ValueError, match="conv_mxu"):
        jax_iteration(jp["iterations"][0], jnp.asarray(s), jnp.asarray(pe),
                      jnp.asarray(act), interpret=True, mxu=True)
    args = (tp["iterations"][0], torch.as_tensor(s), torch.as_tensor(pe),
            torch.as_tensor(act))
    with pytest.raises(ValueError, match="conv_mxu"):
        cgnn_iter.fused_iteration(*args, mxu=True)
    cgnn_iter.fused_iteration(*args)  # the knob is unset: runs
    monkeypatch.setenv("NRX_CONV_MXU", "1")
    with pytest.raises(ValueError, match="conv_mxu"):
        cgnn_iter.fused_iteration(*args)
    cgnn_iter.fused_iteration(*args, mxu=False)  # an explicit False wins


def test_knobs_resolve_none(monkeypatch):
    assert not sepconv.mxu_default(None) and not sepconv.lp_default(None)
    assert sepconv.mxu_default(True) and sepconv.lp_default(True)
    p = from_jax_numpy(_stack(10, 18, [32], 16))
    x = torch.as_tensor(_x(11, (1, H, W, 18))).to(BF)
    monkeypatch.setenv("NRX_CONV_MXU", "1")
    monkeypatch.setenv("NRX_STENCIL_LP", "1")
    assert sepconv.mxu_default(None) and sepconv.lp_default(None)
    assert not sepconv.mxu_default(False) and not sepconv.lp_default(False)
    torch.testing.assert_close(
        sepconv.fused_conv_stack(p, x),
        sepconv.sepconv_stack_reference(p, x, mxu=True), rtol=0, atol=0)
    torch.testing.assert_close(
        sepconv.fused_conv_stack(p, x, mxu=False),
        sepconv.sepconv_stack_reference(p, x, lp_stencil=True), rtol=0,
        atol=0)
    monkeypatch.setenv("NRX_CONV_MXU", "0")
    monkeypatch.setenv("NRX_STENCIL_LP", "0")
    assert not sepconv.mxu_default(None) and not sepconv.lp_default(None)


# ---------------------------------------------------------------- routes


STACK_MXU, STACK_NORMAL = ("stack", True, False), ("stack", False, False)
ROUTE_CASES = {
    # name: (flags, env, dtype, (kernel, mxu, lp_stencil) each wrapper is
    # called with, resolved, in order: the init stack, then per iteration)
    "convs_mxu": ({"fused_convs": True, "conv_mxu": True}, {}, "f32",
                  [STACK_MXU, STACK_NORMAL, STACK_NORMAL]),
    "iteration_mxu_env_unset": ({"fused_convs": True,
                                 "fused_iteration": True,
                                 "conv_mxu": True}, {}, "f32",
                                [STACK_MXU, STACK_NORMAL, STACK_NORMAL]),
    "iteration_mxu_env_set": ({"fused_convs": True, "fused_iteration": True,
                               "conv_mxu": True}, {"NRX_CONV_MXU": "1"},
                              "f32", [STACK_MXU] * 3),
    "iteration_lp": ({"fused_convs": True, "fused_iteration": True,
                      "fused_readout": True, "stencil_lp": True}, {},
                     "bf16", [("stack", False, True),
                              ("iteration", False, True),
                              ("iteration", False, True)]),
    "full_lp": ({"fused_full": True, "stencil_lp": True}, {}, "bf16",
                [("full", False, True)]),
}


def _route_inputs():
    rng = np.random.default_rng(9)
    y = rng.normal(size=(B, H, W, 8)).astype(np.float32)
    h_hat = rng.normal(size=(B, T, H, W, 8)).astype(np.float32)
    pe = _inputs(10)[1]
    act = np.array([[1.0, 1.0], [1.0, 0.0]], np.float32)
    return y, pe, h_hat, act, np.ones((B, T, 1), np.float32)


def _jax_route(jp, flags, dtype):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        llrs, h_hats = jax_cgnn.cgnn_apply(
            jp, jax_cgnn.CGNNConfig(**WIDTHS, **flags),
            *map(jnp.asarray, _route_inputs()), dtype=dtype)
    return (_np(llrs[-1][0]), _np(h_hats[-1])), caught


def _spy_modes(monkeypatch):
    """The (kernel, mxu, lp_stencil) that cgnn_apply's calls of the stack,
    iteration and whole-CGNN wrappers resolve to, in call order."""
    seen = []
    stack, iteration, full = (sepconv.fused_conv_stack,
                              cgnn_iter.fused_iteration,
                              cgnn_iter.fused_cgnn_full)

    def spy_stack(p, x, sc_valid=None, mxu=None, lp_stencil=None):
        seen.append(("stack", sepconv.mxu_default(mxu),
                     sepconv.lp_default(lp_stencil)))
        return stack(p, x, sc_valid, mxu, lp_stencil)

    def spy_iteration(*args, mxu=None, lp_stencil=None, **kw):
        seen.append(("iteration", sepconv.mxu_default(mxu),
                     sepconv.lp_default(lp_stencil)))
        return iteration(*args, mxu=mxu, lp_stencil=lp_stencil, **kw)

    def spy_full(*args, lp_stencil=None, **kw):
        seen.append(("full", False, sepconv.lp_default(lp_stencil)))
        return full(*args, lp_stencil=lp_stencil, **kw)
    monkeypatch.setattr(port_cgnn, "fused_conv_stack", spy_stack)
    monkeypatch.setattr(cgnn_iter, "fused_iteration", spy_iteration)
    monkeypatch.setattr(cgnn_iter, "fused_cgnn_full", spy_full)
    return seen


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_cgnn_apply_mode_routes_match_jax(cgnn_params, monkeypatch, name):
    """Each route against JAX at the bars above, and the modes that reach
    its kernel wrappers pinned (the bars alone are wider than a mode's
    effect)."""
    flags, env, dt, modes = ROUTE_CASES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jp, tp = cgnn_params
    tdt, jdt = (torch.float32, jnp.float32) if dt == "f32" \
        else (BF, jnp.bfloat16)
    want, jax_warned = _jax_route(jp, flags, jdt)
    seen = _spy_modes(monkeypatch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        llrs, h_hats = port_cgnn.cgnn_apply(
            tp, port_cgnn.CGNNConfig(**WIDTHS, **flags),
            *map(torch.as_tensor, _route_inputs()), dtype=tdt)
    assert seen == modes
    got = (_np(llrs[-1][0]), _np(h_hats[-1]))
    mxu_warning = flags.get("fused_iteration") and flags.get("conv_mxu")
    assert bool([c for c in caught if "conv_mxu" in str(c.message)]) \
        == bool(mxu_warning)
    assert bool([c for c in jax_warned if "conv_mxu" in str(c.message)]) \
        == bool(mxu_warning)
    if dt == "f32":
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        return
    ref, _ = _jax_route(jp, flags, jnp.float32)
    for g, w, r in zip(got, want, ref):
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 0.1 * scale
        assert np.abs(g - w).mean() <= 3e-3 * scale
        assert np.abs(g - r).max() <= 1.5 * np.abs(w - r).max()


def test_explicit_config_modes_win_over_the_knobs(cgnn_params, monkeypatch):
    """conv_mxu=False in the config with NRX_CONV_MXU=1 set: the iteration
    kernel's route runs (JAX passes the config's mxu to fused_iteration),
    equal to the same route with the knob unset."""
    _, tp = cgnn_params
    cfg = port_cgnn.CGNNConfig(**WIDTHS, fused_convs=True,
                               fused_iteration=True, conv_mxu=False)
    args = tuple(map(torch.as_tensor, _route_inputs()))
    want = port_cgnn.cgnn_apply(tp, cfg, *args)
    monkeypatch.setenv("NRX_CONV_MXU", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = port_cgnn.cgnn_apply(tp, cfg, *args)
    for g, w in ((got[0][-1][0], want[0][-1][0]), (got[1][-1], want[1][-1])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_update_stacks_take_the_env_modes_alone(cgnn_params, monkeypatch):
    """fused_iteration with conv_mxu resolved true: the init stack runs in
    the config's modes, the non-fused iterations' update stacks in the env
    knobs' alone (the JAX package's _update_state passes no mode)."""
    _, tp = cgnn_params
    seen = []
    real = sepconv.fused_conv_stack

    def spy(p, x, sc_valid=None, mxu=None, lp_stencil=None):
        seen.append((x.shape[-1], sepconv.mxu_default(mxu),
                     sepconv.lp_default(lp_stencil)))
        return real(p, x, sc_valid, mxu, lp_stencil)
    monkeypatch.setattr(port_cgnn, "fused_conv_stack", spy)
    cfg = port_cgnn.CGNNConfig(**WIDTHS, fused_convs=True,
                               fused_iteration=True, conv_mxu=True,
                               stencil_lp=True)
    args = tuple(map(torch.as_tensor, _route_inputs()))
    with pytest.warns(UserWarning, match="conv_mxu"):
        port_cgnn.cgnn_apply(tp, cfg, *args)
    assert seen == [(18, True, True), (2 * D_S + 2, False, False),
                    (2 * D_S + 2, False, False)]
    seen.clear()
    monkeypatch.setenv("NRX_STENCIL_LP", "1")
    with pytest.warns(UserWarning, match="conv_mxu"):
        port_cgnn.cgnn_apply(tp, cfg, *args)
    assert seen == [(18, True, True), (2 * D_S + 2, False, True),
                    (2 * D_S + 2, False, True)]


# ---------------------------------------------------------------- folded


@pytest.mark.parametrize("sc_valid", [None, 40])
def test_folded_lowering_matches_jax(monkeypatch, sc_valid):
    monkeypatch.setattr(jax_cgnn, "_SEPCONV_FOLDED", True)
    monkeypatch.setattr(port_cgnn, "sepconv_folded", lambda: True)
    p, x = _stack(12, 114, [128, 128], 56), _x(13, (2, H, W, 114))
    r = _x(14, (2, H, W, 56))
    scv = None if sc_valid is None else jnp.int32(sc_valid)

    def loss(p):
        y = jax_cgnn._apply_conv_stack(p, jnp.asarray(x), "sepconv",
                                       sc_valid=scv)
        return jnp.sum(y * r), y
    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(p)
    tp = from_jax_numpy(p)
    leaves = [lp[k] for lp in tp["hidden"] + [tp["out"]]
              for k in ("dw", "pw", "b")]
    for leaf in leaves:
        leaf.requires_grad_(True)
    got = port_cgnn._apply_conv_stack(tp, torch.as_tensor(x),
                                      sc_valid=sc_valid)
    (got * torch.as_tensor(r)).sum().backward()
    want = np.asarray(want)
    assert np.abs(_np(got) - want).max() <= 1e-5 * np.abs(want).max()
    jax_leaves = [lp[k] for lp in grads["hidden"] + [grads["out"]]
                  for k in ("dw", "pw", "b")]
    for leaf, g in zip(leaves, jax_leaves):
        g = np.asarray(g)
        assert leaf.grad.shape == g.shape
        assert np.abs(leaf.grad.numpy() - g).max() <= 1e-4 * np.abs(g).max()


def test_folded_lowering_reaches_training(cgnn_params, monkeypatch):
    """cgnn_apply(training=True) takes the folded lowering for every stack
    under the knob, and the stacks' plain version without it."""
    _, tp = cgnn_params
    calls = []
    real = port_cgnn.sepconv_stack_folded
    monkeypatch.setattr(port_cgnn, "sepconv_stack_folded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = port_cgnn.CGNNConfig(**WIDTHS, fused_convs=True,
                               fused_iteration=True)
    args = tuple(map(torch.as_tensor, _route_inputs()))
    plain = port_cgnn.cgnn_apply(tp, cfg, *args, training=True)
    assert not calls
    monkeypatch.setenv("NRX_SEPCONV_FOLDED", "1")
    folded = port_cgnn.cgnn_apply(tp, cfg, *args, training=True)
    assert len(calls) == 1 + WIDTHS["num_it"]
    for a, b in zip((plain[0][-1][0], plain[1][-1]),
                    (folded[0][-1][0], folded[1][-1])):
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


# ---------------------------------------------------------------- CPU


def test_cpu_tensors_launch_no_kernel_in_any_mode(cgnn_params, monkeypatch):
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("built on CPU"))
    _, tp = cgnn_params
    before = (sepconv.launches, dict(sepconv.launches_by_mode),
              cgnn_iter.iter_launches, cgnn_iter.full_launches)
    p = from_jax_numpy(_stack(15, 18, [32], 16))
    x = torch.as_tensor(_x(16, (1, H, W, 18)))
    for dtype in (torch.float32, BF):
        for kw in ({"mxu": True}, {"lp_stencil": True}, {}):
            sepconv.fused_conv_stack(p, x.to(dtype), **kw)
    _iteration(cgnn_params, "state", (1, 1), BF, True, jax_side=False)
    _full(cgnn_params, BF, True, jax_side=False)
    assert (sepconv.launches, dict(sepconv.launches_by_mode),
            cgnn_iter.iter_launches, cgnn_iter.full_launches) == before


def test_folded_buffer_layout_and_launch(monkeypatch):
    """pack_stack_folded: pack_stack, zero-padded to 8 values, then per
    layer the nine folded matrices W_s (`folded_taps`), as B fragments in
    bfloat16 and as rows in float32, at the offsets make_stack_desc
    computes; the wrapper hands that buffer to a mode-2 launch."""
    p = from_jax_numpy(_stack(17, 18, [32], 16))
    layers = p["hidden"] + [p["out"]]
    for dtype in (BF, torch.float32):
        buf = sepconv.pack_stack_folded(p, dtype)
        assert sepconv.pack_stack_folded(p, dtype) is buf  # built once
        plain = sepconv.pack_stack(p, dtype)
        assert torch.equal(buf[:plain.numel()], plain)
        off = -(-plain.numel() // 8) * 8
        assert not buf[plain.numel():off].any()
        for lp in layers:
            taps = sepconv.folded_taps(lp, dtype)
            dw = lp["dw"].reshape(9, -1).to(dtype).float()
            assert torch.equal(taps, (dw[:, :, None] * lp["pw"].to(
                dtype).float()[None]).to(dtype))
            for w_s in taps:
                seg = sepconv.mma_fragments(w_s) if dtype == BF \
                    else w_s.reshape(-1)
                assert torch.equal(buf[off:off + seg.numel()], seg)
                off += seg.numel()
        assert buf.numel() == off
    seen = []

    def nrx_sepconv_stack(x, w, out, dtype, n, h, wc, n_layers, widths, lo,
                          hi, mode, stream):
        seen.append((w, dtype, mode, list(
            (ctypes.c_int * (n_layers + 1)).from_address(widths.value))))
        return 0
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(
        nrx_sepconv_stack=nrx_sepconv_stack))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    counts = dict(sepconv.launches_by_mode)
    for dtype in (BF, torch.float32):
        x = torch.zeros((1, H, W, 18), dtype=dtype)
        for mode in ("mxu", "lp", "normal"):
            sepconv._launch(p, x, None, mode)
            assert seen[-1] == (sepconv.stack_weights(p, dtype, mode)
                                .data_ptr(), sepconv._DTYPE_CODES[dtype],
                                sepconv.MODES[mode], [18, 32, 16])
    assert seen[0][0] == sepconv.pack_stack_folded(p, BF).data_ptr()
    for mode in counts:
        assert sepconv.launches_by_mode[mode] == counts[mode] + 2
