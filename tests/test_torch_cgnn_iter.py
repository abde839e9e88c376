"""PyTorch port's fused CGNN iteration (K3) and whole-CGNN kernel (K4) vs
the JAX Pallas kernels.

The port's plain versions (`fused_iteration_reference`,
`fused_cgnn_full_reference`: the CUDA kernels' oracles and CPU paths) are
held against JAX `fused_iteration` and `fused_cgnn_full` in Pallas interpret
mode, as tests/test_cgnn_iter_pallas.py runs them, on small widths with
randomized biases (so that MLP(0) on pad columns is not zero):

- K3 float32, state and readout modes, active (1, 1) and (1, 0), sc_valid
  None, an int and a (lo, hi) pair: rtol = atol = 2e-5, JAX's own bar
  (measured max 3.5e-7 of max |ref|).
- K4 float32: rtol = atol = 5e-5, the bar of JAX's own fused_full tests
  (measured 4.8e-7 of max |ref|); also at 8 iterations of nrx_large's
  widths, the most K4 takes.
- bfloat16: the bar of tests/test_torch_sepconv.py for the stack, max abs
  error <= 2**-6 of max |ref| and < 1 % of elements differing (measured:
  bit-identical, both sides round at the same points).
- The port's cgnn_apply on the fused routes (fused_iteration, with
  fused_readout, fused_full) vs JAX cgnn_apply with the same flags:
  float32, 5e-5, the bar of JAX's own route tests; and where a route does
  not fit the model (a two-hidden-layer aggregation MLP, apply_multiloss),
  its fallback against JAX's at the slice bar, 1e-4.

The CUDA kernels are held against the same plain versions on the GPU by
chip_smoke.py.
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
from neural_rx_tpu.rx.cgnn import CGNNConfig, init_cgnn_params
from neural_rx_tpu_torch.kernels import _build, cgnn_iter, sepconv
from neural_rx_tpu_torch.weights import from_jax_numpy

B, T, H, W, D_S = 2, 2, 14, 48, 24


@pytest.fixture(scope="module")
def params():
    """Small CGNN tree (d_s 24, 1-hidden MLPs) with randomized biases, as
    numpy leaves for JAX and as the port's torch tree."""
    cfg = CGNNConfig(num_bits_per_symbol=(4,), num_rx_ant=4, num_it=2,
                     d_s=D_S, num_units_init=(32,),
                     num_units_agg=((16,),) * 2,
                     num_units_state=((32,),) * 2, num_units_readout=(16,))
    leaves, treedef = jax.tree.flatten(
        init_cgnn_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    tree = jax.tree.unflatten(treedef, [
        0.5 * rng.normal(size=x.shape).astype(np.float32) if x.ndim == 1
        else np.asarray(x) for x in leaves])
    return tree, from_jax_numpy(tree)


def _inputs(seed, c_last=D_S):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(B, T, H, W, c_last)).astype(np.float32)
    pe = rng.normal(size=(T, H, W, 2)).astype(np.float32)
    return s, pe


def _jax_valid(sc_valid):
    return None if sc_valid is None else jnp.asarray(sc_valid, jnp.int32)


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


def _iteration_pair(params, mode, active, sc_valid, dtype):
    """(port outputs, JAX outputs) of one iteration as float32 numpy."""
    jp, tp = params
    s, pe = _inputs(1)
    act = np.broadcast_to(np.asarray(active, np.float32), (B, T)).copy()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ro = {}, {}
    if mode == "readout":
        ro = ({"readout_p": jp["readout_llrs"][0],
               "chest_p": jp["readout_chest"]},
              {"readout_p": tp["readout_llrs"][0],
               "chest_p": tp["readout_chest"]})
    want = jax_iteration(jp["iterations"][0], jnp.asarray(s).astype(jdt),
                         jnp.asarray(pe), jnp.asarray(act),
                         sc_valid=_jax_valid(sc_valid), interpret=True,
                         **ro[0])
    got = cgnn_iter.fused_iteration(
        tp["iterations"][0], torch.as_tensor(s).to(dtype),
        torch.as_tensor(pe), torch.as_tensor(act), sc_valid, **ro[1])
    if mode == "state":
        want, got = (want,), (got,)
    return [_np(g) for g in got], [_np(w) for w in want]


@pytest.mark.parametrize("sc_valid", [None, 40, (3, 45)])
@pytest.mark.parametrize("active", [(1, 1), (1, 0)])
@pytest.mark.parametrize("mode", ["state", "readout"])
def test_iteration_matches_jax(params, mode, active, sc_valid):
    got, want = _iteration_pair(params, mode, active, sc_valid,
                                torch.float32)
    assert len(got) == (1 if mode == "state" else 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)
    if mode == "state" and sc_valid is not None:
        # pad columns: the stack adds nothing, the state passes through
        lo, hi = (0, sc_valid) if isinstance(sc_valid, int) else sc_valid
        s, _ = _inputs(1)
        np.testing.assert_array_equal(got[0][:, :, :, hi:], s[:, :, :, hi:])
        np.testing.assert_array_equal(got[0][:, :, :, :lo], s[:, :, :, :lo])


@pytest.mark.parametrize("mode,sc_valid", [("state", None),
                                           ("readout", (3, 45))])
def test_iteration_bf16_matches_jax(params, mode, sc_valid):
    got, want = _iteration_pair(params, mode, (1, 1), sc_valid,
                                torch.bfloat16)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 2.0**-6 * np.abs(w).max()
        assert np.mean(g != w) < 0.01


def _full_pair(params, active, sc_valid, dtype):
    jp, tp = params
    z0, pe = _inputs(2, c_last=18)
    act = np.broadcast_to(np.asarray(active, np.float32), (B, T)).copy()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_full(jp, jnp.asarray(z0).astype(jdt),
                    jnp.asarray(pe).astype(jdt), jnp.asarray(act),
                    sc_valid=_jax_valid(sc_valid), interpret=True)
    got = cgnn_iter.fused_cgnn_full(tp, torch.as_tensor(z0).to(dtype),
                                    torch.as_tensor(pe).to(dtype),
                                    torch.as_tensor(act), sc_valid)
    return [_np(g) for g in got], [_np(w) for w in want]


@pytest.mark.parametrize("active,sc_valid", [((1, 1), None), ((1, 0), 40),
                                             ((1, 1), (3, 45))])
def test_full_matches_jax(params, active, sc_valid):
    got, want = _full_pair(params, active, sc_valid, torch.float32)
    assert got[0].shape == (B, T, H, W, 4) and got[1].shape == (B, T, H, W, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-5)


def test_full_bf16_matches_jax(params):
    got, want = _full_pair(params, (1, 1), 40, torch.bfloat16)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 2.0**-6 * np.abs(w).max()
        assert np.mean(g != w) < 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_is_stack_then_iterations(params, dtype):
    """K4's plain version is exactly the init stack's plain version followed
    by K3's per iteration, the last one with both readouts."""
    _, tp = params
    z0, pe = _inputs(3, c_last=18)
    z0, pe = torch.as_tensor(z0).to(dtype), torch.as_tensor(pe).to(dtype)
    act = torch.tensor([[1.0, 1.0], [1.0, 0.0]])
    s = sepconv.sepconv_stack_reference(
        tp["s_init"][0], z0.reshape((B * T, H, W, 18)), (2, 44))
    s = cgnn_iter.fused_iteration_reference(
        tp["iterations"][0], s.reshape(B, T, H, W, D_S), pe, act, (2, 44))
    want = cgnn_iter.fused_iteration_reference(
        tp["iterations"][1], s, pe, act, (2, 44),
        tp["readout_llrs"][0], tp["readout_chest"])
    got = cgnn_iter.fused_cgnn_full_reference(tp, z0, pe, act, (2, 44))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    one = cgnn_iter.fused_cgnn_full_reference(tp, z0, pe, act, num_it=1)
    assert one[0].shape == got[0].shape


def test_cpu_tensors_take_plain_versions(params, monkeypatch):
    """On CPU tensors both wrappers run their plain versions: nothing is
    built or loaded and the launch counts do not move."""
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("built on CPU"))
    _, tp = params
    s, pe = (torch.as_tensor(x) for x in _inputs(4))
    act = torch.ones(B, T)
    before = cgnn_iter.iter_launches, cgnn_iter.full_launches
    got = cgnn_iter.fused_iteration(tp["iterations"][1], s, pe, act, 30)
    want = cgnn_iter.fused_iteration_reference(tp["iterations"][1], s, pe,
                                               act, 30)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    z0 = torch.as_tensor(_inputs(5, c_last=18)[0])
    got = cgnn_iter.fused_cgnn_full(tp, z0, pe, act)
    want = cgnn_iter.fused_cgnn_full_reference(tp, z0, pe, act)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (cgnn_iter.iter_launches, cgnn_iter.full_launches) == before


def test_packed_mlp_layout(params):
    """w1 [in][hid], b1 [hid], w2 [hid][out], b2 [out], packed once."""
    jp, tp = params
    p = tp["iterations"][0]["agg"]
    buf = cgnn_iter.pack_mlp(p, torch.bfloat16)
    assert buf.dtype == torch.bfloat16 and buf.is_contiguous()
    assert cgnn_iter.pack_mlp(p, torch.bfloat16) is buf
    off = 0
    jagg = jp["iterations"][0]["agg"]
    for a in (jagg["hidden"][0]["w"], jagg["hidden"][0]["b"],
              jagg["out"]["w"], jagg["out"]["b"]):
        seg = buf[off:off + a.size].float().numpy().reshape(a.shape)
        np.testing.assert_array_equal(
            seg, torch.tensor(a).to(torch.bfloat16).float().numpy())
        off += a.size
    assert off == buf.numel()


def test_kernel_wrappers_reject_what_the_kernels_cannot_take(params):
    _, tp = params
    it_p = tp["iterations"][0]
    s, pe = (torch.as_tensor(x) for x in _inputs(6))
    act = torch.ones(B, T)
    with pytest.raises(TypeError):
        cgnn_iter._launch_iteration(it_p, s.half(), pe, act, None, None,
                                    None)
    with pytest.raises(ValueError):  # pe of another width
        cgnn_iter._launch_iteration(it_p, s, pe[:, :, :40], act, None, None,
                                    None)
    with pytest.raises(ValueError):  # state of another depth
        cgnn_iter._launch_iteration(it_p, s[..., :20].contiguous(), pe, act,
                                    None, None, None)
    with pytest.raises(ValueError):
        cgnn_iter._launch_full(tp, s, pe, act, None, 2)  # z0 of 24 channels
    with pytest.raises(ValueError):
        cgnn_iter.fused_iteration(it_p, s, pe, act, chest_p=tp[
            "readout_chest"])
    two = {"hidden": [it_p["agg"]["hidden"][0]] * 2, "out": it_p["agg"][
        "out"]}
    with pytest.raises(ValueError, match="one hidden layer"):
        cgnn_iter.fused_iteration({"agg": two, "update": it_p["update"]}, s,
                                  pe, act)


@pytest.fixture(scope="module")
def deep_params():
    """The fixture's widths with a two-hidden-layer aggregation MLP in the
    first iteration (the second keeps one), randomized biases."""
    cfg = CGNNConfig(num_bits_per_symbol=(4,), num_rx_ant=4, num_it=2,
                     d_s=D_S, num_units_init=(32,),
                     num_units_agg=((16, 16), (16,)),
                     num_units_state=((32,),) * 2, num_units_readout=(16,))
    leaves, treedef = jax.tree.flatten(
        init_cgnn_params(jax.random.PRNGKey(1), cfg))
    rng = np.random.default_rng(6)
    tree = jax.tree.unflatten(treedef, [
        0.5 * rng.normal(size=x.shape).astype(np.float32) if x.ndim == 1
        else np.asarray(x) for x in leaves])
    return cfg.num_units_agg, tree, from_jax_numpy(tree)


# flags (with fused_convs), deep aggregation MLP, apply_multiloss ->
# wrapper calls: stack kernel (the init stack, and a plain iteration's
# update stack), iteration kernel (without, with readouts), whole CGNN
FALLBACKS = {
    "iteration_deep": (("fused_iteration",), True, False, (2, 1, 0, 0)),
    "readout_deep": (("fused_iteration", "fused_readout"), True, False,
                     (2, 0, 1, 0)),
    "full_deep": (("fused_full",), True, False, (3, 0, 0, 0)),
    "full_multiloss": (("fused_full",), False, True, (3, 0, 0, 0)),
    "readout_multiloss": (("fused_iteration", "fused_readout"), False, True,
                          (1, 2, 0, 0))}


@pytest.mark.parametrize("case", FALLBACKS)
def test_cgnn_apply_fused_routes_fall_back_as_jax(params, deep_params, case,
                                                  monkeypatch):
    """A fused route the model does not fit falls back as the JAX package's
    does: an iteration whose aggregation MLP has two hidden layers runs
    plain layers (the other one the iteration kernel), the whole-CGNN
    kernel needs one-hidden-layer MLPs and no apply_multiloss, the fused
    readout no apply_multiloss. The wrappers called are those JAX's gates
    imply, and the result matches JAX cgnn_apply on the same flags
    (float32, a bucket-padded grid, one user inactive) at the slice bar,
    1e-4 of max |JAX|."""
    from neural_rx_tpu.rx.cgnn import cgnn_apply as jax_apply
    from neural_rx_tpu_torch.rx import cgnn as port_cgnn
    flags, deep, multiloss, want_calls = FALLBACKS[case]
    agg, jp, tp = deep_params if deep else (((16,),) * 2,) + params
    widths = dict(num_bits_per_symbol=(4,), num_rx_ant=4, num_it=2, d_s=D_S,
                  num_units_init=(32,), num_units_agg=agg,
                  num_units_state=((32,),) * 2, num_units_readout=(16,),
                  fused_convs=True, **dict.fromkeys(flags, True))
    calls = {"stack": 0, "iteration": 0, "readout": 0, "full": 0}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*args, **kwargs):
            readout = len(args) > 5 or kwargs.get("readout_p") is not None
            calls["readout" if key == "iteration" and readout else key] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapped)
    spy(port_cgnn, "fused_conv_stack", "stack")
    spy(cgnn_iter, "fused_iteration", "iteration")
    spy(cgnn_iter, "fused_cgnn_full", "full")
    rng = np.random.default_rng(9)
    y = rng.normal(size=(B, H, W, 8)).astype(np.float32)
    h_hat = rng.normal(size=(B, T, H, W, 8)).astype(np.float32)
    pe = _inputs(10)[1]
    act = np.array([[1.0, 1.0], [1.0, 0.0]], np.float32)
    mm = np.ones((B, T, 1), np.float32)
    want = jax_apply(jp, CGNNConfig(**widths),
                     *map(jnp.asarray, (y, pe, h_hat, act, mm)),
                     sc_valid=jnp.int32(40), apply_multiloss=multiloss)
    got = port_cgnn.cgnn_apply(
        tp, port_cgnn.CGNNConfig(**widths),
        *map(torch.as_tensor, (y, pe, h_hat, act, mm)), sc_valid=40,
        apply_multiloss=multiloss)
    assert tuple(calls.values()) == want_calls, calls
    assert len(got[0]) == len(want[0]) == 1
    for g, w in ((got[0][-1][0], want[0][-1][0]), (got[1][-1], want[1][-1])):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("flags", [("fused_iteration",),
                                   ("fused_iteration", "fused_readout"),
                                   ("fused_full",)])
def test_cgnn_apply_fused_routes_match_jax(params, flags):
    """The port's cgnn_apply on each fused route vs JAX cgnn_apply with the
    same flags (interpret mode), float32, one user inactive in the second
    batch item and a bucket-padded grid: rtol = atol = 5e-5, the bar of
    JAX's own route tests (tests/test_cgnn_iter_pallas.py)."""
    from neural_rx_tpu.rx.cgnn import cgnn_apply as jax_apply
    from neural_rx_tpu_torch.rx.cgnn import CGNNConfig as PortConfig
    from neural_rx_tpu_torch.rx.cgnn import cgnn_apply
    jp, tp = params
    widths = dict(num_bits_per_symbol=(4,), num_rx_ant=4, num_it=2, d_s=D_S,
                  num_units_init=(32,), num_units_agg=((16,),) * 2,
                  num_units_state=((32,),) * 2, num_units_readout=(16,))
    on = dict.fromkeys(flags, True)
    rng = np.random.default_rng(9)
    y = rng.normal(size=(B, H, W, 8)).astype(np.float32)
    h_hat = rng.normal(size=(B, T, H, W, 8)).astype(np.float32)
    pe = _inputs(10)[1]
    act = np.array([[1.0, 1.0], [1.0, 0.0]], np.float32)
    mm = np.ones((B, T, 1), np.float32)
    want = jax_apply(jp, CGNNConfig(**widths, fused_convs=True, **on),
                     *map(jnp.asarray, (y, pe, h_hat, act, mm)),
                     sc_valid=jnp.int32(40))
    got = cgnn_apply(tp, PortConfig(**widths, fused_convs=True, **on),
                     *map(torch.as_tensor, (y, pe, h_hat, act, mm)),
                     sc_valid=40)
    for g, w in ((got[0][-1][0], want[0][-1][0]), (got[1][-1], want[1][-1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5,
                                   atol=5e-5)


def test_full_cgnn_reference_8_iterations_matches_jax():
    """K4's plain version at 8 iterations (the most of any shipped
    configuration, nrx_large's widths: init 18 -> 128 -> 128 -> 56, update
    stacks 114 -> 128 -> 128 -> 56, JAX's init) against JAX
    fused_cgnn_full in interpret mode, float32, rtol = atol = 5e-5; the
    launch wrapper takes up to 8 iterations and refuses 9."""
    cfg = CGNNConfig(num_bits_per_symbol=(4,), num_rx_ant=4, num_it=8,
                     d_s=56, num_units_init=(128, 128),
                     num_units_agg=((64,),) * 8,
                     num_units_state=((128, 128),) * 8,
                     num_units_readout=(128,))
    jp = jax.jit(lambda k: init_cgnn_params(k, cfg))(jax.random.PRNGKey(4))
    tp = from_jax_numpy(jp)
    rng = np.random.default_rng(8)
    z0 = rng.normal(size=(1, T, H, W, 18)).astype(np.float32)
    pe = rng.normal(size=(T, H, W, 2)).astype(np.float32)
    act = np.ones((1, T), np.float32)
    want = jax_full(jp, *map(jnp.asarray, (z0, pe, act)), interpret=True)
    got = cgnn_iter.fused_cgnn_full_reference(
        tp, *map(torch.as_tensor, (z0, pe, act)), num_it=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5,
                                   atol=5e-5)
    assert cgnn_iter.MAX_ITERATIONS == 8
    with pytest.raises(ValueError, match="1 to 8 iterations"):
        cgnn_iter._launch_full(tp, torch.as_tensor(z0), torch.as_tensor(pe),
                               torch.as_tensor(act), None, 9)
