"""PyTorch port's separable-conv stack vs the JAX Pallas kernels.

The port's plain version (`sepconv_stack_reference`, the CUDA kernel's
oracle and CPU path) is held against JAX `fused_conv_stack` and
`fused_conv_stack_blocked(w_blk=16)`, both in Pallas interpret mode, as
tests/test_sepconv_pallas.py runs them: float32 at JAX's own 2e-5 bar,
with sc_valid as an int and as a (lo, hi) pair. The CUDA kernel itself is
held against the same plain version on the GPU by chip_smoke.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.kernels.sepconv_pallas import (fused_conv_stack as
                                                  jax_fused_stack,
                                                  fused_conv_stack_blocked)
from neural_rx_tpu_torch.kernels import _build, sepconv
from neural_rx_tpu_torch.weights import from_jax_numpy


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


def _port(p_np, x_np, sc_valid=None, dtype=torch.float32):
    out = sepconv.sepconv_stack_reference(
        from_jax_numpy(p_np), torch.as_tensor(x_np).to(dtype), sc_valid)
    assert out.dtype == dtype
    return out.float().numpy()


CASES = [
    ((2, 14, 48, 18), 18, [128, 128], 56),    # nrx_rt state-init stack
    ((1, 14, 48, 114), 114, [128, 128], 56),  # nrx_rt update stack
    ((3, 7, 36, 10), 10, [32], 8),            # odd sizes
]


@pytest.mark.parametrize("shape,cin,hidden,cout", CASES)
def test_matches_jax_whole(shape, cin, hidden, cout):
    p, x = _stack(0, cin, hidden, cout), _x(1, shape)
    want = np.asarray(jax_fused_stack(p, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(_port(p, x), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sc_valid", [None, 40, (3, 45)])
def test_matches_jax_blocked(sc_valid):
    p, x = _stack(2, 18, [128, 128], 56), _x(3, (2, 14, 48, 18))
    scv = None if sc_valid is None else jnp.asarray(sc_valid, jnp.int32)
    want = np.asarray(fused_conv_stack_blocked(
        p, jnp.asarray(x), w_blk=16, interpret=True, sc_valid=scv))
    got = _port(p, x, sc_valid)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    if sc_valid is not None:
        lo, hi = (0, sc_valid) if isinstance(sc_valid, int) else sc_valid
        assert not got[:, :, :lo].any() and not got[:, :, hi:].any()


@pytest.mark.parametrize("sc_valid", [37, (5, 30)])
def test_sc_valid_matches_jax_whole(sc_valid):
    p, x = _stack(4, 10, [32], 8), _x(5, (2, 7, 36, 10))
    want = np.asarray(jax_fused_stack(
        p, jnp.asarray(x), interpret=True,
        sc_valid=jnp.asarray(sc_valid, jnp.int32)))
    np.testing.assert_allclose(_port(p, x, sc_valid), want,
                               rtol=2e-5, atol=2e-5)


def test_bf16_matches_jax_rounding():
    """bfloat16 activations and weights: the depthwise sums match bit for
    bit; the pointwise sums run in another order (oneDNN vs Eigen), which
    flips the last bit of an occasional rounded activation. Bar: 4 bf16
    ulps of the largest output (2**-6 of max |ref|)."""
    p, x = _stack(6, 18, [128, 128], 56), _x(7, (2, 14, 48, 18))
    want = np.asarray(jax_fused_stack(
        p, jnp.asarray(x).astype(jnp.bfloat16),
        interpret=True).astype(jnp.float32))
    got = _port(p, x, dtype=torch.bfloat16)
    assert np.abs(got - want).max() <= 2.0**-6 * np.abs(want).max()
    assert np.mean(got != want) < 0.01


def test_relu_only_on_hidden_layers():
    p, x = _stack(8, 6, [16], 4), _x(9, (1, 6, 24, 6))
    got = _port(p, x)
    assert (got < 0).any()  # linear output layer keeps negatives
    p1 = {"hidden": [], "out": p["hidden"][0]}
    assert (_port(p1, x) < 0).any()


def test_cpu_tensor_takes_plain_version(monkeypatch):
    """On a CPU tensor the wrapper runs the plain version: nothing is
    built or loaded and the launch count does not move."""
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("built on CPU"))
    p = from_jax_numpy(_stack(10, 10, [32], 8))
    x = torch.as_tensor(_x(11, (2, 7, 36, 10)))
    before = sepconv.launches
    got = sepconv.fused_conv_stack(p, x, sc_valid=(2, 30))
    assert sepconv.launches == before
    torch.testing.assert_close(
        got, sepconv.sepconv_stack_reference(p, x, (2, 30)), rtol=0, atol=0)


def test_valid_range_forms():
    assert sepconv._valid_range(None, 48) == (0, 48)
    assert sepconv._valid_range(40, 48) == (0, 40)
    assert sepconv._valid_range((3, 45), 48) == (3, 45)
    with pytest.raises(ValueError):
        sepconv._valid_range((1, 2, 3), 48)


def test_packed_layout():
    """The packed buffer is, per layer, dw [9][C], pw [C][O], b [O] — the
    offsets `nrx_sepconv_stack` computes from the widths."""
    p_np = _stack(12, 10, [32, 16], 8)
    p = from_jax_numpy(p_np)
    buf = sepconv.pack_stack(p, torch.bfloat16)
    assert buf.dtype == torch.bfloat16 and buf.is_contiguous()
    assert sepconv.pack_stack(p, torch.bfloat16) is buf  # packed once
    off = 0
    for lp in p_np["hidden"] + [p_np["out"]]:
        for a in (lp["dw"].reshape(9, -1), lp["pw"], lp["b"]):
            seg = buf[off:off + a.size].float().numpy().reshape(a.shape)
            np.testing.assert_array_equal(
                seg, torch.as_tensor(a).to(torch.bfloat16).float().numpy())
            off += a.size
    assert off == buf.numel()


def test_kernel_rejects_what_it_cannot_take(monkeypatch):
    """Refused before any launch: another dtype, widths that do not chain,
    and in bfloat16 a layer of more than 256 input channels (the
    tensor-core tile's limit), which float32 still takes; e2e_rt's 130
    channels go to the bfloat16 launch."""
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("launched"))
    p = from_jax_numpy(_stack(13, 10, [32], 8))
    x = torch.zeros((1, 7, 36, 10), dtype=torch.float16)
    with pytest.raises(TypeError):
        sepconv._launch(p, x, None)
    x = torch.zeros((1, 7, 36, 12))
    with pytest.raises(ValueError):
        sepconv._launch(p, x, None)
    wide = from_jax_numpy(_stack(14, 257, [32], 8))
    x = torch.zeros((1, 7, 36, 257))
    before = sepconv.launches
    with pytest.raises(ValueError, match="256 input channels"):
        sepconv._launch(wide, x.to(torch.bfloat16), None)
    assert sepconv.launches == before
    launched = []
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(
        nrx_sepconv_stack=lambda *a: launched.append(a[3]) or 0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    assert sepconv._launch(wide, x, None).shape == (1, 7, 36, 8)
    e2e = from_jax_numpy(_stack(15, 130, [128], 64))
    x130 = torch.zeros((1, 7, 36, 130), dtype=torch.bfloat16)
    assert sepconv._launch(e2e, x130, None).shape == (1, 7, 36, 64)
    assert launched == [0, 1]  # dtype codes: float32, bfloat16
