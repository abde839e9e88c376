"""The weights of the tensor-core CGNN tiles as the kernels read them.

For bfloat16 the wrappers in `neural_rx_tpu_torch/kernels/cgnn_iter.py`
and `kernels/sepconv.py` append to each packed MLP and stack buffer the B
fragments of every product (`mma_fragments`), which `csrc/nrx_tile.cuh`
loads one 16-byte word per lane and k-step, and `csrc/nrx_tile.cuh` finds
them at offsets it computes from the widths alone (`make_mlp_desc`,
`make_stack_desc`). These CPU tests decode the fragments with the layout
written out independently and hold the offsets to that rule, and check
which buffer the stack kernel's wrapper hands to the launch. No kernel
runs here.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from neural_rx_tpu_torch import weights
from neural_rx_tpu_torch.kernels import _build, cgnn_iter, sepconv
from neural_rx_tpu_torch.kernels.sepconv import pack_stack

BF = torch.bfloat16


def frag_size(c_in, c_out):
    """Values of one product's fragments: 16-wide slabs x 16-deep k-steps
    x 32 lanes x 8 values (csrc/nrx_tile.cuh, frag_size)."""
    return -(-c_out // 16) * -(-c_in // 16) * 32 * 8


def decode(frag, c_in, c_out):
    """w [c_in, c_out] back from the fragments, walking the layout as the
    kernel's lanes read it: slab, k-step, lane 4 g + q, then (j, hf, e)
    for w[16 s + 8 hf + 2 q + e][16 slab + 8 j + g]; values that fall
    in the padding must be zero."""
    steps, slabs = -(-c_in // 16), -(-c_out // 16)
    f = frag.float().numpy().reshape(slabs, steps, 32, 2, 2, 2)
    w = np.zeros((16 * steps, 16 * slabs), dtype=np.float32)
    for slab in range(slabs):
        for s in range(steps):
            for lane in range(32):
                g, q = divmod(lane, 4)
                for j in range(2):
                    for hf in range(2):
                        for e in range(2):
                            k = 16 * s + 8 * hf + 2 * q + e
                            n = 16 * slab + 8 * j + g
                            w[k, n] = f[slab, s, lane, j, hf, e]
    assert not w[c_in:].any() and not w[:, c_out:].any()
    return w[:c_in, :c_out]


@pytest.mark.parametrize("c_in, c_out", [
    (18, 128), (114, 128), (128, 56), (56, 64), (64, 56), (128, 4),
    (128, 8), (5, 3), (130, 128), (10, 128)])
def test_fragments_hold_the_weights(c_in, c_out):
    rng = np.random.default_rng(c_in * 1000 + c_out)
    w = torch.as_tensor(rng.standard_normal((c_in, c_out)),
                        dtype=torch.float32).to(BF)
    frag = sepconv.mma_fragments(w)
    assert frag.dtype == BF and frag.numel() == frag_size(c_in, c_out)
    np.testing.assert_array_equal(decode(frag, c_in, c_out), w.float().numpy())


@pytest.fixture(scope="module")
def cgnn():
    return weights.load(weights.NRX_RT_EMA, device="cpu")


def mlps(cgnn):
    return ([it["agg"] for it in cgnn["iterations"]]
            + [cgnn["readout_llrs"][0], cgnn["readout_chest"]])


def stacks(cgnn):
    return [cgnn["s_init"][0]] + [it["update"] for it in cgnn["iterations"]]


def test_mlp_buffer_layout(cgnn):
    for p in mlps(cgnn):
        (w1, b1), (w2, b2) = [(d["w"], d["b"]) for d in
                              (p["hidden"][0], p["out"])]
        i, h = w1.shape
        o = w2.shape[1]
        buf = cgnn_iter.pack_mlp_mma(p)
        plain = i * h + h + h * o + o
        f1 = -(-plain // 8) * 8  # make_mlp_desc
        f2 = f1 + frag_size(i, h)
        assert buf.dtype == BF and buf.numel() == f2 + frag_size(h, o)
        assert torch.equal(buf[:plain], cgnn_iter.pack_mlp(p, BF))
        assert not buf[plain:f1].any()
        np.testing.assert_array_equal(decode(buf[f1:f2], i, h),
                                      w1.to(BF).float().numpy())
        np.testing.assert_array_equal(decode(buf[f2:], h, o),
                                      w2.to(BF).float().numpy())


def test_stack_buffer_layout(cgnn):
    for p in stacks(cgnn):
        layers = list(p["hidden"]) + [p["out"]]
        buf = sepconv.pack_stack_mma(p)
        plain = sum(9 * lp["pw"].shape[0] + lp["pw"].numel()
                    + lp["pw"].shape[1] for lp in layers)
        assert torch.equal(buf[:plain], pack_stack(p, BF))
        off = -(-plain // 8) * 8  # make_stack_desc's frag_off[0]
        for lp in layers:
            c_in, c_out = lp["pw"].shape
            n = frag_size(c_in, c_out)
            np.testing.assert_array_equal(
                decode(buf[off:off + n], c_in, c_out),
                lp["pw"].to(BF).float().numpy())
            off += n
        assert buf.numel() == off


def test_packed_buffers_are_built_once(cgnn):
    p = cgnn["iterations"][0]
    assert cgnn_iter.pack_mlp_mma(p["agg"]) is cgnn_iter.pack_mlp_mma(p["agg"])
    assert sepconv.pack_stack_mma(p["update"]) is \
        sepconv.pack_stack_mma(p["update"])
    # the float32 and plain bf16 buffers stay as they were
    assert cgnn_iter.pack_mlp(p["agg"], BF).numel() == 56 * 64 + 64 + 64 * 56 + 56


def test_stack_launch_takes_the_fragment_buffer(cgnn, monkeypatch):
    """The stack kernel's wrapper hands the bfloat16 launch
    `pack_stack_mma`'s buffer (the tensor-core tile reads its fragments)
    and the float32 launch `pack_stack`'s, with the widths the offsets come
    from. The init stack (18 -> 128 -> 128 -> 56) pads its first layer's
    18 input channels to two 16-deep k-steps with zeros."""
    seen = []

    def nrx_sepconv_stack(x, w, out, dtype, n, h, wc, n_layers, widths, lo,
                          hi, mode, stream):
        arr = (ctypes.c_int * (n_layers + 1)).from_address(widths.value)
        seen.append((w, dtype, list(arr)))
        return 0
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(
        nrx_sepconv_stack=nrx_sepconv_stack))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    p = cgnn["s_init"][0]
    for dtype, want in ((BF, sepconv.pack_stack_mma(p)),
                        (torch.float32, pack_stack(p, torch.float32))):
        x = torch.zeros((2, 14, 48, 18), dtype=dtype)
        before = sepconv.launches
        out = sepconv._launch(p, x, None)
        assert sepconv.launches == before + 1
        assert out.shape == (2, 14, 48, 56) and out.dtype == dtype
        assert seen[-1] == (want.data_ptr(), sepconv._DTYPE_CODES[dtype],
                            [18, 128, 128, 56])
    buf = sepconv.pack_stack_mma(p)
    off = -(-pack_stack(p, BF).numel() // 8) * 8  # frag_off[0]
    # two 16-deep k-steps for the first layer's 18 channels, the 14 pad
    # rows zero (decode asserts it)
    assert frag_size(18, 128) == 8 * 2 * 32 * 8
    decode(buf[off:off + frag_size(18, 128)], 18, 128)
    for lp in list(p["hidden"]) + [p["out"]]:
        frag = sepconv.mma_fragments(lp["pw"].to(BF))
        assert torch.equal(buf[off:off + frag.numel()], frag)
        off += frag.numel()
    assert buf.numel() == off
