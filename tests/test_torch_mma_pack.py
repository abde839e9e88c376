"""The weights of the CGNN tiles as the kernels read them, and the float32
tile's shared-memory rule.

For bfloat16 the wrappers in `neural_rx_tpu_torch/kernels/cgnn_iter.py`
and `kernels/sepconv.py` append to each packed MLP and stack buffer the B
fragments of every product (`mma_fragments`), which `csrc/nrx_tile.cuh`
loads one 16-byte word per lane and k-step; for float32 they append each
product's weights as padded rows (`cuda_core_rows`), which the CUDA-core
tile stages in shared memory and reads a quad of channels at a time.
`csrc/nrx_tile.cuh` finds both at offsets it computes from the widths
alone (`make_mlp_desc`, `make_stack_desc`).
These CPU tests decode both layouts with the rules written out
independently and hold the offsets to them, check which buffer the stack
kernel's wrapper hands to the launch, and re-derive the float32 tile's
width and shared memory at nrx_rt's widths from the C side's rules
(`stack_w_tile`, `stack_smem`, `iter_layout`). No kernel runs here.
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
    and the float32 launch `pack_stack_rows`'s (the CUDA-core tile reads
    its padded rows), with the widths the offsets come from. The init stack (18 -> 128 -> 128 -> 56) pads its first layer's
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
                        (torch.float32, sepconv.pack_stack_rows(p))):
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


# ---------------------------------------------------------------- float32

OPTIN = 232448  # the H100's opt-in shared memory a block, bytes
N_SYM, N_SC = 14, 1584


def rows_decode(rows, c_in, c_out):
    """w [c_in, c_out] back from `cuda_core_rows`: per input channel two
    halves of G quads (G = ceil(c_out / 8)), value e of quad g of half h
    is w[c][g + (4 h + e) G]; values past c_out must be zero."""
    groups = -(-c_out // 8)
    r = rows.float().numpy().reshape(c_in, 2, groups, 4)
    w = np.zeros((c_in, 8 * groups), dtype=np.float32)
    for h in range(2):
        for g in range(groups):
            for e in range(4):
                w[:, g + (4 * h + e) * groups] = r[:, h, g, e]
    assert not w[:, c_out:].any()
    return w[:, :c_out]


@pytest.mark.parametrize("c_in, c_out", [
    (18, 128), (114, 128), (128, 56), (56, 64), (64, 56), (128, 4),
    (128, 8), (5, 3), (130, 128), (10, 13)])
def test_cuda_core_rows_hold_the_weights(c_in, c_out):
    rng = np.random.default_rng(c_in * 1000 + c_out)
    w = torch.as_tensor(rng.standard_normal((c_in, c_out)),
                        dtype=torch.float32)
    rows = sepconv.cuda_core_rows(w)
    assert rows.numel() == c_in * -(-c_out // 8) * 8  # nrx_tile.cuh rows_ld
    np.testing.assert_array_equal(rows_decode(rows, c_in, c_out), w.numpy())


def test_float32_mlp_and_stack_buffers(cgnn):
    """pack_mlp_rows / pack_stack_rows: the plain float32 buffer, zeros to
    the next multiple of 8 values (16-byte aligned rows), then each
    product's rows at the offsets make_mlp_desc / make_stack_desc compute
    with fragments false; built once."""
    f32 = torch.float32
    for p in mlps(cgnn):
        (w1, _), (w2, _) = [(d["w"], d["b"]) for d in
                            (p["hidden"][0], p["out"])]
        i, h = w1.shape
        o = w2.shape[1]
        buf = cgnn_iter.pack_mlp_rows(p)
        assert buf is cgnn_iter.pack_mlp_rows(p) and buf.dtype == f32
        plain = i * h + h + h * o + o
        f1 = -(-plain // 8) * 8
        f2 = f1 + i * -(-h // 8) * 8
        assert buf.numel() == f2 + h * -(-o // 8) * 8
        assert torch.equal(buf[:plain], cgnn_iter.pack_mlp(p, f32))
        assert not buf[plain:f1].any() and f1 % 4 == 0 and f2 % 4 == 0
        np.testing.assert_array_equal(rows_decode(buf[f1:f2], i, h),
                                      w1.numpy())
        np.testing.assert_array_equal(rows_decode(buf[f2:], h, o),
                                      w2.numpy())
    for p in stacks(cgnn):
        layers = list(p["hidden"]) + [p["out"]]
        buf = sepconv.pack_stack_rows(p)
        assert buf is sepconv.stack_weights(p, f32)
        plain = pack_stack(p, f32).numel()
        assert torch.equal(buf[:plain], pack_stack(p, f32))
        off = -(-plain // 8) * 8  # make_stack_desc's frag_off[0]
        for lp in layers:
            c_in, c_out = lp["pw"].shape
            n = c_in * -(-c_out // 8) * 8
            assert off % 4 == 0
            np.testing.assert_array_equal(
                rows_decode(buf[off:off + n], c_in, c_out), lp["pw"].numpy())
            off += n
        assert buf.numel() == off


def row_ld(c):
    """nrx_tile.cuh row_ld(c, false): c rounded up to a multiple of 4."""
    return -(-c // 4) * 4


def mlp_ld(c):
    """nrx_tile.cuh mlp_ld(c, false): 4 more where row_ld is 0 mod 16."""
    return row_ld(c) + 4 if row_ld(c) % 16 == 0 else row_ld(c)


def cm_ld(n):
    """nrx_tile.cuh cm_ld: B's channel stride, n rounded up to 8, plus 4."""
    return -(-n // 8) * 8 + 4


STAGE = 3 * 8 * 128 * 4  # nrx_tile.cuh kStageBytes: the weight slabs


def tile_elems(h, e, cmax):
    """(A, B) elements of a float32 tile of e columns in the normal mode
    (tile_a_elems, tile_b_elems): A position-major, B channel-major."""
    return -(-h * e * row_ld(cmax) // 4) * 4, cmax * cm_ld(h * (e - 2))


def stack_tile(widths, h=N_SYM, w=N_SC, smem=OPTIN):
    """(w_tile, bytes) of the float32 stack tile in the normal mode
    (stack_w_tile, stack_smem)."""
    n_layers, cmax = len(widths) - 1, max(widths)

    def size(w_tile):
        return 4 * sum(tile_elems(h, w_tile + 2 * n_layers, cmax)) + STAGE
    w_tile = 64  # nrx::kMaxTile
    while w_tile >= 1 and size(w_tile) > smem:
        w_tile -= 1
    w_tile = min(w_tile, w)
    n_tiles = -(-w // w_tile)
    w_tile = -(-w // n_tiles)
    return w_tile, size(w_tile)


def iter_layout(widths, d_s, hid, ro_hid, w_tile, h=N_SYM):
    """(chunk, bytes) of the float32 iteration tile (iter_layout), or None
    if it does not fit the opt-in."""
    align = lambda v: -(-v // 16) * 16  # noqa: E731
    e = w_tile + 2 * (len(widths) - 1)
    p = h * e
    a, b = tile_elems(h, e, max(widths))
    per_chunk_t = (row_ld(d_s) + mlp_ld(hid)) * 4
    per_chunk = per_chunk_t + 4 * d_s
    scr = align(p * row_ld(widths[0]) * 4)
    total = align(max(4 * (a + b), scr + min(p, 64) * per_chunk + 16))
    pc = h * w_tile
    if total + STAGE > OPTIN or pc * mlp_ld(ro_hid) > a or pc * row_ld(d_s) > b:
        return None
    chunk = min((total - scr - 16) // per_chunk, p)
    n = -(-p // chunk)
    return -(-p // n), total + STAGE


def test_float32_tile_fits_the_opt_in(cgnn):
    """At nrx_rt's widths the float32 stack tile keeps 10 core columns
    (E = 16): A 14 x 16 x 128 floats, B 128 channels x cm_ld(14 x 14) = 204
    positions, and the three 4 KB weight slabs, 231,424 B of the 232,448;
    11 columns do not fit. The iteration tile takes the same width with two
    equal aggregation chunks of 112 positions and room for the readouts'
    state (140 x 56, in B) and hidden rows (140 x 132, in A)."""
    for p in stacks(cgnn):
        widths = [p["hidden"][0]["pw"].shape[0]] + [
            lp["pw"].shape[1] for lp in list(p["hidden"]) + [p["out"]]]
        assert stack_tile(widths) == (10, 231424)
        assert 4 * sum(tile_elems(14, 17, 128)) + STAGE > OPTIN
        assert stack_tile(widths, w=48) == (10, 231424)  # 5 tiles over 48
        assert tile_elems(14, 16, 128) == (14 * 16 * 128, 128 * 204)
    it = cgnn["iterations"][0]
    upd = it["update"]
    widths = [upd["hidden"][0]["pw"].shape[0]] + [
        lp["pw"].shape[1] for lp in list(upd["hidden"]) + [upd["out"]]]
    d_s, hid = it["agg"]["hidden"][0]["w"].shape
    ro_hid = cgnn["readout_llrs"][0]["hidden"][0]["w"].shape[1]
    assert (widths, d_s, hid, ro_hid) == ([114, 128, 128, 56], 56, 64, 128)
    assert iter_layout(widths, d_s, hid, ro_hid, 10) == (112, 231424)
    assert iter_layout(widths, d_s, hid, ro_hid, 11) is None


def test_float32_tile_refuses_wider_products(monkeypatch):
    """The float32 tile's weight slabs hold at least 4 rows of at most
    ROWS_MAX_N = 256 output channels: the stack wrapper refuses a wider
    float32 layer before any launch (the folded mode, which reads no slab,
    and bfloat16 take it)."""
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("launched"))
    rng = np.random.default_rng(3)

    def layer(c_in, c_out):
        return {"dw": torch.as_tensor(rng.standard_normal((3, 3, 1, c_in)),
                                      dtype=torch.float32),
                "pw": torch.as_tensor(rng.standard_normal((c_in, c_out)),
                                      dtype=torch.float32),
                "b": torch.zeros(c_out)}
    p = {"hidden": [layer(4, 260)], "out": layer(260, 8)}
    x = torch.zeros((1, 14, 8, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="256 output channels"):
        sepconv._launch(p, x, None)
    assert sepconv.ROWS_MAX_N == 256
