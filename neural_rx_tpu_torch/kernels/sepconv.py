"""Fused separable-conv stack: wrapper of the CUDA kernel and its plain version.

Counterpart of `neural_rx_tpu/kernels/sepconv_pallas.py` (`fused_conv_stack`
and `fused_conv_stack_blocked`, one Hopper kernel for both:
`csrc/sepconv_stack.cu`), with its three ways of computing a layer:

- normal: the depthwise taps summed in float32 and rounded, then the
  pointwise product;
- `lp_stencil`: the taps summed in the activation dtype, each product and
  each partial sum rounded (bfloat16; a no-op in float32);
- `mxu`: the folded-tap form, y = sum over the nine taps s of
  shift_s(x) @ W_s with W_s = dw_s[:, None] * pw (folded in float32 and
  rounded to x.dtype), one float32 sum per tap added in tap order, no
  depthwise step; it takes precedence over `lp_stencil`.

The modes are opt-in and off by default, as in the JAX package: None
resolves through `mxu_default` / `lp_default`, which read the
`NRX_CONV_MXU` / `NRX_STENCIL_LP` knobs at each call.

A stack `p` is {"hidden": [layer, ...], "out": layer} with each layer
{"dw": [3, 3, 1, C], "pw": [C, O], "b": [O]} (the JAX layout). Activations
are channels-last [N, H, W, C] in float32 or bfloat16; ReLU follows every
hidden layer, the output layer is linear.

Weights go to the kernel packed once per dtype (`stack_weights`): float32,
whose tile runs its products on the CUDA cores, as `pack_stack_rows`,
`pack_stack` followed by every layer's pointwise weights as padded rows
(`cuda_core_rows`); bfloat16, whose tile runs its products on the tensor
cores (as the CGNN kernels' bfloat16 tiles do), as `pack_stack_mma`, the
same buffer followed by every layer's pointwise weights in MMA fragment
order (`mma_fragments`). That tile takes at most `MMA_MAX_K` input channels a
layer (past 128, e2e_rt's 130-channel update stacks, in kernel instances
that stream the weights of the further channels from L2): the wrapper
refuses a wider bfloat16 stack. The folded mode reads
`pack_stack_folded`: the same buffer followed by every layer's nine folded
matrices (fragments in bfloat16, rows in float32).

Dispatch: a CPU tensor goes to the plain PyTorch version, a CUDA tensor
launches the kernel or raises. The plain version is the kernel's oracle.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from . import _build

MAX_LAYERS = 4
MMA_MAX_K = 256  # nrx::kMmaMaxK: input channels of a tensor-core product
ROWS_MAX_N = 256  # nrx::kRowsMaxN: output channels of a float32 product
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's `mode` argument (csrc/sepconv_stack.cu)
MODES = {"normal": 0, "lp": 1, "mxu": 2}

# Kernel launches since the last reset; the wrapper adds one per launch to
# `launches` and to its mode's count.
launches = 0
launches_by_mode = dict.fromkeys(MODES, 0)


def mxu_default(mxu: bool | None) -> bool:
    """None -> the env opt-in NRX_CONV_MXU=1 (read at each call)."""
    if mxu is None:
        return os.environ.get("NRX_CONV_MXU", "0") == "1"
    return bool(mxu)


def lp_default(lp_stencil: bool | None) -> bool:
    """None -> the env opt-in NRX_STENCIL_LP=1 (read at each call)."""
    if lp_stencil is None:
        return os.environ.get("NRX_STENCIL_LP", "0") == "1"
    return bool(lp_stencil)


def mode_of(mxu: bool, lp_stencil: bool) -> str:
    """The mode a layer runs in: the folded form wins over the stencil."""
    return "mxu" if mxu else "lp" if lp_stencil else "normal"


def check_mma_k(in_channels, what: str) -> None:
    """Raises ValueError if a product of the bfloat16 (tensor-core) tile
    would take more than MMA_MAX_K input channels."""
    if max(in_channels) > MMA_MAX_K:
        raise ValueError(f"{what}: the bfloat16 tile takes at most "
                         f"{MMA_MAX_K} input channels a product, got "
                         f"{list(in_channels)}")


def check_rows_n(out_channels, what: str) -> None:
    """Raises ValueError if a product of the float32 (CUDA-core) tile would
    give more than ROWS_MAX_N output channels."""
    if max(out_channels) > ROWS_MAX_N:
        raise ValueError(f"{what}: the float32 tile gives at most "
                         f"{ROWS_MAX_N} output channels a product, got "
                         f"{list(out_channels)}")


def _layers(p):
    return list(p["hidden"]) + [p["out"]]


def _valid_range(sc_valid, w: int) -> tuple[int, int]:
    """The valid column range [lo, hi): None (full width), a count of
    leading valid columns, or an explicit (lo, hi) pair."""
    if sc_valid is None:
        return 0, w
    if isinstance(sc_valid, (tuple, list)):
        if len(sc_valid) != 2:
            raise ValueError(f"sc_valid pair expected, got {sc_valid!r}")
        return int(sc_valid[0]), int(sc_valid[1])
    return 0, int(sc_valid)


def folded_taps(lp, dtype: torch.dtype) -> torch.Tensor:
    """W [9, C, O] of a layer in `dtype`: W[s] = dw[s][:, None] * pw, the
    product of the dtype-rounded weights in float32, rounded to dtype."""
    dw = lp["dw"].reshape(9, -1).to(dtype).float()
    pw = lp["pw"].to(dtype).float()
    return (dw[:, :, None] * pw[None]).to(dtype)


def sepconv_stack_reference(p, x: torch.Tensor, sc_valid=None,
                            mxu: bool = False, lp_stencil: bool = False
                            ) -> torch.Tensor:
    """Plain PyTorch version of the stack, with the kernel's rounding points.
    Weights are rounded to x.dtype first. Per layer, by mode:
    normal: depthwise taps accumulated in float32 from zero in tap order
    (dy outer, dx inner), rounded to x.dtype, then the pointwise product in
    float32; lp_stencil: the taps accumulated in x.dtype, each product and
    each sum rounded, then the same product; mxu (wins over lp_stencil):
    per tap s the float32 product shift_s(x) @ W_s (`folded_taps`), added
    to a float32 sum in tap order. Then the bias in float32, ReLU on hidden
    layers, one rounding to x.dtype. Columns outside [lo, hi) are zeroed
    before every layer and after the last."""
    dtype = x.dtype
    n, h, w, _ = x.shape
    lo, hi = _valid_range(sc_valid, w)
    col = torch.arange(w, device=x.device)
    valid = ((col >= lo) & (col < hi))[None, None, :, None]
    zero = torch.zeros((), dtype=dtype, device=x.device)
    x = torch.where(valid, x, zero)
    layers = _layers(p)
    acc_dtype = dtype if lp_stencil else torch.float32
    for li, lp in enumerate(layers):
        b = lp["b"].to(dtype).float()
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        if mxu:
            taps = folded_taps(lp, dtype).float()
            y = torch.zeros(x.shape[:-1] + taps.shape[-1:],
                            dtype=torch.float32, device=x.device)
            for s in range(9):
                dy, dx = divmod(s, 3)
                y = y + torch.matmul(xp[:, dy:dy + h, dx:dx + w, :].float(),
                                     taps[s])
        else:
            dw = lp["dw"][:, :, 0, :].to(dtype).to(acc_dtype)
            xp = xp.to(acc_dtype)
            acc = torch.zeros(x.shape, dtype=acc_dtype, device=x.device)
            for dy in range(3):
                for dx in range(3):
                    acc = acc + xp[:, dy:dy + h, dx:dx + w, :] * dw[dy, dx]
            y = torch.matmul(acc.to(dtype).float(), lp["pw"].to(dtype).float())
        y = y + b
        if li < len(layers) - 1:
            y = torch.relu(y)
        x = torch.where(valid, y.to(dtype), zero)
    return x


def pack_stack(p, dtype: torch.dtype) -> torch.Tensor:
    """The stack's weights as one contiguous buffer of `dtype` on the
    weights' device: per layer dw [9][C], pw [C][O], b [O] (the layout of
    `nrx_sepconv_stack`). Built once and kept in p["packed"]; the weights
    of a served model do not change."""
    cache = p.setdefault("packed", {})
    if dtype not in cache:
        parts = []
        for lp in _layers(p):
            parts += [lp["dw"].reshape(-1), lp["pw"].reshape(-1),
                      lp["b"].reshape(-1)]
        cache[dtype] = torch.cat(parts).to(dtype).contiguous()
    return cache[dtype]


def mma_fragments(w: torch.Tensor) -> torch.Tensor:
    """w [c_in, c_out] as the B fragments of the kernels' tensor-core
    products (`csrc/nrx_tile.cuh`, pointwise_mma), flat, zero-padded to
    16-deep k-steps and 16-wide slabs of output channels: for slab, k-step
    s and lane l = 4 g + q in order, 8 values w[k][n] with k = 16 s + 8 hf +
    2 q + e, n = 16 slab + 8 j + g, for (j, hf, e) in order (j, hf, e in
    {0, 1}): one 16-byte load a lane and k-step."""
    c_in, c_out = w.shape
    steps, slabs = -(-c_in // 16), -(-c_out // 16)
    wp = torch.zeros((16 * steps, 16 * slabs), dtype=w.dtype, device=w.device)
    wp[:c_in, :c_out] = w

    def ax(n, dim):
        shape = [1] * 6
        shape[dim] = n
        return torch.arange(n, device=w.device).view(shape)
    lane = ax(32, 2)
    k = 16 * ax(steps, 1) + 8 * ax(2, 4) + 2 * (lane % 4) + ax(2, 5)
    n = 16 * ax(slabs, 0) + 8 * ax(2, 3) + lane // 4
    return wp[k, n].reshape(-1)


def cuda_core_rows(w: torch.Tensor) -> torch.Tensor:
    """w [c_in, c_out] as the rows of the kernels' float32 products
    (`csrc/nrx_tile.cuh`, pointwise_f32), flat: per input channel 8 * G
    values (G = ceil(c_out / 8)) in two halves of G quads, quad g of half h
    holding w[c][g + (4 h + e) * G] for e = 0..3, zero past c_out. A
    thread's 8 output channels g + j * G are quad g of both halves, and
    neighbouring lanes (g, g + 1) read neighbouring quads."""
    c_in, c_out = w.shape
    groups = -(-c_out // 8)
    quad = torch.arange(groups, device=w.device)[:, None]
    e = torch.arange(4, device=w.device)
    o = torch.cat([quad + (4 * h + e) * groups for h in (0, 1)]).reshape(-1)
    rows = w.new_zeros((c_in, 8 * groups))
    rows[:, o < c_out] = w[:, o[o < c_out]]
    return rows.reshape(-1)


def with_fragments(plain: torch.Tensor, mats,
                   lay=mma_fragments) -> torch.Tensor:
    """plain, zero-padded to a multiple of 8 values (16 bytes), then each
    matrix laid out by `lay`: `mma_fragments` (the tensor-core kernels'
    bfloat16 layout), `cuda_core_rows` (the CUDA-core float32 products) or
    plain rows (the CUDA-core folded tile); `csrc/nrx_tile.cuh` computes the
    offsets alike."""
    pad = plain.new_zeros((-plain.numel()) % 8)
    return torch.cat([plain, pad] + [lay(m.to(plain.dtype))
                                     for m in mats]).contiguous()


def pack_stack_mma(p) -> torch.Tensor:
    """`pack_stack` in bfloat16 followed by the fragments of every layer's
    pointwise weights: the weights of the tensor-core stack. Built once and
    kept in p["packed"]."""
    cache = p.setdefault("packed", {})
    if "mma" not in cache:
        cache["mma"] = with_fragments(pack_stack(p, torch.bfloat16),
                                      [lp["pw"] for lp in _layers(p)])
    return cache["mma"]


def pack_stack_folded(p, dtype: torch.dtype) -> torch.Tensor:
    """`pack_stack` in `dtype` followed by the nine folded matrices W_s
    (`folded_taps`) of every layer, layer by layer and tap by tap: as B
    fragments in bfloat16 (the tensor-core tile), as [C][O] rows in float32.
    The weights of the folded mode. Built once and kept in p["packed"]."""
    cache = p.setdefault("packed", {})
    key = ("folded", dtype)
    if key not in cache:
        mats = [m for lp in _layers(p) for m in folded_taps(lp, dtype)]
        cache[key] = with_fragments(
            pack_stack(p, dtype), mats,
            mma_fragments if dtype == torch.bfloat16 else torch.flatten)
    return cache[key]


def pack_stack_rows(p) -> torch.Tensor:
    """`pack_stack` in float32 followed by every layer's pointwise weights
    as `cuda_core_rows`: the weights of the float32 stack. Built once and
    kept in p["packed"]."""
    cache = p.setdefault("packed", {})
    if "rows" not in cache:
        cache["rows"] = with_fragments(pack_stack(p, torch.float32),
                                       [lp["pw"] for lp in _layers(p)],
                                       cuda_core_rows)
    return cache["rows"]


def stack_weights(p, dtype: torch.dtype, mode: str = "normal"
                  ) -> torch.Tensor:
    """The stack's weights as the kernels read them in `dtype` and mode."""
    if mode == "mxu":
        return pack_stack_folded(p, dtype)
    return pack_stack_mma(p) if dtype == torch.bfloat16 else \
        pack_stack_rows(p)


def fused_conv_stack(p, x: torch.Tensor, sc_valid=None,
                     mxu: bool | None = None,
                     lp_stencil: bool | None = None) -> torch.Tensor:
    """The stack applied to x [N, H, W, C_in] -> [N, H, W, C_out].

    sc_valid: None, a leading-valid column count or a (lo, hi) pair;
    columns outside the valid range are re-zeroed before every layer and
    after the last. mxu, lp_stencil: the layer modes (module docstring),
    None deferring to the env knobs. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    mxu, lp_stencil = mxu_default(mxu), lp_default(lp_stencil)
    if x.device.type == "cpu":
        return sepconv_stack_reference(p, x, sc_valid, mxu, lp_stencil)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(p, x, sc_valid, mode_of(mxu, lp_stencil))


def _launch(p, x: torch.Tensor, sc_valid, mode: str = "normal"
            ) -> torch.Tensor:
    global launches
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"sepconv_stack takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [N, H, W, C] tensor")
    layers = _layers(p)
    widths = [x.shape[-1]] + [int(lp["pw"].shape[1]) for lp in layers]
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} layers, got {len(layers)}")
    if any(int(lp["pw"].shape[0]) != c for lp, c in zip(layers, widths)):
        raise ValueError(f"channel widths do not chain: {widths}")
    if x.dtype == torch.bfloat16:
        check_mma_k(widths[:-1], "sepconv_stack")
    elif mode != "mxu":
        check_rows_n(widths[1:], "sepconv_stack")
    w = stack_weights(p, x.dtype, mode)
    if w.device != x.device:
        raise ValueError(f"weights on {w.device}, activations on {x.device}")
    n, h, wc, _ = x.shape
    lo, hi = _valid_range(sc_valid, wc)
    out = torch.empty((n, h, wc, widths[-1]), dtype=x.dtype, device=x.device)
    c_widths = (ctypes.c_int * len(widths))(*widths)
    lib = _build.load()
    rc = lib.nrx_sepconv_stack(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
        n, h, wc, len(layers), ctypes.cast(c_widths, ctypes.c_void_p),
        lo, hi, MODES[mode], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("sepconv_stack launch failed: "
                           + lib.nrx_cuda_error_string(rc).decode())
    launches += 1
    launches_by_mode[mode] += 1
    return out
