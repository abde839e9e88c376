"""Fused CGNN iteration (K3) and whole-CGNN kernel (K4): wrappers of the
CUDA kernels and their plain versions.

Counterpart of `neural_rx_tpu/kernels/cgnn_iter_pallas.py` (`fused_iteration`
and `fused_cgnn_full`), kernels in `csrc/cgnn_iter.cu`. The signatures are the
JAX package's without its TPU tiling arguments (`w_blk`, `interpret`): the
CUDA kernels size their own tiles. Both take the JAX package's
`lp_stencil` mode (the update stacks' and K4's init stack's depthwise taps
summed in the activation dtype, `kernels/sepconv.py`), None deferring to
the `NRX_STENCIL_LP` knob. The folded-tap mode is the stack kernel's
alone, as in the JAX package: `fused_iteration` raises ValueError when its
`mxu` resolves true (also through `NRX_CONV_MXU`), and K4 never takes it.

Parameters follow the JAX tree: an iteration {"agg": mlp, "update": stack},
an MLP {"hidden": [{"w", "b"}], "out": {"w", "b"}} with exactly one hidden
layer, a stack as in `kernels/sepconv.py`. Activations are channels-last:
s [b, T, H, W, d_s], pe [T, H, W, d_pe], active_tx [b, T].

Weights go to the kernels packed once per dtype (`pack_mlp`,
`sepconv.pack_stack`), each packed buffer followed by the products' weights
as the kernels read them: in bfloat16, whose kernels run their products on
the tensor cores, in MMA fragment order (`pack_mlp_mma`,
`sepconv.pack_stack_mma`); in float32, whose kernels run them on the CUDA
cores, as padded rows (`pack_mlp_rows`, `sepconv.pack_stack_rows`). The
bfloat16 kernels keep the plain versions' rounded outputs exactly
(csrc/nrx_tile.cuh, pointwise_mma).

Dispatch: a CPU tensor goes to the plain PyTorch version, a CUDA tensor
launches the kernel or raises. The plain versions keep the TPU kernel's
rounding points (weights cast to the activation type first, every product
summed in float32 with the bias added in float32 and then rounded,
sps = round(y) * active, tot = round(sum_u sps_u), a = (tot - sps) * scale
rounded after each op), which differ from `rx/cgnn.py:_apply_mlp`'s.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sepconv import (_DTYPE_CODES, _layers, _valid_range, check_mma_k,
                      check_rows_n, cuda_core_rows, lp_default, mxu_default,
                      sepconv_stack_reference, stack_weights, with_fragments)

MAX_ITERATIONS = 8  # K4: csrc/cgnn_iter.cu kMaxIt
MAX_USERS = 8

# Kernel launches since the last reset; each wrapper adds one per launch,
# and one to its mode's count.
iter_launches = 0
full_launches = 0
iter_launches_by_mode = {"normal": 0, "lp": 0}
full_launches_by_mode = {"normal": 0, "lp": 0}


def _dense(p, what: str):
    """(w1, b1, w2, b2) of a one-hidden-layer MLP."""
    if len(p["hidden"]) != 1:
        raise ValueError(f"{what}: the fused kernels take an MLP with one "
                         f"hidden layer, got {len(p['hidden'])}")
    return p["hidden"][0]["w"], p["hidden"][0]["b"], p["out"]["w"], \
        p["out"]["b"]


def _mlp_dims(p, what: str) -> tuple[int, int, int]:
    w1, _, w2, _ = _dense(p, what)
    return int(w1.shape[0]), int(w1.shape[1]), int(w2.shape[1])


def pack_mlp(p, dtype: torch.dtype) -> torch.Tensor:
    """The MLP's weights as one contiguous buffer of `dtype`: w1 [in][hid],
    b1 [hid], w2 [hid][out], b2 [out]. Built once and kept in p["packed"]."""
    cache = p.setdefault("packed", {})
    if dtype not in cache:
        cache[dtype] = torch.cat([a.reshape(-1) for a in _dense(p, "mlp")]
                                 ).to(dtype).contiguous()
    return cache[dtype]


def pack_mlp_mma(p) -> torch.Tensor:
    """`pack_mlp` in bfloat16 followed by the fragments of w1 and w2: the
    weights of the tensor-core MLP. Built once and kept in p["packed"]."""
    cache = p.setdefault("packed", {})
    if "mma" not in cache:
        w1, _, w2, _ = _dense(p, "mlp")
        cache["mma"] = with_fragments(pack_mlp(p, torch.bfloat16), (w1, w2))
    return cache["mma"]


def pack_mlp_rows(p) -> torch.Tensor:
    """`pack_mlp` in float32 followed by w1 and w2 as `cuda_core_rows`: the
    weights of the float32 (CUDA-core) MLP. Built once and kept in
    p["packed"]."""
    cache = p.setdefault("packed", {})
    if "rows" not in cache:
        w1, _, w2, _ = _dense(p, "mlp")
        cache["rows"] = with_fragments(pack_mlp(p, torch.float32), (w1, w2),
                                       cuda_core_rows)
    return cache["rows"]


def _mlp_weights(p, dtype):
    return pack_mlp_mma(p) if dtype == torch.bfloat16 else pack_mlp_rows(p)


def mlp_reference(p, x: torch.Tensor) -> torch.Tensor:
    """One-hidden-layer MLP with the kernel's rounding points, in x.dtype."""
    dtype = x.dtype
    w1, b1, w2, b2 = (a.to(dtype).float() for a in _dense(p, "mlp"))
    y = torch.relu(torch.matmul(x.float(), w1) + b1).to(dtype)
    return (torch.matmul(y.float(), w2) + b2).to(dtype)


def aggregate_reference(agg_p, s: torch.Tensor, active_tx: torch.Tensor
                        ) -> torch.Tensor:
    """a [b, T, H, W, d_s]: (sum over active users of the aggregation MLP's
    output, minus the user's own) times 1 / max(n_active - 1, 1)."""
    dtype = s.dtype
    act = active_tx.float()
    sps = mlp_reference(agg_p, s) * act.to(dtype)[:, :, None, None, None]
    tot = sps.float().sum(dim=1, keepdim=True).to(dtype)
    cnt = torch.clamp(act.sum(dim=1) - 1.0, min=0.0)
    scale = torch.where(cnt == 0.0, torch.ones_like(cnt),
                        1.0 / torch.clamp(cnt, min=1.0)).to(dtype)
    return (tot - sps) * scale[:, None, None, None, None]


def fused_iteration_reference(it_p, s: torch.Tensor, pe: torch.Tensor,
                              active_tx: torch.Tensor, sc_valid=None,
                              readout_p=None, chest_p=None,
                              lp_stencil: bool = False):
    """Plain PyTorch version of `fused_iteration` (same arguments, same
    returns). Columns outside the valid range enter the update stack as
    zeros; the residual adds the state as given."""
    b, t = s.shape[:2]
    a = aggregate_reference(it_p["agg"], s, active_tx)
    pe_b = pe.to(s.dtype)[None].expand((b,) + pe.shape)
    z = torch.cat([a, s, pe_b], dim=-1)
    u = sepconv_stack_reference(it_p["update"],
                                z.reshape((b * t,) + z.shape[2:]), sc_valid,
                                lp_stencil=lp_stencil)
    s_new = u.reshape((b, t) + u.shape[1:]) + s
    if readout_p is None:
        return s_new
    llr = mlp_reference(readout_p, s_new)
    if chest_p is None:
        return llr
    return llr, mlp_reference(chest_p, s_new)


def fused_cgnn_full_reference(params, z0: torch.Tensor, pe: torch.Tensor,
                              active_tx: torch.Tensor, sc_valid=None,
                              num_it: int | None = None,
                              lp_stencil: bool = False):
    """Plain PyTorch version of `fused_cgnn_full`: the init stack's plain
    version, then `fused_iteration_reference` per iteration, the last with
    both readouts, every stack in the lp_stencil mode given."""
    b, t = z0.shape[:2]
    its = params["iterations"][:num_it]
    s = sepconv_stack_reference(params["s_init"][0],
                                z0.reshape((b * t,) + z0.shape[2:]), sc_valid,
                                lp_stencil=lp_stencil)
    s = s.reshape((b, t) + s.shape[1:])
    for it_p in its[:-1]:
        s = fused_iteration_reference(it_p, s, pe, active_tx, sc_valid,
                                      lp_stencil=lp_stencil)
    return fused_iteration_reference(
        its[-1], s, pe, active_tx, sc_valid,
        readout_p=params["readout_llrs"][0], chest_p=params["readout_chest"],
        lp_stencil=lp_stencil)


def fused_iteration(it_params, s: torch.Tensor, pe: torch.Tensor,
                    active_tx: torch.Tensor, sc_valid=None, readout_p=None,
                    chest_p=None, mxu: bool | None = None,
                    lp_stencil: bool | None = None):
    """One CGNN iteration: aggregation MLP, masked sum over the other users,
    concat [a, s, pe], update stack, residual.

    s: [b, T, H, W, d_s]; pe: [T, H, W, d_pe] (cast to s.dtype);
    active_tx: [b, T]; sc_valid: None, a leading-valid column count or a
    (lo, hi) pair. Returns the next state [b, T, H, W, d_s] in s.dtype; with
    readout_p (final iteration) the LLRs [b, T, H, W, bits] instead, and
    with chest_p as well (llr, h_hat [b, T, H, W, 2*rx_ant]). mxu: the
    folded-tap mode, which the iteration does not take (ValueError when it
    resolves true); lp_stencil: the update stack's depthwise taps in the
    activation dtype; None defers to the env knobs. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if mxu_default(mxu):
        raise ValueError("fused_iteration: conv_mxu is not supported (the "
                         "folded-tap mode is the stack kernel's; use "
                         "fused_conv_stack or the plain layers)")
    lp_stencil = lp_default(lp_stencil)
    if chest_p is not None and readout_p is None:
        raise ValueError("chest_p requires readout_p")
    if s.device.type == "cpu":
        return fused_iteration_reference(it_params, s, pe, active_tx,
                                         sc_valid, readout_p, chest_p,
                                         lp_stencil)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    return _launch_iteration(it_params, s, pe, active_tx, sc_valid,
                             readout_p, chest_p, lp_stencil)


def fused_cgnn_full(params, z0: torch.Tensor, pe: torch.Tensor,
                    active_tx: torch.Tensor, sc_valid=None,
                    num_it: int | None = None,
                    lp_stencil: bool | None = None):
    """The whole deployed CGNN in one kernel: init stack, every iteration,
    LLR and channel readouts. z0: [b, T, H, W, C_in] (normalised inputs, see
    rx/cgnn.cgnn_apply); pe: [T, H, W, d_pe]; active_tx: [b, T]; lp_stencil:
    every stack's depthwise taps in the activation dtype (None: the env
    knob). Returns (llr [b, T, H, W, bits], h_hat [b, T, H, W, 2*rx_ant])
    in z0.dtype. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if num_it is None:
        num_it = len(params["iterations"])
    lp_stencil = lp_default(lp_stencil)
    if z0.device.type == "cpu":
        return fused_cgnn_full_reference(params, z0, pe, active_tx, sc_valid,
                                         num_it, lp_stencil)
    if z0.device.type != "cuda":
        raise ValueError(f"unsupported device {z0.device}")
    return _launch_full(params, z0, pe, active_tx, sc_valid, num_it,
                        lp_stencil)


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _ptr(arr) -> ctypes.c_void_p:
    return ctypes.cast(arr, ctypes.c_void_p)


def _check(x: torch.Tensor, ndim: int, what: str):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {ndim}-d tensor")


def _stack_widths(p) -> list[int]:
    layers = _layers(p)
    widths = [int(layers[0]["pw"].shape[0])] + [int(lp["pw"].shape[1])
                                                for lp in layers]
    if any(int(lp["pw"].shape[0]) != c for lp, c in zip(layers, widths)):
        raise ValueError(f"channel widths do not chain: {widths}")
    return widths


def _iter_shapes(it_p, shape, pe, active_tx):
    """Checks one iteration's operands for a state of `shape` [b, T, H, W,
    d_s]; returns (agg dims, stack widths)."""
    b, t, h, w, d_s = shape
    if pe.dim() != 4 or tuple(pe.shape[:3]) != (t, h, w):
        raise ValueError(f"pe {tuple(pe.shape)} does not match the state "
                         f"{tuple(shape)}")
    if tuple(active_tx.shape) != (b, t):
        raise ValueError(f"active_tx {tuple(active_tx.shape)} is not {(b, t)}")
    if t > MAX_USERS:
        raise ValueError(f"at most {MAX_USERS} users, got {t}")
    agg = _mlp_dims(it_p["agg"], "agg")
    widths = _stack_widths(it_p["update"])
    if agg != (d_s, agg[1], d_s) or widths[0] != 2 * d_s + pe.shape[-1] \
            or widths[-1] != d_s:
        raise ValueError(f"iteration widths agg {agg}, update {widths} do "
                         f"not fit d_s={d_s}, d_pe={pe.shape[-1]}")
    return agg, widths


def _readout_dims(p, d_s: int, what: str) -> tuple[int, int, int]:
    dims = _mlp_dims(p, what)
    if dims[0] != d_s:
        raise ValueError(f"{what} takes {dims[0]} channels, the state has "
                         f"{d_s}")
    return dims


def _on(x: torch.Tensor, dev: torch.device, what: str) -> torch.Tensor:
    if x.device != dev:
        raise ValueError(f"{what} on {x.device}, activations on {dev}")
    return x


def _launch_iteration(it_p, s, pe, active_tx, sc_valid, readout_p, chest_p,
                      lp_stencil=False):
    global iter_launches
    _check(s, 5, "fused_iteration")
    b, t, h, w, d_s = s.shape
    agg, widths = _iter_shapes(it_p, s.shape, pe, active_tx)
    dev, dtype = s.device, s.dtype
    products = widths[:-1] + list(agg[:2])
    pe = _on(pe, dev, "pe").to(dtype).contiguous()
    act = _on(active_tx, dev, "active_tx").float().contiguous()
    agg_w = _on(_mlp_weights(it_p["agg"], dtype), dev, "weights")
    upd_w = _on(stack_weights(it_p["update"], dtype), dev, "weights")
    lo, hi = _valid_range(sc_valid, w)
    ro_w = ch_w = None
    ro_dims = ch_dims = None
    if readout_p is None:
        out = torch.empty_like(s)
        out2 = None
    else:
        ro_dims = _ints(_readout_dims(readout_p, d_s, "readout"))
        products += list(ro_dims)[:2]
        ro_w = _on(_mlp_weights(readout_p, dtype), dev, "weights")
        out = torch.empty((b, t, h, w, ro_dims[2]), dtype=dtype, device=dev)
        out2 = None
        if chest_p is not None:
            ch_dims = _ints(_readout_dims(chest_p, d_s, "chest"))
            products += list(ch_dims)[:2]
            ch_w = _on(_mlp_weights(chest_p, dtype), dev, "weights")
            out2 = torch.empty((b, t, h, w, ch_dims[2]), dtype=dtype,
                               device=dev)
    if dtype == torch.bfloat16:
        check_mma_k(products, "fused_iteration")
    else:
        check_rows_n(widths[1:] + list(agg[1:]) + list(ro_dims or ())[1:]
                     + list(ch_dims or ())[1:], "fused_iteration")
    lib = _build.load()
    rc = lib.nrx_cgnn_iter(
        s.data_ptr(), pe.data_ptr(), act.data_ptr(), out.data_ptr(),
        None if out2 is None else out2.data_ptr(), agg_w.data_ptr(),
        _ptr(_ints(agg)), upd_w.data_ptr(), len(widths) - 1,
        _ptr(_ints(widths)), None if ro_w is None else ro_w.data_ptr(),
        None if ro_dims is None else _ptr(ro_dims),
        None if ch_w is None else ch_w.data_ptr(),
        None if ch_dims is None else _ptr(ch_dims), _DTYPE_CODES[dtype],
        b, t, h, w, d_s, pe.shape[-1], lo, hi, int(lp_stencil),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("cgnn_iter launch failed: "
                           + lib.nrx_cuda_error_string(rc).decode())
    iter_launches += 1
    iter_launches_by_mode["lp" if lp_stencil else "normal"] += 1
    if readout_p is None:
        return out
    return out if chest_p is None else (out, out2)


def _launch_full(params, z0, pe, active_tx, sc_valid, num_it,
                 lp_stencil=False):
    global full_launches
    _check(z0, 5, "fused_cgnn_full")
    b, t, h, w, _ = z0.shape
    dev, dtype = z0.device, z0.dtype
    if not 1 <= num_it <= MAX_ITERATIONS:
        raise ValueError(f"1 to {MAX_ITERATIONS} iterations, got {num_it}")
    its = params["iterations"][:num_it]
    init_p = params["s_init"][0]
    init_widths = _stack_widths(init_p)
    if init_widths[0] != z0.shape[-1]:
        raise ValueError(f"init stack takes {init_widths[0]} channels, z0 "
                         f"has {z0.shape[-1]}")
    d_s = init_widths[-1]
    shapes = [_iter_shapes(it_p, (b, t, h, w, d_s), pe, active_tx)
              for it_p in its]
    if len({len(widths) for _, widths in shapes}) != 1:
        raise ValueError("every update stack needs the same depth")
    aggs = [v for agg, _ in shapes for v in agg]
    upd_widths = [v for _, widths in shapes for v in widths]
    ro_p, ch_p = params["readout_llrs"][0], params["readout_chest"]
    ro_dims = _readout_dims(ro_p, d_s, "readout")
    ch_dims = _readout_dims(ch_p, d_s, "chest")
    if dtype == torch.bfloat16:
        check_mma_k(init_widths[:-1] + aggs + upd_widths + list(ro_dims[:2])
                    + list(ch_dims[:2]), "fused_cgnn_full")
    else:
        check_rows_n(init_widths[1:] + [v for i, v in enumerate(aggs) if i % 3]
                     + [v for _, widths in shapes for v in widths[1:]]
                     + list(ro_dims[1:]) + list(ch_dims[1:]), "fused_cgnn_full")
    pe = _on(pe, dev, "pe").to(dtype).contiguous()
    act = _on(active_tx, dev, "active_tx").float().contiguous()
    init_w = _on(stack_weights(init_p, dtype), dev, "weights")
    agg_ws = [_on(_mlp_weights(it_p["agg"], dtype), dev, "weights")
              for it_p in its]
    upd_ws = [_on(stack_weights(it_p["update"], dtype), dev, "weights")
              for it_p in its]
    ro_w = _on(_mlp_weights(ro_p, dtype), dev, "weights")
    ch_w = _on(_mlp_weights(ch_p, dtype), dev, "weights")
    state = torch.empty((2, b, t, h, w, d_s), dtype=dtype, device=dev)
    llr = torch.empty((b, t, h, w, ro_dims[2]), dtype=dtype, device=dev)
    h_hat = torch.empty((b, t, h, w, ch_dims[2]), dtype=dtype, device=dev)
    agg_ptrs = (ctypes.c_void_p * num_it)(*[a.data_ptr() for a in agg_ws])
    upd_ptrs = (ctypes.c_void_p * num_it)(*[u.data_ptr() for u in upd_ws])
    lib = _build.load()
    rc = lib.nrx_cgnn_full(
        z0.data_ptr(), pe.data_ptr(), act.data_ptr(), state[0].data_ptr(),
        state[1].data_ptr(), llr.data_ptr(), h_hat.data_ptr(),
        init_w.data_ptr(), len(init_widths) - 1, _ptr(_ints(init_widths)),
        _ptr(agg_ptrs), _ptr(_ints(aggs)), _ptr(upd_ptrs),
        len(shapes[0][1]) - 1, _ptr(_ints(upd_widths)),
        ro_w.data_ptr(), _ptr(_ints(ro_dims)), ch_w.data_ptr(),
        _ptr(_ints(ch_dims)), num_it, _DTYPE_CODES[dtype], b, t, h, w, d_s,
        pe.shape[-1], *_valid_range(sc_valid, w), int(lp_stencil),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("cgnn_full launch failed: "
                           + lib.nrx_cuda_error_string(rc).decode())
    full_launches += 1
    full_launches_by_mode["lp" if lp_stencil else "normal"] += 1
    return llr, h_hat
