"""CGNN neural-receiver core (serving, eval and training) in PyTorch.

Counterpart of `neural_rx_tpu/rx/cgnn.py`. Parameters are the JAX package's
tree with torch tensors as leaves: {"s_init": [stack per MCS, or one with
var-MCS masking], "iterations": [{"agg": mlp, "update": stack}],
"readout_llrs": [mlp per MCS, or one with masking], "readout_chest": mlp};
a stack is {"hidden": [...], "out": {"dw", "pw", "b"}} (a full 3x3 conv
layer {"w", "b"} for layer type "conv"), an MLP {"hidden": [...], "out":
{"w", "b"}}. `init_cgnn_params` draws such a tree from a
`torch.Generator`. Layout is channels-last [batch*num_tx, sym, sc, ch] as
in the JAX package.

Computation dtype follows the `dtype` argument (float32 or bfloat16 with
float32 parameters cast at each use), with the JAX package's rounding
points. The fused routes of `CGNNConfig` are the JAX package's: the
separable-conv stacks (`fused_convs`, `kernels/sepconv.py`), each iteration
(`fused_iteration`), the last one with both readouts (`fused_readout`), or
the whole CGNN in one kernel (`fused_full`, both in
`kernels/cgnn_iter.py`). A fused route runs its CUDA kernel, or its plain
version when `CGNNConfig.kernels` is False; `conv_mxu` and `stencil_lp`
pick the kernels' layer modes (`kernels/sepconv.py`) as the JAX package
routes them; a route the model does not fit falls back as in the JAX
package. Training (`training=True`) takes none of them, whatever the
flags say: it runs the plain layers under autograd, as the JAX package
trains on its XLA layers (its Pallas kernels have no VJP). The plain
layers' separable conv has the JAX package's two lowerings: the stack's
plain version, or with `NRX_SEPCONV_FOLDED=1` (`sepconv_folded`) one full
3x3 convolution of the folded kernel dw[:, :, 0, :, None] * pw per layer.
Full 3x3 conv layers (`conv_stack`) have no kernel and take the same
im2col product on every route.
`cgnn_apply(mesh=)` runs on a subcarrier shard of a mesh's grid axis
(`dist/`).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..dist import fused_sharded
from ..dist.mesh import sum_over_grid
from ..kernels import cgnn_iter
from ..kernels.sepconv import (_layers, _valid_range, fused_conv_stack,
                               lp_default, mxu_default,
                               sepconv_stack_reference)


@dataclasses.dataclass(frozen=True)
class CGNNConfig:
    """Static hyper-parameters (reference [neural_receiver] cfg section)."""
    num_bits_per_symbol: tuple  # one entry per MCS
    num_rx_ant: int
    num_it: int
    d_s: int
    num_units_init: tuple
    num_units_agg: tuple    # per iteration: tuple of hidden sizes
    num_units_state: tuple  # per iteration: tuple of hidden sizes
    num_units_readout: tuple
    layer_type_conv: str = "sepconv"
    var_mcs_masking: bool = False
    initial_chest: bool = True  # the LS estimate is an input
    fused_convs: bool = False   # conv stacks through the stack kernel
    fused_iteration: bool = False  # each iteration in the iteration kernel
    fused_readout: bool = False  # with fused_iteration: the last iteration
    # runs both readouts in the kernel
    fused_full: bool = False    # the whole CGNN in one kernel
    kernels: bool = True        # False: fused routes take the kernels'
    # plain versions (the kernels' oracle on the GPU)
    conv_mxu: bool | None = None  # the init stacks' folded-tap mode (the
    # stack kernel's only); None defers to the NRX_CONV_MXU env knob
    stencil_lp: bool | None = None  # depthwise taps summed in the
    # activation dtype; None defers to the NRX_STENCIL_LP env knob

    @property
    def num_mcs(self):
        return len(self.num_bits_per_symbol)

    @property
    def in_channels(self):
        """y (re/im per antenna), pe (2) and the LS estimate if an input."""
        return (4 if self.initial_chest else 2) * self.num_rx_ant + 2


def _glorot(shape, fan_in: int, fan_out: int, gen: torch.Generator):
    """Keras' glorot_uniform: U(-l, l), l = sqrt(6 / (fan_in + fan_out))."""
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=gen, device=gen.device)
    return (2.0 * u - 1.0) * limit


def _init_conv_layer(c_in: int, c_out: int, layer_type: str, gen):
    if layer_type == "sepconv":
        return {"dw": _glorot((3, 3, 1, c_in), 9, 9, gen),
                "pw": _glorot((c_in, c_out), c_in, c_out, gen),
                "b": torch.zeros(c_out, device=gen.device)}
    return {"w": _glorot((3, 3, c_in, c_out), 9 * c_in, 9 * c_out, gen),
            "b": torch.zeros(c_out, device=gen.device)}


def _init_conv_stack(c_in: int, hidden, c_out: int, layer_type: str, gen):
    layers, c = [], c_in
    for n in hidden:
        layers.append(_init_conv_layer(c, n, layer_type, gen))
        c = n
    return {"hidden": layers,
            "out": _init_conv_layer(c, c_out, layer_type, gen)}


def _init_mlp(d_in: int, hidden, d_out: int, gen):
    def dense(i, o):
        return {"w": _glorot((i, o), i, o, gen),
                "b": torch.zeros(o, device=gen.device)}
    layers, d = [], d_in
    for n in hidden:
        layers.append(dense(d, n))
        d = n
    return {"hidden": layers, "out": dense(d, d_out)}


def init_cgnn_params(cfg: CGNNConfig, generator: torch.Generator) -> dict:
    """A CGNN tree of `cfg`, float32 on the generator's device: the JAX
    package's `init_cgnn_params` tree (same leaves, names and shapes) and
    distributions (glorot-uniform kernels, zero biases), with values drawn
    from `generator` in tree order."""
    gen, lt = generator, cfg.layer_type_conv
    n_init = 1 if cfg.var_mcs_masking else cfg.num_mcs
    params = {"s_init": [
        _init_conv_stack(cfg.in_channels, cfg.num_units_init, cfg.d_s, lt,
                         gen) for _ in range(n_init)]}
    params["iterations"] = [
        {"agg": _init_mlp(cfg.d_s, cfg.num_units_agg[i], cfg.d_s, gen),
         "update": _init_conv_stack(2 * cfg.d_s + 2, cfg.num_units_state[i],
                                    cfg.d_s, lt, gen)}
        for i in range(cfg.num_it)]
    heads = ([max(cfg.num_bits_per_symbol)] if cfg.var_mcs_masking
             else cfg.num_bits_per_symbol)
    params["readout_llrs"] = [
        _init_mlp(cfg.d_s, cfg.num_units_readout, nb, gen) for nb in heads]
    params["readout_chest"] = _init_mlp(cfg.d_s, cfg.num_units_readout,
                                        2 * cfg.num_rx_ant, gen)
    return params


def count_params(params) -> int:
    """Number of parameter values in a CGNN tree (packed kernel buffers,
    which repeat the stack weights, are not counted)."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for k, v in params.items()
                   if k != "packed")
    return sum(count_params(v) for v in params)


def sepconv_folded() -> bool:
    """Whether the plain layers take the folded lowering: the env knob
    NRX_SEPCONV_FOLDED=1, read at each call (the JAX package reads it once
    at import)."""
    return os.environ.get("NRX_SEPCONV_FOLDED", "0") == "1"


def _im2col_stack(p, x: torch.Tensor, sc_valid, kernel) -> torch.Tensor:
    """A stack of full 3x3 "SAME" convolutions, per layer one product of
    the nine shifted copies of x (im2col, [.., 9 C]) with kernel(layer,
    x.dtype) [3, 3, C, O] as [9 C, O], plus the bias in x.dtype; ReLU on
    hidden layers. Columns outside the valid range are zeroed after every
    layer (the input as given, as the JAX package's XLA layers take it).
    Differentiable."""
    dtype = x.dtype
    n, h, w, _ = x.shape
    lo, hi = _valid_range(sc_valid, w)
    col = torch.arange(w, device=x.device)
    valid = ((col >= lo) & (col < hi))[None, None, :, None].to(dtype)
    layers = _layers(p)
    for li, lp in enumerate(layers):
        k = kernel(lp, dtype)
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        cols = torch.cat([xp[:, dy:dy + h, dx:dx + w]
                          for dy in range(3) for dx in range(3)], dim=-1)
        y = cols @ k.reshape(-1, k.shape[-1]) + lp["b"].to(dtype)
        if li < len(layers) - 1:
            y = torch.relu(y)
        x = y * valid
    return x


def sepconv_stack_folded(p, x: torch.Tensor, sc_valid=None) -> torch.Tensor:
    """The separable stack by the JAX package's folded lowering of its XLA
    layers: per layer one full 3x3 convolution with the kernel
    dw[:, :, 0, :, None] * pw (both in x.dtype, the product rounded there),
    by `_im2col_stack`. The gradients reach dw and pw through the fold."""
    return _im2col_stack(
        p, x, sc_valid,
        lambda lp, dt: lp["dw"].to(dt)[:, :, 0, :, None] * lp["pw"].to(dt))


def conv_stack(p, x: torch.Tensor, sc_valid=None) -> torch.Tensor:
    """A stack of full 3x3 conv layers {"w": [3, 3, C, O], "b": [O]} (layer
    type "conv"; the JAX package's `_apply_conv`, which no Pallas kernel
    computes), by `_im2col_stack` with w in x.dtype."""
    return _im2col_stack(p, x, sc_valid, lambda lp, dt: lp["w"].to(dt))


def _apply_conv_stack(p, x, fused: bool = False, sc_valid=None, mesh=None,
                      kernels: bool = True, mxu: bool | None = None,
                      lp_stencil: bool | None = None,
                      layer_type: str = "sepconv"):
    """Conv stack of `layer_type`, ReLU after each hidden layer. Separable
    layers: fused, through the stack kernel in the modes mxu / lp_stencil
    (None: the env knobs), or with kernels=False its plain version in the
    same modes; else the plain layers (`sepconv_stack_folded` under
    `sepconv_folded()`, else the stack's plain version). Full 3x3 layers
    ("conv") take `conv_stack` whatever `fused` says, as the JAX package's
    do. sc_valid (optional): columns outside the valid range are re-zeroed
    per layer (exact pad-to-bucket dispatch). mesh (grid axis > 1): x is a
    subcarrier shard, extended by its neighbours' halos first."""
    if layer_type == "conv":
        stack = conv_stack
    elif fused:
        stack = functools.partial(
            fused_conv_stack if kernels else sepconv_stack_reference,
            mxu=mxu_default(mxu), lp_stencil=lp_default(lp_stencil))
    elif sepconv_folded():
        stack = sepconv_stack_folded
    else:
        stack = sepconv_stack_reference
    if mesh is not None:
        return fused_sharded.sharded_stack(stack, p, x, mesh)
    return stack(p, x, sc_valid=sc_valid)


def _one_hidden(mlp) -> bool:
    return len(mlp["hidden"]) == 1


def _apply_mlp(p, x):
    for lp in p["hidden"]:
        x = torch.relu(x @ lp["w"].to(x.dtype) + lp["b"].to(x.dtype))
    return x @ p["out"]["w"].to(x.dtype) + p["out"]["b"].to(x.dtype)


def _aggregate_user_states(p, s, active_tx, dtype):
    """GNN message passing. s: [b, T, sym, sc, d_s]; active_tx: [b, T].
    a_n = (sum_{n' active} sp_{n'} - sp_n) / max(num_active - 1, 1)."""
    sp = _apply_mlp(p, s)
    mask = active_tx.to(dtype)[:, :, None, None, None]
    sp = sp * mask
    a = sp.sum(dim=1, keepdim=True) - sp
    p_cnt = torch.relu(mask.sum(dim=1, keepdim=True) - 1.0)
    one = torch.ones((), dtype=dtype, device=s.device)
    scale = torch.where(p_cnt == 0.0, one, 1.0 / torch.clamp(p_cnt, min=1.0))
    return a * scale


def _update_state(p, s, a, pe, fused: bool = False, sc_valid=None,
                  mesh=None, kernels: bool = True,
                  layer_type: str = "sepconv"):
    """Conv state update with residual skip. A fused stack here takes no
    mode argument, as in the JAX package: its modes come from the env
    knobs alone."""
    b, t = s.shape[0], s.shape[1]
    pe_b = pe[None].expand((b,) + pe.shape)
    z = torch.cat([a, s, pe_b], dim=-1)
    z = z.reshape((b * t,) + z.shape[2:])
    z = _apply_conv_stack(p, z, fused, sc_valid, mesh, kernels,
                          layer_type=layer_type)
    return z.reshape((b, t) + z.shape[1:]) + s


def cgnn_apply(params, cfg: CGNNConfig, y, pe, h_hat, active_tx,
               mcs_ue_mask, num_it: int | None = None, dtype=torch.float32,
               sc_valid=None, training: bool = False,
               apply_multiloss: bool = False, mesh=None):
    """Forward pass, readout after iteration `num_it` (default cfg.num_it,
    1 <= num_it <= cfg.num_it).

    y: [b, sym, sc, 2*rx_ant]; pe: [T, sym, sc, 2];
    h_hat: [b, T, sym, sc, 2*rx_ant] (LS estimate), or None for a CGNN
    without it (`cfg.initial_chest` False); active_tx: [b, T];
    mcs_ue_mask: [b, T, num_mcs] one-hot. sc_valid (optional int): number
    of valid leading subcarriers of a bucket-padded grid; the power norm
    then averages over valid REs and every conv layer re-zeros the padding.

    The initial state is one init stack per MCS, each times its column of
    mcs_ue_mask and summed in MCS order, or with `var_mcs_masking` one
    shared init stack without the mask. Routes and their gates are the
    JAX package's; a route whose gate fails falls back to the next, down
    to the plain layers. `fused_full` runs the whole CGNN in one kernel
    from the stacked inputs (without `mcs_ue_mask`, as there) for one MCS
    without masking, separable layers, no `apply_multiloss`, and
    one-hidden-layer aggregation MLPs (every iteration run) and readouts.
    `fused_iteration` runs each iteration whose aggregation MLP has one
    hidden layer in the iteration kernel (separable layers), and with
    `fused_readout` (one MCS, no masking, no `apply_multiloss`,
    one-hidden-layer readouts) the last one returns both readouts.
    Otherwise the readouts are plain: one LLR readout per MCS, or with
    masking the single readout cut to each MCS's bits. `fused_convs` runs
    separable stacks in the stack kernel; full 3x3 layers
    (`layer_type_conv` "conv") always take `conv_stack`, for which no
    kernel exists, as the JAX package's take its XLA layers. With
    `training` no fused route is taken (plain layers, differentiable), and
    with `training` and `apply_multiloss` the readouts follow every
    iteration.

    Layer modes, routed as in the JAX package: `fused_full` takes
    `stencil_lp` (never the folded mode); the init stacks take both
    `conv_mxu` and `stencil_lp`; an iteration kernel takes `stencil_lp`.
    With `fused_iteration` and `conv_mxu` resolved true the iterations warn
    and take the non-fused route, whose update stacks (`_update_state`)
    pass no mode: they run in the modes of the env knobs alone. The plain
    layers (no fused route) take no mode.

    mesh (`dist.mesh.Mesh`, optional): y, pe and h_hat are this rank's
    block of the subcarrier axis, split over the mesh's grid axis (the
    batch block is the caller's), and so are the outputs. With a grid axis
    wider than 1 the input power norm sums its squares (in float64, as
    without a mesh) and counts over the grid group; every conv
    stack runs on the shard extended by its neighbours' halos
    (`dist/fused_sharded.py`), an iteration of the iteration kernel too;
    and `fused_full` takes the stack and iteration kernels' route instead
    of the whole-CGNN kernel, which cannot exchange halos between its
    iterations (both routes compute the same plain function). Each kernel
    computes on its extended shard what it computes on the full grid, bit
    for bit on its columns. Not with sc_valid, nor in training (the batch
    is the only axis training shards).

    Returns (llrs, h_hats) shaped like the JAX package's: a list over
    readout points of [llr per MCS] with llr [b, T, sym, sc, num_bits],
    and a list of h_hat [b, T, sym, sc, 2*rx_ant], float32.
    """
    num_it = cfg.num_it if num_it is None else num_it
    if not 1 <= num_it <= cfg.num_it:
        raise ValueError(f"num_it must lie in 1..{cfg.num_it}, got {num_it}")
    if cfg.layer_type_conv not in ("sepconv", "conv"):
        raise ValueError(f"unknown layer type {cfg.layer_type_conv!r}")
    if (h_hat is None) == cfg.initial_chest:
        raise ValueError("h_hat is the CGNN's input exactly when "
                         "cfg.initial_chest")
    if mesh is not None and mesh.grid == 1:
        mesh = None  # the whole band: the single-device computation
    if mesh is not None and (sc_valid is not None or training):
        raise ValueError("a subcarrier shard takes no sc_valid and does not "
                         "train")
    b = y.shape[0]
    t = pe.shape[0]
    n_sc = y.shape[2]
    its = params["iterations"][:num_it]
    layer_type = cfg.layer_type_conv
    sep = layer_type == "sepconv"
    single = cfg.num_mcs == 1 and not cfg.var_mcs_masking
    # the fused kernels' MLPs have one hidden layer; the JAX package gates
    # each fused route on that and falls back to its plain layers
    fused_readouts = (not apply_multiloss and single
                      and _one_hidden(params["readout_llrs"][0])
                      and _one_hidden(params["readout_chest"]))
    fused_full = (cfg.fused_full and not training and sep and fused_readouts
                  and all(_one_hidden(it_p["agg"]) for it_p in its))
    fused_convs = cfg.fused_convs and not training
    fused_iteration = cfg.fused_iteration and not training and sep
    mxu, lp = mxu_default(cfg.conv_mxu), lp_default(cfg.stencil_lp)

    sc_mask = None
    if sc_valid is not None:
        sc_mask = (torch.arange(n_sc, device=y.device) < sc_valid).to(
            torch.float32)[None, None, :, None]
        y = y * sc_mask
        pe = pe * sc_mask
        if h_hat is not None:
            h_hat = h_hat * sc_mask[None]

    # Input power normalization: unit mean power per batch sample, over
    # the valid REs alone (the same reduction as a grid of the valid width,
    # so a bucket-padded grid's norm equals the direct one's bit for bit).
    # The squares are summed in float64 and the mean rounded to float32,
    # so the norm does not depend on how the sum is split (the batch size,
    # the device's reduction tiling, subcarrier shards)
    y_valid = y if sc_valid is None else y[:, :, :sc_valid]
    sq = torch.stack([(y_valid.double() ** 2).sum(dim=(1, 2, 3)),
                      torch.full((b,), float(y_valid[0].numel()),
                                 dtype=torch.float64, device=y.device)])
    if mesh is not None:
        sq = sum_over_grid(sq, mesh)
    mean_sq = (sq[0] / sq[1]).float()[:, None, None, None]
    norm = torch.rsqrt(mean_sq + 1e-12)
    y = (y * norm).to(dtype)
    pe = pe.to(dtype)

    # Stack per-user input: broadcast y to all users
    y_b = y[:, None].expand((b, t) + y.shape[1:])
    pe_b = pe[None].expand((b, t) + pe.shape[1:])
    feats = [y_b, pe_b]
    if h_hat is not None:
        feats.append((h_hat * norm[:, None]).to(dtype))
    z0 = torch.cat(feats, dim=-1)
    z0_flat = z0.reshape((b * t,) + z0.shape[2:])

    if fused_full and mesh is None:
        full = (cgnn_iter.fused_cgnn_full if cfg.kernels
                else cgnn_iter.fused_cgnn_full_reference)
        llr, h_out = full(params, z0, pe, active_tx, sc_valid, num_it,
                          lp_stencil=lp)
        return [[llr.float()]], [h_out.float()]

    # K4's route on a shard: K1, then K3, the last iteration with readouts
    # (K4 never takes the folded mode)
    fused_convs = fused_convs or fused_full
    fused_iteration = fused_iteration or fused_full
    fused_readout = (cfg.fused_readout and fused_readouts) or fused_full
    if fused_full:
        mxu = False

    def run_init(p):
        s = _apply_conv_stack(p, z0_flat, fused_convs, sc_valid, mesh,
                              cfg.kernels, mxu, lp, layer_type)
        return s.reshape((b, t) + s.shape[1:])

    if cfg.var_mcs_masking:
        s = run_init(params["s_init"][0])
    else:
        mm = mcs_ue_mask.to(dtype)
        s = run_init(params["s_init"][0]) * mm[:, :, 0:1][..., None, None]
        for idx in range(1, cfg.num_mcs):
            s = s + (run_init(params["s_init"][idx])
                     * mm[:, :, idx:idx + 1][..., None, None])

    def readouts(s):
        if cfg.var_mcs_masking:
            out = _apply_mlp(params["readout_llrs"][0], s).float()
            llr = [out[..., :nb] for nb in cfg.num_bits_per_symbol]
        else:
            llr = [_apply_mlp(p, s).float() for p in params["readout_llrs"]]
        return llr, _apply_mlp(params["readout_chest"], s).float()

    if fused_iteration and mxu:
        # the folded mode is the stack kernel's alone: the iterations take
        # the non-fused route, as in the JAX package, which warns only
        # where the kernel could otherwise have taken every iteration
        if all(_one_hidden(it_p["agg"]) for it_p in its):
            warnings.warn("fused_iteration requested with conv_mxu "
                          "resolved true; conv_mxu is unsupported in the "
                          "iteration kernel: using the non-fused iteration "
                          "route instead")
        fused_iteration = False
    iterate = (functools.partial(cgnn_iter.fused_iteration, mxu=False,
                                 lp_stencil=lp) if cfg.kernels
               else functools.partial(cgnn_iter.fused_iteration_reference,
                                      lp_stencil=lp))
    if mesh is not None:
        kernel = iterate

        def iterate(it_p, s, pe, active_tx, sc_valid, *readout):
            return fused_sharded.fused_iteration_sharded(
                it_p, s, pe, active_tx, mesh, *readout, iterate=kernel)
    llrs, h_hats = [], []
    for i, it_p in enumerate(its):
        if fused_iteration and _one_hidden(it_p["agg"]):
            if fused_readout and i == num_it - 1:
                llr, h_out = iterate(it_p, s, pe, active_tx, sc_valid,
                                     params["readout_llrs"][0],
                                     params["readout_chest"])
                return [[llr.float()]], [h_out.float()]
            s = iterate(it_p, s, pe, active_tx, sc_valid)
        else:
            a = _aggregate_user_states(it_p["agg"], s, active_tx, dtype)
            if sc_mask is not None:
                # pad columns carry MLP(0); the update stack's first 3x3
                # conv would bleed it into the last valid column
                a = a * sc_mask[None].to(a.dtype)
            s = _update_state(it_p["update"], s, a, pe, fused_convs,
                              sc_valid, mesh, cfg.kernels, layer_type)
        if (training and apply_multiloss) or i == num_it - 1:
            llr, h_out = readouts(s)
            llrs.append(llr)
            h_hats.append(h_out)
    return llrs, h_hats


def pilot_positional_encoding(dmrs_grids: np.ndarray,
                              pilot_mask: np.ndarray) -> np.ndarray:
    """2-D positional encoding: z-scored distance to the nearest own pilot.

    dmrs_grids: [num_tx, sym, sc] complex (one slot's DMRS bank entry).
    pilot_mask: [sym, sc] bool (unused beyond the interface).
    Returns [num_tx, sym, sc, 2] float32 (time-dist, freq-dist), z-scored:
    time over the symbol axis per (tx, sc), freq over the subcarrier axis
    per (tx, sym).
    """
    num_tx, n_sym, n_sc = dmrs_grids.shape
    out = np.zeros((num_tx, n_sym, n_sc, 2), np.float32)
    for tx in range(num_tx):
        ip, jp = np.where(np.abs(dmrs_grids[tx]) > 1e-3)
        dt = np.abs(np.arange(n_sym)[:, None, None] - ip[None, None, :])
        df = np.abs(np.arange(n_sc)[None, :, None] - jp[None, None, :])
        nearest_t = dt.min(-1).astype(np.float64)  # [sym, 1] broadcast
        nearest_t = np.broadcast_to(nearest_t, (n_sym, n_sc)).astype(
            np.float64).copy()
        nearest_f = np.broadcast_to(df.min(-1), (n_sym, n_sc)).astype(
            np.float64).copy()
        nearest_t -= nearest_t.mean(axis=0, keepdims=True)
        std = nearest_t.std(axis=0, keepdims=True)
        nearest_t = np.where(std > 0, nearest_t / np.where(std > 0, std, 1),
                             nearest_t)
        nearest_f -= nearest_f.mean(axis=1, keepdims=True)
        std = nearest_f.std(axis=1, keepdims=True)
        nearest_f = np.where(std > 0, nearest_f / np.where(std > 0, std, 1),
                             nearest_f)
        out[tx, ..., 0] = nearest_t
        out[tx, ..., 1] = nearest_f
    return out
