"""Serving entry point: the nrx_rt receiver at 132 PRB on the GPU.

`entry()` mirrors the JAX package's `__graft_entry__.entry()`: LS estimate +
CGNN + both readouts, in bfloat16 with float32 parameters, returning (llr,
h_hat), by the JAX entry's batch-adaptive route. At batch <= 4 every
separable-conv stack runs in the stack kernel (`fused_convs=True`); at
batch > 4 the init stack does and each iteration runs in the iteration
kernel (`fused_iteration=True`); with mega=True (the JAX entry's
`NRX_DEPLOY_MEGA=1`) the whole CGNN runs in one kernel (`fused_full=True`).
It uses the committed `weights/nrx_rt_ema_weights.npz`.

`eval_entry()` is the eval receive path at the same width in float32 (the
configuration's `nrx_dtype`, as the JAX package evaluates): `apply` ->
LS estimate + CGNN (same routes) -> per-user transport-block decode, by the
layered min-sum kernel (`fast_ldpc=True`) or the flooding decoder. Its
example input is a slot of seeded random transport blocks through the
port's transmitter, a seeded flat Rayleigh channel (`flat_channel`) and
seeded noise at the given Eb/N0.

`mc_entry()` is one Monte-Carlo step of the BLER evaluation at the same
width: `sim.e2e.E2EModel` of nrx_rt (eval: 132 PRB, float32, its
DoubleTDLlow channel), or of another configuration on one of its MCS and
a cut iteration count, draws the bits, the channel and the noise from a
`torch.Generator` on the device, transmits, receives and decodes, and the
step returns the error counters (`sim.simber.make_eval_step`).
`mixed_mcs_entry()` is the same step in a mixed-MCS slot
(`sim.mixed_mcs`): users on different MCS, user 0's blocks counted, with
the neural receiver or LS/lin.

`baseline_entry()` is the same step with a classical receiver
(`sim.baseline_e2e.BaselineE2EModel`: LS, LMMSE or perfect-CSI channel
estimate, LMMSE or K-Best detection) of any configuration in eval mode.

`deploy_entry()` is the deployed engine (`deploy/`): one Aerial-ABI
engine per PRB bucket of a configuration (nrx_rt: 2 users, 4 rx antennas,
14 symbols, buckets 4 to 273 PRB, bfloat16), pad-to-bucket dispatch, and
in graph mode one CUDA graph per (bucket, valid width); the export CLI's
route (the stack kernel on the init stack, the iteration kernel on every
iteration) or the whole-CGNN kernel (mega).

`train_entry()` is one training step (`sim.training.make_step`) of a
configuration at its training width (nrx_rt: 4 PRB, 4 rx antennas, 2 users,
batch 128, UMi, float32) with the first phase of its schedule: the
per-step sampling and draws from a `torch.Generator` on the device, the
forward through the plain layers, the backward pass and an Adam update of
seed-made parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from . import weights
from .kernels.cgnn_iter import pack_mlp
from .kernels.sepconv import pack_stack
from .channel.apply import apply_ofdm_channel
from .deploy.aerial import AerialNRX
from .deploy.aot import DEFAULT_PRB_BUCKETS, BucketedReceiver, engine_config
from .phy.misc import binary_source
from .rx.neural_rx import NeuralPUSCHReceiver, receiver_for, resolve_device
from .sim.baseline_e2e import BaselineE2EModel
from .sim.config import Parameters
from .sim.e2e import E2EModel
from .sim.mixed_mcs import MixedMCSBaselineModel, MixedMCSE2EModel
from .sim.simber import make_eval_step
from .sim.training import make_adam, make_step, trainable

NRX_DTYPE = torch.bfloat16


def flat_channel(w: np.ndarray, batch: int, num_rx_ant: int, n_sym: int,
                 n_sc: int, seed: int = 0, device="cpu") -> torch.Tensor:
    """A flat Rayleigh channel matched to each user's precoder: one
    complex gain g[b, a, t] ~ CN(0, 1) per (batch item, rx antenna, user)
    from `np.random.default_rng(seed)`, constant over the slot, with
    h[b, a, t, p] = g[b, a, t] * conj(w[t, p]) / sum_p |w[t, p]|^2, so the
    user's effective channel is g. w: [T, ports] precoders. Returns
    [b, rx_ant, T, ports, n_sym, n_sc] complex64 (a broadcast view).
    This is the example input's channel, not one of the system's channel
    models: it lets both users be told apart by 4 antennas in one slot."""
    rng = np.random.default_rng(seed)
    t = w.shape[0]
    g = (rng.normal(size=(batch, num_rx_ant, t))
         + 1j * rng.normal(size=(batch, num_rx_ant, t))) / np.sqrt(2.0)
    h = g[..., None] * np.conj(w)[None, None] / np.sum(
        np.abs(w) ** 2, axis=-1)[None, None, :, None]
    h = torch.as_tensor(h.astype(np.complex64), device=device)
    return h[..., None, None].expand(h.shape + (n_sym, n_sc))


def eval_example(p: Parameters, batch: int, ebno_db: float, seed: int = 0,
                 device="cuda"):
    """(bits [b, T, tb_size], y [b, rx_ant, 14, sc], active_tx [b, T]) of
    one slot with all users active: seeded random transport blocks through
    the transmitter of the first MCS on `device`, `flat_channel` and
    CN(0, N0) noise at `ebno_db` (`Parameters.noise_variance`). Bits and
    noise come from a CPU `torch.Generator` seeded with `seed` (and the
    channel from numpy), so every device gets the same slot and the CPU
    tests can hold the JAX package to the slot the card decodes."""
    device = resolve_device(device)
    tx = p.transmitters[0]
    rg = tx.resource_grid
    gen = torch.Generator().manual_seed(seed)
    bits = binary_source((batch, p.max_num_tx, tx.tb_size), gen).to(device)
    h = flat_channel(tx.w[..., 0], batch, p.num_rx_antennas,
                     rg.num_ofdm_symbols, rg.num_subcarriers, seed, device)
    y = apply_ofdm_channel(tx(bits), h, p.noise_variance(ebno_db),
                           generator=gen)
    return bits, y, torch.ones((batch, p.max_num_tx), device=device)


def make_receiver(training: bool = False, nrx_dtype=NRX_DTYPE,
                  fused_full: bool = False, kernels: bool = True,
                  device="cuda"
                  ) -> NeuralPUSCHReceiver:
    """The nrx_rt receiver: 132 PRB (eval grid) or, with training=True,
    the 4-PRB training grid. fused_full: the whole-CGNN kernel route;
    kernels=False: the kernels' plain versions on the same route."""
    return receiver_for(Parameters("nrx_rt", training=training), nrx_dtype,
                        fused_full=fused_full, kernels=kernels, device=device)


def pack_params(params: dict, dtype=NRX_DTYPE) -> dict:
    """params with every separable conv stack and one-hidden-layer MLP of
    params["cgnn"] (what the kernels take) packed once for the kernels in
    `dtype` (the packed buffers are cached in the tree: pack trained
    parameters after their last update)."""
    cgnn = params["cgnn"]
    for stack in cgnn["s_init"] + [it["update"] for it in cgnn["iterations"]]:
        if "dw" in stack["out"]:
            pack_stack(stack, dtype)
    for mlp in [it["agg"] for it in cgnn["iterations"]] + cgnn[
            "readout_llrs"] + [cgnn["readout_chest"]]:
        if len(mlp["hidden"]) == 1:
            pack_mlp(mlp, dtype)
    return params


def load_params(dtype=NRX_DTYPE, device="cuda",
                path: str = weights.NRX_RT_EMA,
                template: dict | None = None) -> dict:
    """{"cgnn": tree} of the weights in `path` (default: the committed
    nrx_rt EMA weights) on `device`, with every conv stack and MLP packed
    once for the kernels, and "constellation" where the file holds a
    trained one. A reference weight file (not `.npz`) is read onto the
    tree of template (default: nrx_rt's, `make_receiver().init_params`)."""
    if template is None and not path.endswith(".npz"):
        template = make_receiver(device="cpu").init_params(
            torch.Generator().manual_seed(0))
    return pack_params(weights.load_tree(path, device=device,
                                         template=template), dtype)


def entry(device="cuda", batch: int = 1, mega: bool = False):
    """Returns (fn, example_args): fn(params, y_planar) -> (llr, h_hat) with
    y_planar [batch, 4, 14, 1584, 2] float32 on `device`. fn takes the
    batch-adaptive route of the JAX entry, or with mega=True the
    whole-CGNN kernel."""
    device = resolve_device(device)
    rx = make_receiver(fused_full=mega, device=device)
    params = load_params(device=device)
    sc = rx.rg.num_subcarriers
    y = np.random.default_rng(0).normal(size=(batch, 4, 14, sc, 2))
    y_example = torch.as_tensor(y, dtype=torch.float32, device=device)
    return rx.serve, (params, y_example)


def eval_entry(device="cuda", batch: int = 16, ebno_db: float = 10.0,
               fast_ldpc: bool = True):
    """Returns (fn, example_args): fn(params, y, active_tx) -> (b_hat
    [b, T, tb_size], crc [b, T]), the eval receive path at 132 PRB in
    float32, decoding with the layered min-sum kernel (fast_ldpc=True) or
    the flooding decoder; example_args = (params, y, active_tx) from
    `eval_example` with seed 0, whose bits are the ones sent."""
    device = resolve_device(device)
    p = Parameters("nrx_rt", training=False)
    rx = make_receiver(nrx_dtype=p.nrx_dtype, device=device)
    params = load_params(dtype=p.nrx_dtype, device=device)
    _, y, active_tx = eval_example(p, batch, ebno_db, device=device)

    def fn(params, y, active_tx):
        b_hat, _, _, crc = rx.apply(params, y, active_tx,
                                    fast_ldpc=fast_ldpc)
        return b_hat, crc

    return fn, (params, y, active_tx)


def mc_entry(device="cuda", batch: int = 30, ebno_db: float = 3.0,
             fast_ldpc: bool = True, seed: int = 0, config: str = "nrx_rt",
             mcs_idx: int = 0, num_it: int | None = None,
             data_dir: str | None = None):
    """Returns (fn, example_args): fn(params, generator) -> int64 [4]
    counters (bit errors, bits, block errors, blocks) of one Monte-Carlo
    step of `config` in eval mode (nrx_rt: 132 PRB, float32, DoubleTDLlow)
    on its MCS mcs_idx, with the CGNN cut to num_it iterations (default:
    all), at `batch` slots and `ebno_db`, decoding with the layered min-sum
    kernel (fast_ldpc=True) or the flooding decoder, with the committed
    weights (`weights.committed_weights`); example_args = (params, a
    generator on `device` seeded with `seed`). data_dir: where a Dataset
    channel's files are (default: the repository's data/)."""
    device = resolve_device(device)
    p = Parameters(config, training=False, data_dir=data_dir)
    model = E2EModel(p, device=device)
    params = load_params(dtype=p.nrx_dtype, device=device,
                         path=weights.committed_weights(p.label))
    step = make_eval_step(model, fast_ldpc=fast_ldpc, num_it=num_it,
                          mcs_arr_eval_idx=mcs_idx)

    def fn(params, generator):
        return step(params, generator, batch, ebno_db)

    return fn, (params, torch.Generator(device=device).manual_seed(seed))


def baseline_entry(system: str, config: str = "nrx_rt", device="cuda",
                   batch: int = 30, ebno_db: float = 4.0,
                   num_tx_eval: int | None = None, fast_ldpc: bool = True,
                   seed: int = 0, cov_dir: str | None = None,
                   data_dir: str | None = None):
    """Returns (fn, example_args): fn(params, generator) -> int64 [4]
    counters of one Monte-Carlo step of the baseline `system` (one of
    `sim.baseline_e2e.SYSTEMS`) on `config` in eval mode (132 PRB for every
    shipped configuration) with `num_tx_eval` users (default: all of the
    configuration's), at `batch` slots and `ebno_db`, decoding with the
    layered min-sum kernel (fast_ldpc=True) or the flooding decoder;
    example_args = ({}, a generator on `device` seeded with `seed`). The
    LMMSE estimate reads its covariances from `cov_dir` (default:
    weights/), or computes them there on `device` when they are missing;
    data_dir as `mc_entry`'s."""
    device = resolve_device(device)
    p = Parameters(config, system=system, training=False,
                   num_tx_eval=num_tx_eval, data_dir=data_dir)
    model = BaselineE2EModel(p, system, cov_dir=cov_dir, device=device)
    step = make_eval_step(model, fast_ldpc=fast_ldpc)

    def fn(params, generator):
        return step(params, generator, batch, ebno_db)

    return fn, ({}, torch.Generator(device=device).manual_seed(seed))


def mixed_mcs_entry(config: str = "nrx_rt_var_mcs", mcs_order=(0, 1),
                    mask_rows=((1, 0), (0, 1)), system: str = "nrx",
                    device="cuda", batch: int = 30, ebno_db: float = 1.0,
                    fast_ldpc: bool = True, seed: int = 0):
    """Returns (fn, example_args): fn(params, generator) -> int64 [4]
    counters of one Monte-Carlo step of a mixed-MCS slot of `config` in
    eval mode: user u on the MCS of the one-hot row mask_rows[u], the
    evaluation order mcs_order (user 0's MCS first: its noise variance and
    decode chain), user 0's transport blocks counted; system "nrx" (the
    committed weights) or "lslin" (LS/lin + LMMSE, params {});
    example_args = (params, a generator on `device` seeded with `seed`).
    The default is the reference's mix: user 0 on QPSK (MCS 9), user 1 on
    16-QAM (MCS 14)."""
    device = resolve_device(device)
    p = Parameters(config, training=False)
    mask = torch.tensor([mask_rows], dtype=torch.float32)
    if system == "nrx":
        model = MixedMCSE2EModel(p, mcs_order, mcs_ue_mask=mask,
                                 device=device)
        params = load_params(dtype=p.nrx_dtype, device=device,
                             path=weights.committed_weights(p.label))
    elif system == "lslin":
        model = MixedMCSBaselineModel(p, mcs_order, mcs_ue_mask=mask,
                                      device=device)
        params = {}
    else:
        raise ValueError(f"system nrx or lslin, not {system!r}")
    step = make_eval_step(model, fast_ldpc=fast_ldpc)

    def fn(params, generator):
        return step(params, generator, batch, ebno_db)

    return fn, (params, torch.Generator(device=device).manual_seed(seed))


def train_entry(config: str = "nrx_rt", device="cuda",
                batch: int | None = None, seed: int = 0,
                data_dir: str | None = None,
                overrides: dict | None = None):
    """Returns (fn, example_args): fn(params, generator) -> (loss_data,
    loss_chest, loss), 0-dim device tensors, one training step of `config`
    (`E2EModel(training=True)`, its training channel and width) with the
    first phase of its schedule (learning rate, Eb/N0 ranges, double
    readout and weight, multiloss, train_tx) at `batch` (default: the
    phase's), updating params in place with Adam (optax's defaults, created
    here); example_args = (seed-made trainable params, a generator on
    `device` seeded with `seed`); data_dir as `mc_entry`'s; overrides as
    `Parameters`' (e.g. {"layer_type_conv": "conv"})."""
    device = resolve_device(device)
    p = Parameters(config, training=True, data_dir=data_dir,
                   overrides=overrides)
    model = E2EModel(p, training=True, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = trainable(model.init_params(gen))
    sched = p.training_schedule
    step = make_step(
        model, p, make_adam(params, float(sched["learning_rate"][0])),
        list(range(len(p.mcs_index))), batch or int(sched["batch_size"][0]),
        bool(sched["double_readout"][0]),
        float(sched["weighting_double_readout"][0]),
        bool(sched["apply_multiloss"][0]), bool(sched["train_tx"][0]))
    step.set_snr_range(sched["min_training_snr_db"][0],
                       sched["max_training_snr_db"][0])
    return step, (params, gen)


def deploy_entry(config: str = "nrx_rt", buckets=DEFAULT_PRB_BUCKETS,
                 batch: int = 1, dtype=torch.bfloat16, mega: bool = False,
                 graphs: bool = True, device="cuda",
                 fused_convs: bool = True, fused_iteration: bool = True,
                 params: dict | None = None,
                 weights_dir: str = weights.WEIGHTS_DIR):
    """Returns (receiver, examples): a `deploy.aot.BucketedReceiver` of
    `config`'s eval receiver with one `AerialNRX` engine per PRB bucket
    (each grid at that width), in `dtype`, graphs captured for `batch`
    (graphs=True: a CUDA device only; graphs=False serves every call
    eagerly), and {n_prb: seeded example inputs} per bucket. Route:
    `deploy.aot.engine_config` (fused_convs, fused_iteration, mega).
    params: {"cgnn": tree} (default: the committed weights of weights_dir,
    else seed-made ones from seed 0), packed here for `dtype`."""
    device = resolve_device(device)

    def params_at(n_prb):
        return Parameters(config, training=False,
                          overrides={"n_size_bwp": n_prb})

    def make_engine(n_prb):
        p = params_at(n_prb)
        rx = receiver_for(p, device=device)
        cfg = engine_config(rx.cgnn_cfg, fused_convs, fused_iteration, mega)
        return AerialNRX.from_grid(rx.rg, cfg, num_it=p.num_nrx_iter_eval,
                                   dtype=dtype, device=device)

    if params is None:
        p = params_at(min(buckets))
        path = weights.committed_weights(p.label, weights_dir)
        params = weights.load_tree(path, device=device) \
            if weights.exists(path) else receiver_for(
                p, device=device).init_params(
                    torch.Generator(device=device).manual_seed(0))
    receiver = BucketedReceiver(make_engine, pack_params(params, dtype),
                                batch, buckets, graphs)
    return receiver, {n: receiver.example_inputs(n) for n in buckets}
