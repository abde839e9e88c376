"""Serving entry point: the nrx_rt receiver at 132 PRB on the GPU.

`entry()` mirrors the JAX package's `__graft_entry__.entry()`: LS estimate +
CGNN + both readouts, in bfloat16 with float32 parameters, returning (llr,
h_hat), by the JAX entry's batch-adaptive route. At batch <= 4 every
separable-conv stack runs in the stack kernel (`fused_convs=True`); at
batch > 4 the init stack does and each iteration runs in the iteration
kernel (`fused_iteration=True`); with mega=True (the JAX entry's
`NRX_DEPLOY_MEGA=1`) the whole CGNN runs in one kernel (`fused_full=True`).
It uses the committed `weights/nrx_rt_ema_weights.npz`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import weights
from .kernels.cgnn_iter import pack_mlp
from .kernels.sepconv import pack_stack
from .rx.neural_rx import NeuralPUSCHReceiver, resolve_device
from .sim.config import Parameters

NRX_DTYPE = torch.bfloat16


def make_receiver(training: bool = False, nrx_dtype=NRX_DTYPE,
                  fused_full: bool = False, kernels: bool = True,
                  device="cuda"
                  ) -> NeuralPUSCHReceiver:
    """The nrx_rt receiver: 132 PRB (eval grid) or, with training=True,
    the 4-PRB training grid. fused_full: the whole-CGNN kernel route;
    kernels=False: the kernels' plain versions on the same route."""
    p = Parameters("nrx_rt", training=training)
    return NeuralPUSCHReceiver(
        p.resource_grid, [c[0].num_bits_per_symbol for c in p.pusch_configs],
        num_rx_ant=p.num_rx_antennas,
        max_num_tx=p.max_num_tx, num_it=p.num_nrx_iter, d_s=p.d_s,
        num_units_init=p.num_units_init, num_units_agg=p.num_units_agg,
        num_units_state=p.num_units_state,
        num_units_readout=p.num_units_readout,
        layer_type_conv=p.layer_type_conv,
        var_mcs_masking=p.mcs_var_mcs_masking, nrx_dtype=nrx_dtype,
        fused_full=fused_full, kernels=kernels, device=device)


def load_params(dtype=NRX_DTYPE, device="cuda") -> dict:
    """{"cgnn": tree} of the committed nrx_rt EMA weights on `device`, with
    every conv stack and MLP packed once for the kernels."""
    cgnn = weights.load(weights.NRX_RT_EMA, device=device)
    for stack in cgnn["s_init"] + [it["update"] for it in cgnn["iterations"]]:
        pack_stack(stack, dtype)
    for mlp in [it["agg"] for it in cgnn["iterations"]] + [
            cgnn["readout_llrs"][0], cgnn["readout_chest"]]:
        pack_mlp(mlp, dtype)
    return {"cgnn": cgnn}


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
