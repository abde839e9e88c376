"""The work counts behind `chip_smoke.py`'s bounds and shares of bound.

`chip_smoke.py` reports each kernel's bound as max(bytes / memory rate,
operations / peak rate) and its share of that bound, from `iteration_work`
and `full_work`. Here those counts are held, for the committed nrx_rt
weights at 132 PRB, against closed forms written out from the layer widths,
and the ulp measure of its kernel checks against hand-made bfloat16 values.
CPU only: nothing here launches a kernel.
"""

import importlib.util
import os

import pytest
import torch

from neural_rx_tpu_torch import weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_TX, N_SYM, N_SC = 2, 14, 1584
D_S, D_PE, AGG_HID = 56, 2, 64
INIT = (18, 128, 128, 56)
UPDATE = (114, 128, 128, 56)
LLR = (56, 128, 4)
CHEST = (56, 128, 8)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


@pytest.fixture(scope="module")
def cgnn():
    return weights.load(weights.NRX_RT_EMA, device="cpu")


def positions(b):
    return b * N_TX * N_SYM * N_SC


# Per position: a separable layer is 9 depthwise multiply-adds per input
# channel, c_in * c_out pointwise multiply-adds and c_out bias adds; a
# one-hidden-layer MLP two dense layers with their biases.
def sep_layer(ci, co):
    return 2 * 9 * ci + 2 * ci * co + co


def stack(widths):
    return sum(sep_layer(ci, co) for ci, co in zip(widths[:-1], widths[1:]))


def mlp(i, h, o):
    return 2 * i * h + h + 2 * h * o + o


# One iteration: aggregation MLP, user sum, difference and scale (3 ops a
# channel), update stack, residual (1 op a channel).
ITERATION = mlp(D_S, AGG_HID, D_S) + 3 * D_S + stack(UPDATE) + D_S
WHOLE = stack(INIT) + 2 * ITERATION + mlp(*LLR) + mlp(*CHEST)


def test_closed_forms_have_the_published_values():
    assert positions(16) == 709_632
    assert positions(1) == 44_352
    assert ITERATION == 97_940
    assert stack(INIT) == 56_956
    assert (mlp(*LLR), mlp(*CHEST)) == (15_492, 16_520)
    assert WHOLE == 284_848


def test_weights_have_the_widths_of_the_closed_forms(smoke, cgnn):
    assert smoke.widths_of(cgnn["s_init"][0]) == list(INIT)
    assert len(cgnn["iterations"]) == 2
    for it in cgnn["iterations"]:
        assert smoke.widths_of(it["update"]) == list(UPDATE)
        assert smoke.mlp_dims(it["agg"]) == (D_S, AGG_HID, D_S)
    assert smoke.mlp_dims(cgnn["readout_llrs"][0]) == LLR
    assert smoke.mlp_dims(cgnn["readout_chest"]) == CHEST
    assert UPDATE[0] == 2 * D_S + D_PE


def test_iteration_flops_at_batch_16(smoke, cgnn):
    _, flops = smoke.iteration_work(cgnn["iterations"][0], 16, D_PE, 2)
    assert flops == 709_632 * 97_940 == positions(16) * ITERATION


@pytest.mark.parametrize("batch", [1, 16])
def test_whole_cgnn_flops(smoke, cgnn, batch):
    _, flops = smoke.full_work(cgnn, batch, D_PE, 2)
    assert flops == positions(batch) * WHOLE


def test_iteration_bytes_at_batch_16(smoke, cgnn):
    # state read and written, pe read once, weights once, bf16; f32 flags
    n_w = (D_S * AGG_HID + AGG_HID + AGG_HID * D_S + D_S) + sum(
        9 * ci + ci * co + co for ci, co in zip(UPDATE[:-1], UPDATE[1:]))
    expect = (positions(16) * 2 * D_S + N_TX * N_SYM * N_SC * D_PE
              + n_w) * 2 + 16 * N_TX * 4
    nbytes, _ = smoke.iteration_work(cgnn["iterations"][0], 16, D_PE, 2)
    assert nbytes == expect


@pytest.mark.parametrize("batch", [1, 16])
def test_whole_cgnn_bytes(smoke, cgnn, batch):
    # z0 read, llr and h_hat written, pe read once, every weight once
    def stack_w(widths):
        return sum(9 * ci + ci * co + co
                   for ci, co in zip(widths[:-1], widths[1:]))

    def mlp_w(i, h, o):
        return i * h + h + h * o + o
    n_w = stack_w(INIT) + 2 * (mlp_w(D_S, AGG_HID, D_S) + stack_w(UPDATE)) \
        + mlp_w(*LLR) + mlp_w(*CHEST)
    expect = (positions(batch) * (INIT[0] + LLR[2] + CHEST[2])
              + N_TX * N_SYM * N_SC * D_PE + n_w) * 2 + batch * N_TX * 4
    nbytes, _ = smoke.full_work(cgnn, batch, D_PE, 2)
    assert nbytes == expect


def test_bf16_ulps_count_steps_across_zero(smoke):
    tiny = 2.0 ** -133  # the smallest positive bfloat16
    ref = torch.tensor([1.0, -1.0, 0.0, tiny, 3.0], dtype=torch.bfloat16)
    got = torch.tensor([1.0078125, -1.0078125, -0.0, -tiny, 3.0],
                       dtype=torch.bfloat16)
    steps = (smoke.bf16_line(got) - smoke.bf16_line(ref)).abs().tolist()
    # one ulp either side of 1, -0 equals +0, +tiny to -tiny is two steps
    assert steps == [1, 1, 0, 2, 0]
    share, ulps = smoke.differences((got,), (ref,))
    assert (share, ulps) == (3 / 5, 2)


def test_differences_without_ulps_outside_bf16(smoke):
    ref = torch.zeros(4)
    got = torch.tensor([0.0, 1e-7, 0.0, 0.0])
    assert smoke.differences((got, ref), (ref, ref)) == (1 / 8, None)


def test_rates_of_a_timing_record(smoke):
    rec = smoke.rates({"flops": 2e12, "kernel_ms": 4.0, "bound_ms": 1.0})
    assert rec["tflops"] == pytest.approx(500.0)
    assert rec["pct_of_bound"] == pytest.approx(25.0)
