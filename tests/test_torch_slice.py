"""The PyTorch port's serving slice vs the JAX package, end to end.

nrx_rt on its 4-PRB training grid, committed EMA weights: the planar input
goes through `NeuralPUSCHReceiver.serve` of the port (dense LS estimate,
CGNN through the kernel wrappers, which take their plain versions on CPU
tensors) and through the JAX receiver's `_prepare_inputs` + `cgnn_apply`
with the same fused routes (Pallas interpret mode): at batch 2 the stack
kernel alone (`fused_convs=True`); at batch 5 the JAX entry's batch > 4
route (`fused_iteration=True`: the iteration kernel) and its mega route
(`fused_full=True`: the whole-CGNN kernel). The same bars hold at the
132-PRB width `entry()` serves, at batch 1 (stack route; JAX's float32 side
there is its XLA path).

Tolerances (relative to max |JAX|):
- float32: 1e-4; measured ~2e-6 (pointwise sums in another order).
- bfloat16: 0.1 on the largest element and 3e-3 on the mean; measured
  0.030 (llr) and 0.034 (h_hat) max, 1.4e-3 mean. Both sides round to
  bfloat16 at the same points, but their f32 sums run in other orders
  (oneDNN vs Eigen), so an occasional activation rounds to the neighbouring
  bfloat16 value; a flip in the state (|s| up to ~100, ulp 0.5) moves the
  readouts by a few percent of their range after two iterations. JAX's own
  bfloat16 result differs from its float32 result by 3.4 % (llr) and 6.2 %
  (h_hat) on the same input, and the port's bfloat16 result may not be
  further from the float32 reference than 1.5x that.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.rx.cgnn import cgnn_apply as jax_cgnn_apply
from neural_rx_tpu.rx.neural_rx import NeuralPUSCHReceiver as JaxReceiver
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu.sim.training import load_weights
from neural_rx_tpu_torch import entry as port_entry
from neural_rx_tpu_torch.kernels import cgnn_iter, sepconv

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# route -> the JAX cgnn_apply flags the JAX entry sets at batch 5
ROUTES = {"iteration": {"fused_iteration": True},
          "mega": {"fused_full": True}}


def _jax_serve(params, p, dtype, y, **flags):
    rx = JaxReceiver(
        p.transmitters, num_rx_ant=p.num_rx_antennas,
        max_num_tx=p.max_num_tx, num_it=p.num_nrx_iter, d_s=p.d_s,
        num_units_init=p.num_units_init, num_units_agg=p.num_units_agg,
        num_units_state=p.num_units_state,
        num_units_readout=p.num_units_readout,
        var_mcs_masking=p.mcs_var_mcs_masking, initial_chest="ls",
        mask_pilots=False, nrx_dtype=dtype)
    cfg = dataclasses.replace(rx.cgnn_cfg, **{
        "fused_convs": True, "fused_iteration": False, **flags})
    yj = jnp.asarray(y)
    y_in, h_in = rx._prepare_inputs(yj[..., 0] + 1j * yj[..., 1])
    b, t = y.shape[0], rx.max_num_tx
    llrs, h_hats = jax_cgnn_apply(params["cgnn"], cfg, y_in,
                                  jnp.asarray(rx.pe), h_in, jnp.ones((b, t)),
                                  jnp.ones((b, t, 1)), dtype=dtype)
    return np.asarray(llrs[-1][0]), np.asarray(h_hats[-1])


@pytest.fixture(scope="module")
def results():
    y = np.random.default_rng(1).normal(
        size=(2, 4, 14, 48, 2)).astype(np.float32)
    jp = JaxParameters("nrx_rt", system="nrx", training=True)
    jparams = load_weights("weights/nrx_rt_ema_weights.pkl")
    out = {}
    for key, (tdt, jdt) in DTYPES.items():
        out["jax", key] = _jax_serve(jparams, jp, jdt, y)
        rx = port_entry.make_receiver(training=True, nrx_dtype=tdt,
                                      device="cpu")
        params = port_entry.load_params(dtype=tdt, device="cpu")
        llr, h_hat = rx.serve(params, torch.as_tensor(y))
        out["port", key] = (llr, h_hat)
    return out


@pytest.fixture(scope="module")
def results_b5():
    """Batch 5: the port's serve takes the iteration kernel's route by
    itself; the mega route is a receiver built with fused_full."""
    y = np.random.default_rng(4).normal(
        size=(5, 4, 14, 48, 2)).astype(np.float32)
    jp = JaxParameters("nrx_rt", system="nrx", training=True)
    jparams = load_weights("weights/nrx_rt_ema_weights.pkl")
    out = {}
    for route, flags in ROUTES.items():
        for key, (tdt, jdt) in DTYPES.items():
            out["jax", route, key] = _jax_serve(jparams, jp, jdt, y, **flags)
            rx = port_entry.make_receiver(
                training=True, nrx_dtype=tdt, fused_full=route == "mega",
                device="cpu")
            params = port_entry.load_params(dtype=tdt, device="cpu")
            out["port", route, key] = rx.serve(params, torch.as_tensor(y))
    return out


@pytest.fixture(scope="module")
def results_132():
    """The width `entry()` serves: 132 PRB, batch 1 (the stack kernel's
    route), against JAX cgnn_apply: in float32 its XLA path, in bfloat16
    its fused_convs=True route (Pallas interpret), as the JAX entry
    serves."""
    y = np.random.default_rng(0).normal(
        size=(1, 4, 14, 1584, 2)).astype(np.float32)
    jp = JaxParameters("nrx_rt", system="nrx", training=False)
    jparams = load_weights("weights/nrx_rt_ema_weights.pkl")
    out = {}
    for key, (tdt, jdt) in DTYPES.items():
        out["jax", key] = _jax_serve(jparams, jp, jdt, y,
                                     fused_convs=key == "bf16")
        rx = port_entry.make_receiver(nrx_dtype=tdt, device="cpu")
        params = port_entry.load_params(dtype=tdt, device="cpu")
        out["port", key] = rx.serve(params, torch.as_tensor(y))
    return out


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_shapes_and_device(results):
    for key in DTYPES:
        llr, h_hat = results["port", key]
        assert llr.shape == (2, 2, 14, 48, 4) and h_hat.shape == (
            2, 2, 14, 48, 8)
        assert llr.dtype == h_hat.dtype == torch.float32
        assert llr.device.type == h_hat.device.type == "cpu"


@pytest.mark.parametrize("i,name", [(0, "llr"), (1, "h_hat")])
def test_f32_matches_jax(results, i, name):
    got = results["port", "f32"][i].numpy()
    want = results["jax", "f32"][i]
    assert _rel(got, want) <= 1e-4, name


@pytest.mark.parametrize("i,name", [(0, "llr"), (1, "h_hat")])
def test_bf16_matches_jax(results, i, name):
    got = results["port", "bf16"][i].numpy()
    want = results["jax", "bf16"][i]
    ref32 = results["jax", "f32"][i]
    assert _rel(got, want) <= 0.1, name
    assert np.abs(got - want).mean() / np.abs(want).max() <= 3e-3, name
    assert _rel(got, ref32) <= 1.5 * _rel(want, ref32), name


@pytest.mark.parametrize("i,name", [(0, "llr"), (1, "h_hat")])
def test_132prb_f32_matches_jax(results_132, i, name):
    got = results_132["port", "f32"][i]
    assert got.shape[:4] == (1, 2, 14, 1584)
    assert _rel(got.numpy(), results_132["jax", "f32"][i]) <= 1e-4, name


@pytest.mark.parametrize("i,name", [(0, "llr"), (1, "h_hat")])
def test_132prb_bf16_matches_jax(results_132, i, name):
    got = results_132["port", "bf16"][i].numpy()
    want = results_132["jax", "bf16"][i]
    ref32 = results_132["jax", "f32"][i]
    assert _rel(got, want) <= 0.1, name
    assert np.abs(got - want).mean() / np.abs(want).max() <= 3e-3, name
    assert _rel(got, ref32) <= 1.5 * _rel(want, ref32), name


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("i,name", [(0, "llr"), (1, "h_hat")])
def test_batch5_routes_f32_match_jax(results_b5, route, i, name):
    got = results_b5["port", route, "f32"][i]
    assert got.shape[:2] == (5, 2) and got.dtype == torch.float32
    assert _rel(got.numpy(), results_b5["jax", route, "f32"][i]) <= 1e-4, \
        name


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("i,name", [(0, "llr"), (1, "h_hat")])
def test_batch5_routes_bf16_match_jax(results_b5, route, i, name):
    got = results_b5["port", route, "bf16"][i].numpy()
    want = results_b5["jax", route, "bf16"][i]
    ref32 = results_b5["jax", route, "f32"][i]
    assert _rel(got, want) <= 0.1, name
    assert np.abs(got - want).mean() / np.abs(want).max() <= 3e-3, name
    assert _rel(got, ref32) <= 1.5 * _rel(want, ref32), name


@pytest.mark.parametrize("batch,mega,calls", [
    (4, False, {"stack": 3, "iteration": 0, "full": 0}),
    (5, False, {"stack": 1, "iteration": 2, "full": 0}),
    (5, True, {"stack": 0, "iteration": 0, "full": 1}),
    (1, True, {"stack": 0, "iteration": 0, "full": 1})])
def test_serve_route_by_batch(monkeypatch, batch, mega, calls):
    """The JAX entry's batch-adaptive route: the stack kernel alone at
    batch <= 4, the init stack plus one iteration kernel call per iteration
    at batch > 4, one whole-CGNN call on the mega route."""
    seen = dict.fromkeys(calls, 0)

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    from neural_rx_tpu_torch.rx import cgnn as port_cgnn
    monkeypatch.setattr(port_cgnn, "fused_conv_stack",
                        spy("stack", port_cgnn.fused_conv_stack))
    monkeypatch.setattr(cgnn_iter, "fused_iteration",
                        spy("iteration", cgnn_iter.fused_iteration))
    monkeypatch.setattr(cgnn_iter, "fused_cgnn_full",
                        spy("full", cgnn_iter.fused_cgnn_full))
    rx = port_entry.make_receiver(training=True, fused_full=mega,
                                  device="cpu")
    params = port_entry.load_params(device="cpu")
    y = torch.as_tensor(np.random.default_rng(5).normal(
        size=(batch, 4, 14, 48, 2)), dtype=torch.float32)
    llr, h_hat = rx.serve(params, y)
    assert seen == calls
    assert llr.shape == (batch, 2, 14, 48, 4) and bool(
        torch.isfinite(llr).all() and torch.isfinite(h_hat).all())


def test_serve_on_cpu_launches_no_kernel():
    rx = port_entry.make_receiver(training=True, device="cpu")
    params = port_entry.load_params(device="cpu")
    y = torch.as_tensor(np.random.default_rng(2).normal(
        size=(1, 4, 14, 48, 2)), dtype=torch.float32)
    before = (sepconv.launches, cgnn_iter.iter_launches,
              cgnn_iter.full_launches)
    llr, _ = rx.serve(params, y)
    rx_mega = port_entry.make_receiver(training=True, fused_full=True,
                                       device="cpu")
    rx_mega.serve(params, torch.cat([y] * 5))
    rx.serve(params, torch.cat([y] * 5))
    assert (sepconv.launches, cgnn_iter.iter_launches,
            cgnn_iter.full_launches) == before
    assert llr.device.type == "cpu" and bool(torch.isfinite(llr).all())
    assert rx.cgnn_cfg.fused_convs


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.make_receiver(training=True)


def test_sc_valid_matches_jax():
    """Pad-to-bucket semantics: with sc_valid the power norm averages over
    the valid subcarriers and every conv layer re-zeros the padding, as in
    JAX (float32, 1e-4 of max |ref|). The JAX side runs its XLA path, which
    its own tests hold to the fused kernels."""
    from neural_rx_tpu_torch.rx.cgnn import cgnn_apply
    from neural_rx_tpu_torch.weights import from_jax_numpy
    rng = np.random.default_rng(3)
    b, t, n_sc, sc_valid = 2, 2, 48, 40
    y = rng.normal(size=(b, 14, n_sc, 8)).astype(np.float32)
    pe = rng.normal(size=(t, 14, n_sc, 2)).astype(np.float32)
    h = rng.normal(size=(b, t, 14, n_sc, 8)).astype(np.float32)
    jparams = load_weights("weights/nrx_rt_ema_weights.pkl")["cgnn"]
    rx = port_entry.make_receiver(training=True, nrx_dtype=torch.float32,
                                  device="cpu")
    jp = JaxParameters("nrx_rt", system="nrx", training=True)
    jrx = JaxReceiver(
        jp.transmitters, num_rx_ant=jp.num_rx_antennas,
        max_num_tx=jp.max_num_tx, num_it=jp.num_nrx_iter, d_s=jp.d_s,
        num_units_init=jp.num_units_init, num_units_agg=jp.num_units_agg,
        num_units_state=jp.num_units_state,
        num_units_readout=jp.num_units_readout)
    want_l, want_h = jax_cgnn_apply(
        jparams, jrx.cgnn_cfg, jnp.asarray(y), jnp.asarray(pe),
        jnp.asarray(h), jnp.ones((b, t)), jnp.ones((b, t, 1)),
        sc_valid=jnp.int32(sc_valid))
    got_l, got_h = cgnn_apply(
        from_jax_numpy(jparams), rx.cgnn_cfg, torch.as_tensor(y),
        torch.as_tensor(pe), torch.as_tensor(h), torch.ones(b, t),
        torch.ones(b, t, 1), sc_valid=sc_valid)
    for got, want in ((got_l[-1][0], want_l[-1][0]), (got_h[-1], want_h[-1])):
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-4
