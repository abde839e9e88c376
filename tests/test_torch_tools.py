"""The port's tooling against the JAX package's, on the CPU: profiling
(`utils/profiling.py`), NaN guards and the debug context
(`utils/debug.py`), the reference weight files
(`compat/reference_weights.py`), the symbol sources (`phy/sources.py`),
the plots and constellation CSV of `sim/metrics.py`, the native LDPC
oracle encoder (`phy/nr/ldpc_oracle.py`), and builds of the kernel
library started by several callers at once (`kernels/_build.py`)."""

import os
import pickle
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.compat import reference_weights as jax_refw
from neural_rx_tpu.phy.constellation import qam_points as jax_qam_points
from neural_rx_tpu.phy.mapping import map_bits as jax_map_bits
from neural_rx_tpu.phy.nr import ldpc as jax_ldpc
from neural_rx_tpu.phy.nr import ldpc_oracle as jax_oracle
from neural_rx_tpu.sim import metrics as jax_metrics
from neural_rx_tpu_torch import entry, weights
from neural_rx_tpu_torch.compat import reference_weights as refw
from neural_rx_tpu_torch.deploy.aot import CapturedCall
from neural_rx_tpu_torch.kernels import _build
from neural_rx_tpu_torch.phy import sources
from neural_rx_tpu_torch.phy.nr import ldpc, ldpc_oracle
from neural_rx_tpu_torch.sim import metrics
from neural_rx_tpu_torch.sim.config import Parameters
from neural_rx_tpu_torch.sim.e2e import E2EModel
from neural_rx_tpu_torch.sim.simber import save_results
from neural_rx_tpu_torch.utils import debug, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NRX_RT = os.path.join(ROOT, "weights", "reference_format",
                          "nrx_rt_weights")


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items() if k != "packed"}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return tree.detach().numpy()


def assert_trees_equal(a, b):
    fa, fb = weights.flatten(a), weights.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype == torch.float32, k
        assert torch.equal(fa[k], fb[k]), k


def test_time_fn_and_chained_time_on_cpu_tensors():
    x = torch.ones((64, 64))
    out = profiling.time_fn(lambda y: torch.tanh(y @ y.T), x, iters=5,
                            warmup=1)
    assert set(out) == {"p50_ms", "p99_ms", "mean_ms"}
    assert 0 < out["p50_ms"] <= out["p99_ms"]
    t = profiling.chained_device_time_ms(
        lambda y: (torch.tanh(y @ y.T), {"s": y.sum()}), x, length=20,
        reps=3)
    assert 0 < t < 1e3
    assert 0 < profiling.tunnel_rtt_ms(iters=5, device="cpu") < 100
    with pytest.raises(ValueError):
        profiling.chained_device_time_ms(torch.tanh, x, length=1)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_nan_guard_names_the_leaf():
    def fn(x):
        return x, {"llr": x / 0.0, "count": torch.ones(2, dtype=torch.int64)}
    guarded = debug.nan_guard(fn)
    with pytest.raises(ValueError, match=r"out\[1\]\['llr'\]"):
        guarded(torch.ones(3))
    out = debug.nan_guard(lambda x: (x, [x + 1]))(torch.ones(3))
    assert torch.equal(out[1][0], torch.full((3,), 2.0))
    with pytest.raises(ValueError, match=r"out\[0\]"):
        debug.nan_guard(lambda x: [torch.log(-x)])(torch.ones(2))


def test_debug_context_restores_and_runs_graphs_eagerly():
    before = torch.is_anomaly_enabled()
    call = CapturedCall.__new__(CapturedCall)  # no graph: a CPU stand-in
    call.fn = lambda x: 2 * x
    call.inputs = [torch.zeros(3)]
    with debug.debug_context(nans=True, eager=True):
        assert torch.is_anomaly_enabled() and debug.eager()
        assert torch.equal(call(torch.ones(3)), torch.full((3,), 2.0))
        with debug.debug_context(nans=False):
            assert not torch.is_anomaly_enabled() and debug.eager()
        assert torch.is_anomaly_enabled()
    assert torch.is_anomaly_enabled() == before and not debug.eager()
    with pytest.raises(RuntimeError):
        with debug.debug_context(eager=True):
            raise RuntimeError("inside")
    assert torch.is_anomaly_enabled() == before and not debug.eager()


@pytest.fixture(scope="module")
def nrx_rt_template():
    return entry.make_receiver(device="cpu").init_params(
        torch.Generator().manual_seed(0))


def test_reference_nrx_rt_file_as_jax_imports_it(nrx_rt_template):
    got = refw.load_reference_weights(REF_NRX_RT, nrx_rt_template)
    with open(REF_NRX_RT, "rb") as f:
        wl = pickle.load(f)
    want = jax_refw.import_reference_weights(
        numpy_tree(nrx_rt_template["cgnn"]), wl)
    assert_trees_equal(got["cgnn"], weights.from_jax_numpy(want))
    assert "constellation" not in got
    # wired into the weights loader and the entry's parameters
    loaded = weights.load_tree(REF_NRX_RT, device="cpu",
                               template=nrx_rt_template)
    assert_trees_equal(loaded["cgnn"], got["cgnn"])
    assert_trees_equal(entry.load_params(device="cpu", path=REF_NRX_RT,
                                         dtype=torch.float32)["cgnn"],
                       got["cgnn"])
    with pytest.raises(ValueError, match="template"):
        weights.load_tree(REF_NRX_RT, device="cpu")


def test_export_then_import_is_the_identity(tmp_path, nrx_rt_template):
    params = weights.load_tree(weights.NRX_RT_EMA, device="cpu")
    path = str(tmp_path / "nrx_rt_weights")
    refw.save_reference_weights(path, params)
    with open(path, "rb") as f:
        wl = pickle.load(f)
    assert len(wl) == 43 and wl[0].shape == (3, 3, 18, 1)
    np.testing.assert_array_equal(
        wl[0], np.transpose(params["cgnn"]["s_init"][0]["hidden"][0]["dw"]
                            .numpy(), (1, 0, 3, 2)))
    back = refw.load_reference_weights(path, nrx_rt_template)
    assert_trees_equal(back["cgnn"], params["cgnn"])
    with pytest.raises(ValueError, match="architecture"):
        refw.import_reference_weights(nrx_rt_template["cgnn"], wl[:-1])
    with pytest.raises(ValueError, match="shape"):
        refw.import_reference_weights(nrx_rt_template["cgnn"],
                                      [wl[1]] + wl[1:])


def test_refuses_a_file_that_is_not_arrays(tmp_path):
    path = tmp_path / "evil"
    with open(path, "wb") as f:
        pickle.dump([os.getcwd], f)
    with pytest.raises(pickle.UnpicklingError):
        refw.read_weight_list(str(path))


def test_e2e_rt_constellation_first_from_jax_export(tmp_path):
    p = Parameters("e2e_rt", training=False)
    tree = E2EModel(p, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    tree["constellation"] = [c + 0.01 * torch.arange(c.numel()).reshape(
        c.shape) for c in tree["constellation"]]
    path = str(tmp_path / "e2e_rt_weights")
    with open(path, "wb") as f:
        pickle.dump(jax_refw.export_reference_weights(numpy_tree(tree)), f)
    template = E2EModel(p, device="cpu").init_params(
        torch.Generator().manual_seed(2))
    got = refw.load_reference_weights(path, template)
    assert_trees_equal(got, tree)
    assert len(refw.export_reference_weights(tree)) == len(
        jax_refw.export_reference_weights(numpy_tree(tree)))


@pytest.mark.parametrize("m", [2, 4, 6])
def test_qam_source_with_bits_maps_as_jax(m):
    gen = torch.Generator().manual_seed(m)
    x, bits = sources.qam_source_with_bits(gen, (3, 5), m)
    assert x.shape == (3, 5) and bits.shape == (3, 5, m)
    want = jax_map_bits(jnp.asarray(bits.numpy().reshape(3, 5 * m)),
                        jnp.asarray(jax_qam_points(m)))
    np.testing.assert_array_equal(x.numpy(), np.asarray(want))
    s = sources.qam_source(gen, (1000,), m)
    assert abs(float((s.abs() ** 2).mean()) - 1.0) < 0.15
    assert set(np.unique(s.numpy())) <= set(jax_qam_points(m))


def test_constellation_csv_as_jax_and_plots(tmp_path):
    pts = np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32)
    metrics.export_constellation(torch.tensor(pts), str(tmp_path / "a.csv"))
    jax_metrics.export_constellation(pts, str(tmp_path / "b.csv"))
    assert (tmp_path / "a.csv").read_bytes() == \
        (tmp_path / "b.csv").read_bytes()
    res = str(tmp_path / "r.pkl")
    save_results(res, "x", "Neural Receiver", 2, 0, [0.0, 1.0, 2.0],
                 [0.1, 0.01, 0.0], [0.5, 0.2, 0.0])
    save_results(res, "x", "baseline_lslin_lmmse", 2, 0, [0.0, 1.0],
                 [0.2, 0.05], [0.9, 0.4])
    for name, fn in (("bler.png", lambda o: metrics.plot_results(res, o)),
                     ("ber.png", lambda o: metrics.plot_results(
                         res, o, metric="ber", title="BER")),
                     ("gp.png", lambda o: metrics.plot_goodput(
                         res, o, tb_size=1000, num_res=2000,
                         num_pilots=200,
                         pilotless_systems=("Neural Receiver",)))):
        fn(str(tmp_path / name))
        with open(tmp_path / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("bg,z", [(1, 8), (2, 16)])
def test_ldpc_oracle_encodes_as_jax(bg, z):
    code = ldpc.get_code(bg, z)
    rng = np.random.default_rng(bg * 100 + z)
    for _ in range(2):
        info = rng.integers(0, 2, code.k)
        got = ldpc_oracle.encode_oracle(code, info)
        np.testing.assert_array_equal(
            got, jax_oracle.encode_oracle(jax_ldpc.get_code(bg, z), info))
        np.testing.assert_array_equal(
            got, ldpc.encode(code, torch.tensor(info, dtype=torch.float32)
                             ).numpy().astype(np.uint8))
    assert os.path.dirname(ldpc_oracle.library_path()) == \
        os.path.join(ROOT, "neural_rx_tpu_torch", "_build")
    with pytest.raises(ValueError):
        ldpc_oracle.encode_oracle(code, np.zeros(code.k + 1))


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Two builds at once on a slow fake nvcc: one compiles (each source
    once, one link), the other waits for it and loads its library; no
    temporary file is left behind."""
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "$@" >> ' + str(log) + '\nsleep 0.3\n'
                    'while [ $# -gt 1 ]; do [ "$1" = -o ] && '
                    'echo built > "$2"; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    infos, errors = [], []

    def build():
        try:
            infos.append(_build.build())
        except Exception as e:  # reported below
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    sources = [s for s in _build._sources() if s.endswith(".cu")]
    assert len(log.read_text().splitlines()) == len(sources) + 1
    assert sorted(i.seconds > 0 for i in infos) == [False, True]
    assert {i.path for i in infos} == {_build.library_path()}
    assert open(_build.library_path()).read() == "built\n"
    left = sorted(os.listdir(tmp_path / "build"))
    assert left == sorted([os.path.basename(_build.library_path()),
                           os.path.basename(_build.library_path())
                           + ".lock"])
