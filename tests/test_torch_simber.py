"""The PyTorch port's Monte-Carlo loop (`sim_ber`) against the JAX package.

- `sim_ber` semantics on a stub model with scripted errors: early stop at
  the target block errors, the sweep's stop below `target_bler`,
  `return_counts` and `point_callback`; Wilson intervals equal JAX's;
  results pickles written by either package are read and merged by the
  other, on different SNR grids.
- Statistical agreement: the port's and JAX's `sim_ber`, each on its own
  random numbers, nrx_rt on DoubleTDLlow with its eval grid cut to 4 PRB
  (`n_size_bwp_eval = 4`), the committed EMA weights, the flooding
  decoder, 300 blocks a side at a waterfall point: the two-proportion z
  statistic within +-3.
- The evaluate CLI runs on the CPU at 132 PRB and writes a pickle JAX
  reads; without a GPU, with an unknown system, with another MCS than the
  first or without weights it raises.
"""

import os

import numpy as np
import pytest
import torch

from neural_rx_tpu.sim import metrics as jax_metrics
from neural_rx_tpu.sim import simber as jax_simber
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu.sim.e2e import E2EModel as JaxE2EModel
from neural_rx_tpu.sim.training import load_weights
from neural_rx_tpu_torch import entry as port_entry
from neural_rx_tpu_torch.cli import evaluate as port_cli
from neural_rx_tpu_torch.sim import metrics, simber
from neural_rx_tpu_torch.sim.config import CONFIG_DIR, Parameters
from neural_rx_tpu_torch.sim.e2e import E2EModel

WATERFALL_DB = 2.0
# seed of both sweeps, fixed before the first run
SIM_SEED = 17


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch in one thread for this module: the suite runs one worker per
    core or so, and threads that outnumber the cores slow the decoders'
    many small ops by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cfg_dir(tmp_path_factory):
    """A directory holding nrx_rt.cfg with its eval grid cut to 4 PRB."""
    d = tmp_path_factory.mktemp("cfg4")
    with open(os.path.join(CONFIG_DIR, "nrx_rt.cfg")) as f:
        text = f.read()
    assert "n_size_bwp_eval = 132\n" in text
    with open(d / "nrx_rt.cfg", "w") as f:
        f.write(text.replace("n_size_bwp_eval = 132\n",
                             "n_size_bwp_eval = 4\n"))
    return str(d)


@pytest.fixture(scope="module")
def jax_side(cfg_dir):
    jp = JaxParameters("nrx_rt", system="nrx", training=False,
                       config_dir=cfg_dir)
    return JaxE2EModel(jp, training=False), load_weights(
        "weights/nrx_rt_ema_weights.pkl")


@pytest.fixture(scope="module")
def port_side(cfg_dir):
    p = Parameters("nrx_rt", training=False, config_dir=cfg_dir)
    assert p.resource_grid.num_subcarriers == 48
    return E2EModel(p, device="cpu"), port_entry.load_params(
        dtype=p.nrx_dtype, device="cpu")


class _ScriptedModel:
    """A model whose step `i` at Eb/N0 e has `script[e][i]` block errors of
    `blocks` single-bit transport blocks (one error bit each)."""
    device = torch.device("cpu")

    def __init__(self, script, blocks=10):
        self.script, self.blocks, self.calls = script, blocks, {}

    def __call__(self, params, generator, batch_size, ebno_db, **kwargs):
        i = self.calls.get(ebno_db, 0)
        self.calls[ebno_db] = i + 1
        b = torch.zeros((self.blocks, 1, 4))
        b_hat = b.clone()
        b_hat[:self.script[ebno_db][i], 0, 0] = 1.0
        return b, b_hat, torch.ones((self.blocks, 1), dtype=torch.bool)


def test_sim_ber_stops_and_reports_as_jax_does():
    script = {0.0: [6, 5, 4, 3], 1.0: [2, 2, 2, 2], 2.0: [0, 0, 0, 0],
              3.0: [9, 9, 9, 9]}
    model = _ScriptedModel(script)
    points = []
    ber, bler, errs, blocks = simber.sim_ber(
        model, {}, [0.0, 1.0, 2.0, 3.0], batch_size=10, max_mc_iter=4,
        num_target_block_errors=10, target_bler=0.1, verbose=False,
        return_counts=True, point_callback=lambda *a: points.append(a))
    # 0 dB: 6 + 5 >= 10 after two steps; 1 dB: all four steps; 2 dB: BLER 0
    # is below target_bler, so 3 dB is never run
    assert model.calls == {0.0: 2, 1.0: 4, 2.0: 4}
    np.testing.assert_array_equal(errs, [11, 8, 0, 0])
    np.testing.assert_array_equal(blocks, [20, 40, 40, 0])
    np.testing.assert_allclose(bler[:3], [11 / 20, 8 / 40, 0.0])
    np.testing.assert_allclose(ber[:3], [11 / 80, 8 / 160, 0.0])
    assert np.isnan(ber[3]) and np.isnan(bler[3])
    assert points == [(0.0, ber[0], bler[0]), (1.0, ber[1], bler[1]),
                      (2.0, ber[2], bler[2])]
    assert len(simber.sim_ber(_ScriptedModel(script), {}, [0.0], 10,
                              max_mc_iter=1, verbose=False)) == 2
    with pytest.raises(NotImplementedError):
        simber.sim_ber(model, {}, [0.0], 10, mesh=object())


@pytest.mark.parametrize("n", [1, 7, 60, 1000])
def test_bler_confidence_interval_equals_jax(n):
    for k in sorted({0, 1, n // 3, n // 2, n - 1, n}):
        lo, hi = simber.bler_confidence_interval(k, n)
        assert (lo, hi) == jax_simber.bler_confidence_interval(k, n)
        assert lo <= k / n <= hi + 1e-12
    assert all(np.isnan(simber.bler_confidence_interval(0, 0)))


@pytest.mark.parametrize("first", ["port", "jax"])
def test_results_pickles_read_and_merge_both_ways(tmp_path, first):
    save = {"port": simber.save_results, "jax": jax_simber.save_results}
    load = {"port": metrics.load_results, "jax": jax_metrics.load_results}
    second = "jax" if first == "port" else "port"
    path = str(tmp_path / "nrx_rt_results.pkl")
    key_a, key_b = ("Neural Receiver", 2, 0), ("other", 2, 0)
    save[first](path, "nrx_rt", *key_a, np.float32([1.0, 2.0, 3.0]),
                [0.1, 0.05, 0.01], [0.6, 0.3, 0.1])
    save[second](path, "nrx_rt", *key_b, [2.5, 3.0], [0.2, 0.1],
                 [0.9, 0.8])
    save[second](path, "nrx_rt", *key_a, [4.0], [0.001], [0.01])
    for reader in ("port", "jax"):
        ebno, ber, bler = load[reader](path)
        np.testing.assert_array_equal(ebno, [1.0, 2.0, 2.5, 3.0, 4.0])
        np.testing.assert_array_equal(bler[key_a],
                                      [0.6, 0.3, np.nan, 0.1, 0.01])
        np.testing.assert_array_equal(ber[key_b],
                                      [np.nan, np.nan, 0.2, 0.1, np.nan])
    csv_path = str(tmp_path / "out.csv")
    metrics.export_csv(path, csv_path)
    with open(csv_path) as f:
        assert len(f.read().splitlines()) == 1 + 2 * 5


def test_sim_ber_agrees_with_jax_statistically(jax_side, port_side):
    """Each side on its own random numbers, flooding decoder, 300 blocks."""
    jm, jparams = jax_side
    model, params = port_side
    kw = dict(batch_size=50, max_mc_iter=3, num_target_block_errors=10**6,
              seed=SIM_SEED, verbose=False, return_counts=True)
    *_, j_err, j_n = jax_simber.sim_ber(jm, jparams, [WATERFALL_DB],
                                        num_it=2, **kw)
    *_, p_err, p_n = simber.sim_ber(model, params, [WATERFALL_DB], **kw)
    assert j_n[0] == p_n[0] == 300
    p1, p2 = j_err[0] / j_n[0], p_err[0] / p_n[0]
    pool = (j_err[0] + p_err[0]) / (j_n[0] + p_n[0])
    z = (p1 - p2) / np.sqrt(pool * (1 - pool) * (1 / j_n[0] + 1 / p_n[0]))
    assert 0.05 < pool < 0.95 and abs(z) <= 3.0, (p1, p2, z)


def test_evaluate_cli_on_cpu_writes_a_pickle_jax_reads(tmp_path):
    port_cli.main(["--config", "nrx_rt", "--snr", "6", "--max-iter", "1",
                   "--batch-size", "2", "--device", "cpu", "--results-dir",
                   str(tmp_path)])
    ebno, ber, bler = jax_metrics.load_results(
        str(tmp_path / "nrx_rt_results.pkl"))
    np.testing.assert_array_equal(ebno, [6.0])
    key = ("Neural Receiver", 2, 0)
    assert 0.0 <= bler[key][0] <= 1.0 and 0.0 <= ber[key][0] <= 1.0


def test_evaluate_cli_refuses(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--config", "nrx_rt", "--results-dir",
                       str(tmp_path)])
    with pytest.raises(ValueError, match="unknown system"):
        port_cli.main(["--config", "nrx_rt", "--system",
                       "baseline_lmmse_qr", "--device", "cpu"])
    with pytest.raises(ValueError, match="out of range"):
        port_cli.main(["--config", "nrx_rt", "--mcs-idx", "1", "--device",
                       "cpu"])
    with pytest.raises(FileNotFoundError):
        port_cli.main(["--config", "nrx_rt", "--device", "cpu", "--weights",
                       str(tmp_path / "missing.npz")])
