"""The evaluate CLI's --untrained and --weights-dir (the JAX package's
`cli/evaluate.py` flags), with `sim_ber` and `save_results` replaced by
stubs that capture what the CLI hands them: no Monte-Carlo step runs.

- --untrained evaluates the seed-0 init, `E2EModel.init_params` from a
  generator seeded 0 on the device (the JAX package's PRNGKey(0)); it reads
  no weights file.
- --weights-dir DIR looks the committed weights up in DIR
  (`weights.committed_weights(label, DIR)`).
- Without --untrained a missing weights file stays an error (the JAX CLI
  falls back to the init with a warning; the port does not).
"""

import pytest
import torch

from neural_rx_tpu_torch import weights
from neural_rx_tpu_torch.cli import evaluate
from neural_rx_tpu_torch.sim import simber
from neural_rx_tpu_torch.sim.config import Parameters
from neural_rx_tpu_torch.sim.e2e import E2EModel

ARGS = ["--config", "nrx_rt", "--snr", "4", "--max-iter", "1",
        "--batch-size", "1", "--device", "cpu"]


@pytest.fixture()
def captured(monkeypatch, tmp_path):
    seen = {}

    def fake_sim_ber(model, params, ebno_dbs, **kwargs):
        seen["params"], seen["num_it"] = params, kwargs["num_it"]
        return [0.0] * len(ebno_dbs), [0.0] * len(ebno_dbs)

    def fake_save(path, *args):
        seen["path"] = path
    monkeypatch.setattr(simber, "sim_ber", fake_sim_ber)
    monkeypatch.setattr(simber, "save_results", fake_save)
    seen["results"] = str(tmp_path / "results")
    return seen


def _leaves(params):
    return weights.flatten(params["cgnn"])


def test_untrained_evaluates_the_seed_0_init(captured):
    evaluate.main(ARGS + ["--untrained", "--weights-dir", "/nonexistent",
                          "--results-dir", captured["results"]])
    model = E2EModel(Parameters("nrx_rt", training=False), device="cpu")
    want = _leaves(model.init_params(torch.Generator().manual_seed(0)))
    got = _leaves(captured["params"])
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert "packed" in captured["params"]["cgnn"]["iterations"][0]["agg"]
    assert captured["num_it"] == 2
    assert captured["path"].endswith("nrx_rt_results.pkl")


def test_weights_dir_is_where_the_weights_are_looked_up(captured, tmp_path):
    model = E2EModel(Parameters("nrx_rt", training=False), device="cpu")
    mine = model.init_params(torch.Generator().manual_seed(7))
    wdir = tmp_path / "w"
    weights.save(weights.committed_weights("nrx_rt", str(wdir)), mine)
    evaluate.main(ARGS + ["--weights-dir", str(wdir),
                          "--results-dir", captured["results"]])
    got = _leaves(captured["params"])
    for k, v in _leaves(mine).items():
        assert torch.equal(got[k], v), k
    committed = _leaves(weights.load_tree(weights.NRX_RT_EMA, device="cpu"))
    assert not torch.equal(got["s_init.0.out.pw"],
                           committed["s_init.0.out.pw"])


def test_missing_weights_without_untrained_is_an_error(captured, tmp_path):
    with pytest.raises(FileNotFoundError, match="--untrained"):
        evaluate.main(ARGS + ["--weights-dir", str(tmp_path),
                              "--results-dir", captured["results"]])
    assert "params" not in captured
