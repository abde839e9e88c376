"""The PyTorch port's eval receive path vs the JAX package, end to end.

nrx_rt at its eval width (132 PRB, 2 users, 4 rx antennas, float32 as the
configuration evaluates), committed EMA weights, Eb/N0 10 dB. The input is
the slot `entry.eval_entry` gives `chip_smoke.py` on the card
(`eval_example`, batch 16, seed 0: bits and noise from a CPU generator,
the flat Rayleigh channel of `entry.flat_channel`; the port's transmitter
is held to JAX's in test_torch_tb_chain.py), cut to its items 11 and 13.
They hold the slot's only two transport blocks that do not decode:
user 0 of item 11 (the weakest channel draw, LMMSE SINR 9.3 dB) and user 1
of item 13 (a channel closely aligned with the other user's); the other
two decode. The same y goes through JAX `NeuralPUSCHReceiver.apply` and
the port's `apply`:

- flooding decoder (fast_ldpc=False) on both sides;
- the port's layered decoder (fast_ldpc=True; its plain version on the
  CPU) against JAX `tb_decode` with the float64 NumPy oracle as the
  decoder (the Pallas kernel in interpret mode is too slow at Z = 384 x 20
  iterations), on the LLRs of the same JAX `apply` call: its per-user
  `tb_decode` is wrapped to run both decoders, which saves a second JAX
  CGNN forward;
- crc equal, and equal to `EXPECTED_CRC` (the card must give the same);
  b_hat equal to JAX's and to the bits sent where the CRC passes (the
  bits of a block that fails depend on rounding in either decoder);
- h_hat within 1e-4 of max |JAX| (test_torch_slice.py's float32 bar; the
  port takes the batch <= 4 stack route, JAX its XLA path), the LS estimate
  fed to the CGNN exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.kernels import ldpc_pallas as jax_k5
from neural_rx_tpu.phy.nr.tb import tb_decode as jax_tb_decode
from neural_rx_tpu.rx import neural_rx as jax_neural_rx
from neural_rx_tpu.rx.neural_rx import NeuralPUSCHReceiver as JaxReceiver
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu.sim.training import load_weights
from neural_rx_tpu_torch import entry as port_entry
from neural_rx_tpu_torch.kernels import ldpc as k5
from neural_rx_tpu_torch.sim.config import Parameters

EBNO_DB = 10.0
ITEMS = [11, 13]
# crc [item, user] of ITEMS: the JAX package's receiver fails the same two
EXPECTED_CRC = [[False, True], [True, False]]


def _oracle_tb_decode_fast(cfg, llr, num_iter=20):
    """JAX tb_decode with the NumPy oracle of the layered kernel, called on
    each code block's codewords."""
    def decoder(full):
        full = np.asarray(full)
        flat = full.reshape(-1, cfg.code.n_full)
        return jnp.asarray(np.stack([
            jax_k5.reference_layered_decode(cfg.code, row, num_iter)
            for row in flat]).reshape(full.shape))
    return jax_tb_decode(cfg, llr, decoder=decoder)


def _jax_apply_both_decoders(jrx, jparams, y, act):
    """{fast_ldpc: (b_hat, h_hat, h_in, crc)} of one JAX `apply` call
    (fast_ldpc=False) whose per-user decode also runs the oracle decoder
    on the same LLRs."""
    fast = []

    def both(cfg, llr):
        fast.append([np.asarray(a) for a in _oracle_tb_decode_fast(cfg, llr)])
        return jax_tb_decode(cfg, llr)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_neural_rx, "tb_decode", both)
    try:
        b_hat, h_hat, h_in, crc = [np.asarray(a) for a in jrx.apply(
            jparams, jnp.asarray(y), jnp.asarray(act), fast_ldpc=False)]
    finally:
        mp.undo()
    fast_b = np.stack([b for b, _ in fast], 1)
    fast_crc = np.stack([c for _, c in fast], 1)
    return {False: (b_hat, h_hat, h_in, crc),
            True: (fast_b, h_hat, h_in, fast_crc)}


@pytest.fixture(scope="module")
def slot():
    """(bits [2, 2, A], y [2, 4, 14, 1584] complex64): items 11 and 13 of
    eval_entry's batch-16 example slot."""
    bits, y, _ = port_entry.eval_example(Parameters("nrx_rt", training=False),
                                         16, EBNO_DB, seed=0, device="cpu")
    return bits[ITEMS].numpy(), y[ITEMS].numpy()


@pytest.fixture(scope="module")
def results(slot):
    _, y = slot
    jp = JaxParameters("nrx_rt", system="nrx", training=False)
    jrx = JaxReceiver(
        jp.transmitters, num_rx_ant=jp.num_rx_antennas,
        max_num_tx=jp.max_num_tx, num_it=jp.num_nrx_iter, d_s=jp.d_s,
        num_units_init=jp.num_units_init, num_units_agg=jp.num_units_agg,
        num_units_state=jp.num_units_state,
        num_units_readout=jp.num_units_readout,
        var_mcs_masking=jp.mcs_var_mcs_masking, initial_chest="ls",
        mask_pilots=False, nrx_dtype=jp.nrx_dtype)
    jparams = load_weights("weights/nrx_rt_ema_weights.pkl")
    p = Parameters("nrx_rt", training=False)
    rx = port_entry.make_receiver(nrx_dtype=p.nrx_dtype, device="cpu")
    params = port_entry.load_params(dtype=p.nrx_dtype, device="cpu")
    act = np.ones((len(ITEMS), 2), np.float32)
    out = {("jax", fast): r for fast, r in _jax_apply_both_decoders(
        jrx, jparams, y, act).items()}
    before = k5.launches
    for fast in (False, True):
        out["port", fast] = [a.numpy() for a in rx.apply(
            params, torch.as_tensor(y), torch.as_tensor(act),
            fast_ldpc=fast)]
    out["k5_launches"] = k5.launches - before
    return out


@pytest.mark.parametrize("fast", [False, True], ids=["flooding", "layered"])
def test_decoded_bits_and_crc_equal_jax(slot, results, fast):
    bits, _ = slot
    b_hat, _, _, crc = results["port", fast]
    jb_hat, _, _, jcrc = results["jax", fast]
    assert b_hat.shape == (2, 2, 40976) and crc.dtype == bool
    np.testing.assert_array_equal(crc, jcrc)
    assert crc.tolist() == EXPECTED_CRC
    for i, u in zip(*np.nonzero(crc)):
        np.testing.assert_array_equal(b_hat[i, u], jb_hat[i, u])
        np.testing.assert_array_equal(b_hat[i, u], bits[i, u])
    for i, u in zip(*np.nonzero(~crc)):
        assert (b_hat[i, u] != bits[i, u]).any()


@pytest.mark.parametrize("fast", [False, True], ids=["flooding", "layered"])
def test_channel_estimates_match_jax(results, fast):
    _, h_hat, h_in, _ = results["port", fast]
    _, jh_hat, jh_in, _ = results["jax", fast]
    assert h_hat.shape == (2, 2, 14, 1584, 8) and h_hat.dtype == np.float32
    assert np.abs(h_hat - jh_hat).max() <= 1e-4 * np.abs(jh_hat).max()
    np.testing.assert_array_equal(h_in, jh_in)


def test_cpu_apply_launches_no_kernel(results):
    assert results["k5_launches"] == 0


def test_eval_entry_on_cpu_decodes_what_was_sent():
    """eval_entry at batch 1 on the CPU: fn decodes the transport blocks
    of eval_example's slot (same seed) with every CRC passing."""
    fn, (params, y, act) = port_entry.eval_entry(device="cpu", batch=1)
    bits, y2, _ = port_entry.eval_example(Parameters("nrx_rt", training=False),
                                          1, 10.0, device="cpu")
    assert torch.equal(y, y2) and y.dtype == torch.complex64
    assert y.shape == (1, 4, 14, 1584)
    b_hat, crc = fn(params, y, act)
    assert torch.equal(b_hat, bits) and bool(crc.all())


def test_eval_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.eval_entry()


def test_apply_refuses_unported_modes():
    rx = port_entry.make_receiver(training=True, nrx_dtype=torch.float32,
                                  device="cpu")
    y = torch.zeros((1, 4, 14, 48), dtype=torch.complex64)
    act = torch.ones((1, 2))
    params = rx.init_params(torch.Generator().manual_seed(0))
    for kwargs in ({"mcs_arr_eval": (1,)}, {"num_it": 3}, {"num_it": 0}):
        with pytest.raises(ValueError):
            rx.apply(params, y, act, **kwargs)
