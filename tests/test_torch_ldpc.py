"""The layered min-sum LDPC decoder (K5) of the PyTorch port vs the JAX
package.

The port's plain version (`layered_decode_reference`, float32 torch, the
CUDA kernel's oracle and CPU path) is held to the JAX package's NumPy
oracle `reference_layered_decode` (float64) at the sizes, seeds and
iteration counts of `tests/test_ldpc_pallas.py`, to the Pallas kernel in
interpret mode at one of those sizes, and to the oracle at nrx_rt's eval
code (BG1, Z = 384, 20 iterations) on decodable LLRs, where `tb_decode_fast`
is also held to JAX `tb_decode` with the oracle as its decoder (Pallas
interpret mode at Z = 384 x 20 iterations is too slow for this suite).
Hard bits must be equal: no tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.kernels import ldpc_pallas as jax_k5
from neural_rx_tpu.phy.constellation import qam_points
from neural_rx_tpu.phy.mapping import demap_maxlog, map_bits
from neural_rx_tpu.phy.misc import binary_source, complex_awgn
from neural_rx_tpu.phy.nr import ldpc as jax_ldpc
from neural_rx_tpu.phy.nr import tb as jax_tb
from neural_rx_tpu.phy.nr.rate_match import rate_recover
from neural_rx_tpu_torch.kernels import ldpc as k5
from neural_rx_tpu_torch.phy.nr import ldpc, tb

# MCS14 @ 4 PRB: TBS 1256 -> BG2, Z = 128 (tests/test_ldpc_pallas.py:CFG)
CFG_ARGS = (1256, 2304, 4, 553 / 1024)
CFG = jax_tb.TBConfig(*CFG_ARGS)
# nrx_rt at 132 PRB: TBS 40976 -> BG1, Z = 384, 5 code blocks
CFG132_ARGS = (40976, 76032, 4, 553 / 1024)


def _port_bits(bg, z, llr, num_iter):
    return k5.layered_decode_reference(ldpc.get_code(bg, z),
                                       torch.as_tensor(np.array(llr)),
                                       num_iter).numpy()


def _oracle(bg, z, llr, num_iter):
    code = jax_ldpc.get_code(bg, z)
    return np.stack([jax_k5.reference_layered_decode(code, row, num_iter)
                     for row in llr])


def _noisy_llr(cfg, key_i, ebno_db, batch):
    """tests/test_ldpc_pallas.py:noisy_llr: TB-level maxlog LLRs of 16-QAM
    over AWGN, from the same PRNG keys."""
    pts = jnp.asarray(qam_points(4))
    kb = jax.random.fold_in(jax.random.PRNGKey(3), key_i)
    kn = jax.random.fold_in(jax.random.PRNGKey(4), key_i)
    b = binary_source(kb, (batch, cfg.tb_size))
    x = map_bits(jax.jit(functools.partial(jax_tb.tb_encode, cfg))(b), pts)
    no = 1.0 / (10 ** (ebno_db / 10) * 4 * (cfg.tb_size
                                            / cfg.num_coded_bits))
    y = x + complex_awgn(kn, x.shape, no)
    return b, demap_maxlog(y, pts, jnp.asarray(no)).reshape(batch, -1)


def _to_internal(cfg, llr_tb, block=0):
    """TB-level llr -> one rate-recovered code block's internal LLRs."""
    scr = jnp.asarray(cfg.scramb_seq)
    llr_int = jnp.clip(-llr_tb * (1.0 - 2.0 * scr), -20, 20)
    off = sum(cfg.cb_es[:block])
    return np.asarray(rate_recover(
        cfg.code, llr_int[..., off:off + cfg.cb_es[block]], cfg.k_prime,
        cfg.qm))


def test_bit_exact_2iter():
    """test_ldpc_pallas.py TestKernelVsOracle.test_bit_exact_2iter."""
    _, llr = _noisy_llr(CFG, 0, 3.0, 1)
    full = _to_internal(CFG, llr)
    np.testing.assert_array_equal(_port_bits(2, 128, full, 2),
                                  _oracle(2, 128, full, 2))


def test_noiseless_exact():
    """The codeword (encoded by the port, which test_torch_tb_chain.py
    holds to the JAX encoder) at +-8 with the punctured 2Z at 0."""
    info = binary_source(jax.random.PRNGKey(0), (1, CFG.code.k))
    cw = ldpc.encode(ldpc.get_code(2, 128),
                     torch.as_tensor(np.array(info))).numpy()
    llr = (1.0 - 2.0 * cw) * 8.0
    llr[..., :2 * CFG.code.z] = 0.0
    np.testing.assert_array_equal(_port_bits(2, 128, llr, 1), cw)


@pytest.mark.parametrize("bg,z,seed,n,num_iter", [
    (2, 52, 7, 3, 3), (2, 208, 7, 3, 3),   # TestNonLaneMultipleZ
    (1, 352, 11, 1, 1),                    # test_bit_exact_z352_bg1
    (2, 128, 21, 5, 4)])                   # TestTiledBatch
def test_random_llr_matches_oracle(bg, z, seed, n, num_iter):
    code = ldpc.get_code(bg, z)
    llr = np.random.default_rng(seed).normal(
        size=(n, code.n_full)).astype(np.float32) * 2
    np.testing.assert_array_equal(_port_bits(bg, z, llr, num_iter),
                                  _oracle(bg, z, llr, num_iter))


def test_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode) at Z = 52, where Z is no
    multiple of the TPU's 128 lanes nor of a warp."""
    code = ldpc.get_code(2, 52)
    llr = np.random.default_rng(7).normal(
        size=(3, code.n_full)).astype(np.float32) * 2
    dec = jax_k5.make_decoder(jax_ldpc.get_code(2, 52), num_iter=3,
                              interpret=True)
    np.testing.assert_array_equal(_port_bits(2, 52, llr, 3),
                                  np.asarray(dec(jnp.asarray(llr))))


@pytest.fixture(scope="module")
def llr_132prb():
    """One slot's TB-level LLRs of nrx_rt's 132-PRB transport block at
    5 dB (decodable; 5 code blocks of BG1/Z = 384 each)."""
    cfg = jax_tb.TBConfig(*CFG132_ARGS)
    bits, llr = _noisy_llr(cfg, 1, 5.0, 1)
    return cfg, np.array(bits), np.array(llr)


def test_bg1_z384_20iter_matches_oracle(llr_132prb):
    """nrx_rt's eval code at the default 20 iterations on decodable LLRs:
    the port's decoder on all 5 code blocks in one call against the oracle
    block by block (every hard bit), then `tb_decode_fast` against JAX
    `tb_decode` with the oracle as its decoder (b_hat, crc), and every TB
    decodes to the bits sent."""
    cfg, bits, llr = llr_132prb
    code = cfg.code
    oracle_bits = []

    def oracle_decoder(full):
        full = np.asarray(full)
        out = np.stack([jax_k5.reference_layered_decode(code, row, 20)
                        for row in full.reshape(-1, code.n_full)])
        oracle_bits.append(out)
        return jnp.asarray(out.reshape(full.shape))

    want_b, want_ok = jax_tb.tb_decode(cfg, jnp.asarray(llr),
                                       decoder=oracle_decoder)
    port_cfg = tb.TBConfig(*CFG132_ARGS)
    full = tb.codeword_llrs(port_cfg, torch.as_tensor(llr))
    assert full.shape == (1, 5, 68 * 384)
    got = k5.make_decoder(port_cfg.code)(full).reshape(5, -1).numpy()
    np.testing.assert_array_equal(got, np.concatenate(oracle_bits))
    before = k5.launches
    got_b, got_ok = k5.tb_decode_fast(port_cfg, torch.as_tensor(llr))
    assert k5.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_b.numpy(), bits)
    assert bool(got_ok.all())


def test_tb_decode_fast_odd_lifting():
    """test_ldpc_pallas.py test_tb_decode_fast_odd_lifting: noiseless QPSK
    TB with a lifting size that is no multiple of 128."""
    cfg = tb.TBConfig(352, 960, 2, 0.37)
    assert cfg.z % 128 != 0
    info = np.array(binary_source(jax.random.PRNGKey(5), (2, 352)))
    c = tb.tb_encode(cfg, torch.as_tensor(info))
    b_hat, ok = k5.tb_decode_fast(cfg, (2.0 * c - 1.0) * 8.0)
    assert b_hat.shape == (2, 352)
    np.testing.assert_array_equal(b_hat.numpy(), info)
    assert bool(ok.all())


def test_make_decoder_keeps_leading_shape():
    """make_decoder decodes every leading index as one codeword, as the
    JAX decoder does; tb_decode hands it [..., C, n_full]."""
    code = ldpc.get_code(2, 52)
    llr = torch.as_tensor(np.random.default_rng(3).normal(
        size=(2, 3, code.n_full)).astype(np.float32))
    got = k5.make_decoder(code, num_iter=2)(llr)
    assert got.shape == llr.shape
    want = k5.layered_decode_reference(code, llr.reshape(6, -1), 2)
    assert torch.equal(got.reshape(6, -1), want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    code = ldpc.get_code(2, 52)
    llr = torch.zeros((2, code.n_full), dtype=torch.float64)
    with pytest.raises(TypeError):
        k5._launch(code, llr, 20)
    with pytest.raises(ValueError):
        k5._launch(code, torch.zeros((2, code.n_full + 1)), 20)
    with pytest.raises(ValueError):
        k5.layered_decode(code, torch.zeros((2, code.n_full),
                                            device="meta"))
    plan = k5._plan_tensors(code, torch.device("cpu"))
    assert plan["row_ptr"].dtype == torch.int32
    assert int(plan["row_ptr"][-1]) == code.num_edges == len(plan["edges"])
    assert code.max_row_deg <= k5.MAX_ROW_DEG
    assert ldpc.get_code(1, 384).max_row_deg == k5.MAX_ROW_DEG


def test_jax_kernel_rounds_the_update_once(monkeypatch):
    """Why the port rounds the app update t + alpha*sign*sgn*min once: XLA
    on the CPU (which runs the Pallas kernel in interpret mode) contracts
    the multiply and the add, and the float64 oracle rounds neither. With
    the product rounded first, the port's plain version loses a hard bit
    against the oracle at test_ldpc_pallas.py's TestTiledBatch seed."""
    rng = np.random.default_rng(0)
    t = rng.normal(size=4096).astype(np.float32)
    o = np.abs(rng.normal(size=4096)).astype(np.float32)
    xla = np.asarray(jax.jit(lambda t, o: t + 0.8125 * o)(t, o))
    once = (t.astype(np.float64) + 0.8125 * o.astype(np.float64)).astype(
        np.float32)
    twice = t + np.float32(0.8125) * o
    np.testing.assert_array_equal(xla, once)
    assert (xla != twice).any()
    got = k5.fused_multiply_add(torch.full((4096,), 0.8125),
                                torch.as_tensor(o), torch.as_tensor(t))
    np.testing.assert_array_equal(got.numpy(), once)

    code = ldpc.get_code(2, 128)
    llr = np.random.default_rng(21).normal(
        size=(5, code.n_full)).astype(np.float32) * 2
    monkeypatch.setattr(k5, "fused_multiply_add", lambda a, b, c: a * b + c)
    assert (_port_bits(2, 128, llr, 4) != _oracle(2, 128, llr, 4)).any()
