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
    assert int(plan["row_ptr"][-1]) == code.num_edges == len(plan["cols"]) \
        == len(plan["shifts"])
    # the kernel packs column * Z and the shift into one word: shifts mod Z
    assert 0 <= int(plan["shifts"].min()) and int(plan["shifts"].max()) < 52
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


ALPHA32 = np.float32(k5.ALPHA)


def _rows(code):
    """Per row: (cols [deg], lanes (j + s) mod Z [deg, Z])."""
    lanes = np.arange(code.z)
    out = []
    for r, cols in enumerate(code.rows):
        shifts = [int(code.shifts[(r, c)]) for c in cols]
        out.append((np.array(cols), (lanes[None] + np.array(shifts)[:, None])
                    % code.z))
    return out


def _decode_full(code, llr, num_iter):
    """Layered min-sum with one stored message per edge and lane (the
    first kernel's form): app [N, n_cols, Z] float32 after each
    iteration."""
    n = llr.shape[0]
    app = llr.reshape(n, code.num_cols, code.z).clone()
    msgs = [torch.zeros((n, len(cols), code.z)) for cols, _ in _rows(code)]
    apps = []
    for _ in range(num_iter):
        for (cols, lanes), msg in zip(_rows(code), msgs):
            t = app[:, cols[:, None], lanes] - msg
            sgn = torch.where(t < 0, -1.0, 1.0)
            mag = t.abs()
            min1 = mag.amin(dim=1, keepdim=True)
            is_min = mag <= min1
            first = is_min & (is_min.cumsum(dim=1) == 1)
            min2 = torch.where(first, 1e30, mag).amin(dim=1, keepdim=True)
            coef = ALPHA32 * sgn.prod(dim=1, keepdim=True) * sgn
            other = torch.where(first, min2, min1)
            msg.copy_(coef * other)
            app[:, cols[:, None], lanes] = k5.fused_multiply_add(coef, other,
                                                                  t)
        apps.append(app.clone())
    return apps


def _decode_compressed(code, llr, num_iter):
    """The redesigned kernel's form: per row and lane only min1, min2 and a
    word of edge signs (bits 0..18), the first-minimum edge (bits 19..23)
    and the sign parity (bit 24); the running minimum over a row's edges in
    order starts at the first edge and takes a later one only if it is
    strictly smaller; each message is rebuilt as one rounded product
    +-alpha * (first ? min2 : min1), the app as one fused multiply-add. app
    after each iteration."""
    n = llr.shape[0]
    app = llr.reshape(n, code.num_cols, code.z).clone()
    shape = (n, code.num_rows, code.z)
    st_min1, st_min2 = torch.zeros(shape), torch.zeros(shape)
    st_word = torch.zeros(shape, dtype=torch.int64)
    apps = []
    for it in range(num_iter):
        for r, (cols, lanes) in enumerate(_rows(code)):
            m1, m2, w = st_min1[:, r], st_min2[:, r], st_word[:, r]
            first_old = (w >> 19) & 31
            parity_old = (w >> 24) & 1
            t = []
            for k in range(len(cols)):
                v = app[:, cols[k], lanes[k]]
                if it > 0:
                    flip = (parity_old ^ (w >> k)) & 1
                    coef = torch.where(flip == 1, -ALPHA32, ALPHA32)
                    v = v - coef * torch.where(first_old == k, m2, m1)
                t.append(v)
            neg = (t[0] < 0).long()
            min1, min2 = t[0].abs(), torch.full_like(m1, 1e30)
            first = torch.zeros_like(w)
            for k in range(1, len(cols)):
                neg = neg | ((t[k] < 0).long() << k)
                m = t[k].abs()
                take = m < min1
                min2 = torch.minimum(min2, torch.where(take, min1, m))
                first = torch.where(take, k, first)
                min1 = torch.where(take, m, min1)
            parity = torch.zeros_like(w)
            for k in range(len(cols)):
                parity = parity ^ ((neg >> k) & 1)
            for k in range(len(cols)):
                flip = (parity ^ (neg >> k)) & 1
                coef = torch.where(flip == 1, -ALPHA32, ALPHA32)
                other = torch.where(first == k, min2, min1)
                app[:, cols[k], lanes[k]] = k5.fused_multiply_add(coef, other,
                                                                  t[k])
            st_min1[:, r], st_min2[:, r] = min1, min2
            st_word[:, r] = neg | first << 19 | parity << 24
        apps.append(app.clone())
    return apps


def _tie_llrs(code, seed, n):
    """LLRs on a coarse grid (exact ties within rows), with -0.0 and +0.0
    among them and the punctured first 2Z at 0."""
    rng = np.random.default_rng(seed)
    llr = np.round(rng.normal(size=(n, code.n_full)) * 2.0).astype(
        np.float32) / 2
    llr[rng.random(llr.shape) < 0.05] = np.float32(-0.0)
    llr[:, :2 * code.z] = 0.0
    llr[0, 2 * code.z:3 * code.z] = np.float32(-0.0)
    return llr


@pytest.mark.parametrize("bg,z,num_iter", [(1, 384, 2), (1, 352, 3),
                                           (2, 52, 3)])
def test_compressed_state_decodes_as_full_messages(bg, z, num_iter):
    """The kernel's compressed check-node state rebuilds every message
    exactly: the app is bit for bit that of the full-message decode after
    every iteration (-0.0 apart from +0.0), and the hard bits are those of
    the port's plain version and of the JAX package's oracle."""
    code = ldpc.get_code(bg, z)
    llr_np = _tie_llrs(code, 17 + z, 2)
    assert (np.signbit(llr_np) & (llr_np == 0)).any()
    llr = torch.as_tensor(llr_np)
    full = _decode_full(code, llr, num_iter)
    comp = _decode_compressed(code, llr, num_iter)
    for a, b in zip(full, comp):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    bits = (comp[-1] < 0).float().reshape(llr.shape[0], -1)
    assert torch.equal(bits, k5.layered_decode_reference(code, llr,
                                                         num_iter))
    np.testing.assert_array_equal(bits.numpy(),
                                  _oracle(bg, z, llr_np, num_iter))
