"""The PyTorch port's classical-receiver building blocks against the JAX
package, on the same numpy inputs from `default_rng` (CPU, float32):

- demappers (`phy/mapping.py`): max-log and APP LLRs for QPSK, 16-QAM and
  64-QAM with a scalar and a per-element noise variance, 2e-6 of max |ref|;
- `rx/baselines.py`: `lmmse_equalize` for 1 and 2 streams (5e-6);
  `_qr_small` reconstructs and is orthonormal (1e-5), also above the
  unrolled size; `kbest_detect` with exact max-log (1 and 2 streams), the
  K-Best list at k = 64 and at the full tree (1, 2 and 3 streams), within
  1e-5 of max |ref| on noisy inputs, so that no tie of partial distances
  decides a survivor; the full tree equals the exact detector;
- `phy/chest.py`: `LSChannelEstimator.__call__` with nn, lin and
  lin_extrap (h_hat 1e-6 of max |ref|, err_var equal) and the gather
  path `_estimate_planar_gather` (equal, also to `estimate_planar`), on the
  4-PRB grid and the 132-PRB grid of nrx_rt;
- `LMMSEChannelInterpolator` from the committed nrx_rt covariances (read
  only): exact mode against JAX at no = 0.1 on the 132-PRB grid (1e-3: two
  complex64 LUs of 792 x 792 matrices differ by that much) and
  against a float64 oracle at high SNR, within 4 cond(A) 2^-24 of max
  |ref|; chunked mode's bank choice and output (1e-6);
- `sim/covariance.py`: the accumulation of JAX's own CFR draws equals JAX's
  `compute_cov_matrices` (1e-5); the port's own draws (a single-link TDL)
  give Hermitian covariances of unit mean power;
- `Parameters(system=..., overrides=...)`.
"""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_rx_tpu.phy import chest as jax_chest
from neural_rx_tpu.phy import mapping as jax_mapping
from neural_rx_tpu.phy.constellation import qam_points
from neural_rx_tpu.rx import baselines as jax_baselines
from neural_rx_tpu.sim import covariance as jax_covariance
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu_torch.phy import chest, mapping
from neural_rx_tpu_torch.rx import baselines
from neural_rx_tpu_torch.rx.neural_rx import receiver_for
from neural_rx_tpu_torch.sim import covariance
from neural_rx_tpu_torch.sim.config import Parameters

EPS32 = 2.0 ** -24


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cn(rng, shape, scale=1.0):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
            * scale / np.sqrt(2)).astype(np.complex64)


# -- demappers ----------------------------------------------------------------

@pytest.mark.parametrize("fn", ["demap_maxlog", "demap_app"])
@pytest.mark.parametrize("bits", [2, 4, 6])
@pytest.mark.parametrize("per_element", [False, True], ids=["scalar_no",
                                                            "element_no"])
def test_demappers_match_jax(fn, bits, per_element):
    rng = np.random.default_rng(bits)
    pts = qam_points(bits)
    y = _cn(rng, (5, 7))
    no = rng.uniform(0.05, 1.0, (5, 7)).astype(np.float32) if per_element \
        else 0.3
    # one jitted program: op-by-op dispatch compiles each op separately
    want = jax.jit(getattr(jax_mapping, fn))(
        jnp.asarray(y), jnp.asarray(pts), jnp.asarray(no, jnp.float32))
    got = getattr(mapping, fn)(torch.as_tensor(y), torch.as_tensor(pts),
                               torch.as_tensor(no) if per_element else no)
    assert got.shape == (5, 7, bits)
    assert _rel(got, want) <= 2e-6


# -- equalisation and detection -----------------------------------------------

@pytest.mark.parametrize("streams", [1, 2])
def test_lmmse_equalize_matches_jax(streams):
    rng = np.random.default_rng(10 + streams)
    h = _cn(rng, (6, 9, 4, streams))
    y = _cn(rng, (6, 9, 4))
    for no in (0.2, rng.uniform(0.05, 0.5, (6, 9)).astype(np.float32)):
        want = jax.jit(jax_baselines.lmmse_equalize)(
            jnp.asarray(y), jnp.asarray(h), jnp.asarray(no))
        got = baselines.lmmse_equalize(
            torch.as_tensor(y), torch.as_tensor(h),
            torch.as_tensor(no) if isinstance(no, np.ndarray) else no)
        for g, w in zip(got, want):
            assert g.shape == (6, 9, streams)
            assert _rel(g, w) <= 5e-6


@pytest.mark.parametrize("streams", [1, 2, 3, 5])
def test_qr_small_reconstructs_and_is_orthonormal(streams):
    h = torch.as_tensor(_cn(np.random.default_rng(streams), (20, 6, streams)))
    q, r = baselines._qr_small(h)
    assert q.shape == (20, 6, streams) and r.shape == (20, streams, streams)
    assert float((q @ r - h).abs().max()) <= 1e-5
    eye = torch.eye(streams, dtype=torch.complex64)
    assert float((q.mH @ q - eye).abs().max()) <= 1e-5
    assert torch.equal(torch.triu(r), r)


def _noisy_link(seed, bits, streams, n=300, no=0.1):
    """y = H x + n for random 16/4/64-QAM symbols x on `streams` streams."""
    rng = np.random.default_rng(seed)
    h = _cn(rng, (n, 4, streams))
    x = qam_points(bits)[rng.integers(0, 2 ** bits, (n, streams))]
    y = np.einsum("nas,ns->na", h, x) + _cn(rng, (n, 4), np.sqrt(no))
    return y.astype(np.complex64), h, no


@pytest.mark.parametrize("bits,streams,k,exact", [
    (4, 1, 64, True), (4, 2, 64, True), (4, 1, 64, False),
    (4, 2, 64, False), (4, 2, 256, False), (2, 3, 64, False),
    (4, 3, 64, False)],
    ids=["exact_1", "exact_2", "list_1", "list_2_k64", "list_2_full",
         "list_3_qpsk_full", "list_3_k64"])
def test_kbest_detect_matches_jax(bits, streams, k, exact):
    y, h, no = _noisy_link(20 + streams + k, bits, streams)
    # one jitted program: op-by-op dispatch compiles each op separately
    want = jax.jit(functools.partial(
        jax_baselines.kbest_detect, no=no, num_bits_per_symbol=bits, k=k,
        exact=exact))(jnp.asarray(y), jnp.asarray(h))
    got = baselines.kbest_detect(torch.as_tensor(y), torch.as_tensor(h), no,
                                 bits, k=k, exact=exact)
    assert got.shape == (300, streams, bits)
    assert _rel(got, want) <= 1e-5


def test_kbest_full_tree_equals_exact_detector():
    y, h, no = _noisy_link(31, 4, 2)
    y, h = torch.as_tensor(y), torch.as_tensor(h)
    full = baselines.kbest_detect(y, h, no, 4, k=256, exact=False)
    exact = baselines.kbest_detect(y, h, no, 4)
    assert _rel(full, exact) <= 1e-5


# -- LS estimation ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _grids(training: bool):
    """(JAX resource grid, port resource grid) of nrx_rt: 4 PRB with
    training=True, 132 PRB otherwise; built once."""
    return (JaxParameters("nrx_rt", training=training).transmitters[
        0].resource_grid,
        Parameters("nrx_rt", training=training).resource_grid)


@functools.lru_cache(maxsize=None)
def _jax_estimator(training: bool):
    return jax_chest.LSChannelEstimator(_grids(training)[0])


@functools.lru_cache(maxsize=None)
def _estimators(training: bool, kind: str):
    """(JAX estimator, port estimator) of `kind` on the nrx_rt grid (4 PRB
    with training=True, 132 PRB otherwise), built once. The JAX estimator
    of lin and lin_extrap is a copy of nn's with the two attributes its
    `__call__` reads: its constructor differs only in the dense tables of
    nn."""
    jest = copy.copy(_jax_estimator(training))
    jest.extrapolate = kind == "lin_extrap"
    jest.interpolation_type = "nn" if kind == "nn" else "lin"
    return jest, chest.LSChannelEstimator(_grids(training)[1], kind)


@pytest.mark.parametrize("training", [True, False], ids=["4prb", "132prb"])
@pytest.mark.parametrize("kind", ["nn", "lin", "lin_extrap"])
def test_ls_estimate_matches_jax(training, kind):
    jest, est = _estimators(training, kind)
    n_sc = est.rg.num_subcarriers
    y = _cn(np.random.default_rng(3), (2, 4, 14, n_sc))
    want_h, want_ev = jax.jit(lambda y: jest(y, 0.3))(jnp.asarray(y))
    got_h, got_ev = est(torch.as_tensor(y), 0.3)
    assert got_h.shape == (2, 4, 2, 14, n_sc)
    assert _rel(got_h, want_h) <= 1e-6
    np.testing.assert_array_equal(got_ev.numpy(), np.asarray(want_ev))


@pytest.mark.parametrize("training", [True, False], ids=["4prb", "132prb"])
def test_gather_path_matches_jax(training):
    jest, est = _estimators(training, "nn")
    rng = np.random.default_rng(4)
    y = rng.normal(size=(2, 4, 14, est.rg.num_subcarriers, 2)).astype(
        np.float32)
    want = np.asarray(jest.estimate_planar(jnp.asarray(y)))
    got = est._estimate_planar_gather(torch.as_tensor(y)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, est.estimate_planar(torch.as_tensor(y)).numpy())


def test_type2_dmrs_builds_and_takes_the_gather_path():
    """A pilot pattern the dense tables cannot serve (DMRS configuration
    type 2: pairs of adjacent subcarriers): the estimator builds, the gather
    path matches JAX's and the neural receiver takes it, only the dense form
    refuses."""
    overrides = {"dmrs_config_type": 2}
    jrg = JaxParameters("nrx_rt", training=True,
                        overrides=overrides).transmitters[0].resource_grid
    rg = Parameters("nrx_rt", training=True,
                    overrides=overrides).resource_grid
    est = chest.LSChannelEstimator(rg)
    assert not est._dense_ok
    y = np.random.default_rng(8).normal(size=(2, 4, 14, 48, 2)).astype(
        np.float32)
    want = np.asarray(jax_chest.LSChannelEstimator(jrg).estimate_planar(
        jnp.asarray(y)))
    np.testing.assert_array_equal(
        est.estimate_planar(torch.as_tensor(y)).numpy(), want)
    with pytest.raises(NotImplementedError):
        est.estimate_planar_dense(torch.as_tensor(y))
    # the neural receiver of such a grid takes the gather path
    rx = receiver_for(Parameters("nrx_rt", training=True,
                                 overrides=overrides), device="cpu")
    _, h_in = rx._prepare_inputs(torch.as_tensor(y))
    np.testing.assert_array_equal(h_in.numpy(), want)


# -- LMMSE interpolation ------------------------------------------------------

@pytest.fixture(scope="module")
def covs():
    """The committed nrx_rt covariances (132 PRB), read only."""
    return tuple(np.load(f"weights/nrx_rt_{n}_cov_mat.npy")
                 for n in ("freq", "time", "space"))


def _interpolators(training, covs, num_prbs):
    cf, ct, cs = covs
    jrg, rg = _grids(training)
    n = rg.num_subcarriers
    return (jax_baselines.LMMSEChannelInterpolator(
        jrg, cf[:n, :n], ct, cs, lmmse_num_prbs=num_prbs),
        baselines.LMMSEChannelInterpolator(rg, cf[:n, :n], ct, cs,
                                           lmmse_num_prbs=num_prbs))


def _pilot_inputs(it, seed):
    rng = np.random.default_rng(seed)
    nd = len(it.dmrs_syms)
    return {tx: _cn(rng, (2, 4, nd, len(sc)))
            for tx, sc in it._pilot_sc.items()}


def test_exact_interpolator_matches_jax(covs):
    """132 PRB, no = 0.1: within 1e-3 of max |ref|."""
    jit, it = _interpolators(False, covs, -1)
    assert it.exact
    hp = _pilot_inputs(it, 5)
    want = np.asarray(jit({k: jnp.asarray(v) for k, v in hp.items()},
                          no=0.1))
    got = it({k: torch.as_tensor(v) for k, v in hp.items()}, no=0.1)
    assert got.shape == want.shape == (2, 4, 2, 14,
                                       it.rg.num_subcarriers)
    assert _rel(got, want) <= 1e-3


@pytest.mark.parametrize("training,no", [(True, 1e-3), (False, 1e-2)],
                         ids=["4prb_30dB", "132prb_20dB"])
def test_exact_interpolator_matches_float64_oracle(covs, training, no):
    """W = R_ao (R_oo + no_pil I)^-1 per stage in float64, as
    tests/test_lmmse_chest.py builds it; the bound is that of a complex64
    LU: 4 cond(A) eps32 of max |ref|."""
    cf, ct, cs = covs
    _, it = _interpolators(training, covs, -1)
    n = it.rg.num_subcarriers
    cf = cf[:n, :n].astype(np.complex128)
    hp = _pilot_inputs(it, 6)
    got = it({k: torch.as_tensor(v) for k, v in hp.items()}, no=no).numpy()
    no_pil = float(np.float32(no) / np.float32(it._pilot_pow))

    def a_of(cov, obs):
        return cov[np.ix_(obs, obs)] + no_pil * np.eye(len(obs))

    def w_np(cov, obs):
        return cov[:, obs] @ np.linalg.inv(a_of(cov, obs))

    ws = w_np(cs.astype(np.complex128), np.arange(4))
    wt = w_np(ct.astype(np.complex128), it.dmrs_syms)
    want = np.stack([
        np.einsum("st,batf->basf", wt, np.einsum(
            "fp,batp->batf", w_np(cf, it._pilot_sc[tx]),
            np.einsum("ij,bjts->bits", ws, hp[tx])))
        for tx in range(it.rg.num_tx)], axis=2)
    # A is Hermitian positive definite: cond = largest / smallest eigenvalue
    eig = [np.linalg.eigvalsh(a_of(cf, sc)) for sc in it._pilot_sc.values()]
    cond = max(e[-1] / e[0] for e in eig)
    assert _rel(got, want) <= 4 * cond * EPS32


def test_chunked_interpolator_matches_jax(covs):
    """lmmse_num_prbs = 0 at 132 PRB: 6 chunks of 22 PRB; the nearest bank
    on a log scale for noise levels across the grid, and the output."""
    jit, it = _interpolators(False, covs, 0)
    assert not it.exact and it.num_chunks == 6
    hp = _pilot_inputs(it, 7)
    for no in (0.9, 0.1, 0.03, 2e-3):
        no_pil = jnp.asarray(no, jnp.float32) / jit._pilot_pow
        want_idx = int(jnp.argmin(jnp.abs(
            jnp.log(jnp.maximum(no_pil, 1e-9))
            - jnp.log(jnp.asarray(jit._noise_grid)))))
        assert it.bank_index(no) == want_idx
        want = np.asarray(jit({k: jnp.asarray(v) for k, v in hp.items()},
                              no=no))
        got = it({k: torch.as_tensor(v) for k, v in hp.items()}, no=no)
        assert _rel(got, want) <= 1e-6


# -- covariance estimate ------------------------------------------------------

def test_covariance_accumulation_matches_jax():
    """JAX `compute_cov_matrices` (nrx_rt's 4-PRB training grid with its
    eval channel, DoubleTDLlow) against the port's `accumulate` of the CFRs
    JAX drew inside that call (recorded by a debug callback)."""
    jp = JaxParameters("nrx_rt", system="baseline_lmmse_lmmse", training=True,
                       overrides={"channel_type": "DoubleTDLlow"})
    drawn = []
    channel = jp.channel_model

    def recording(*args):
        h = channel(*args)
        jax.debug.callback(lambda v: drawn.append(np.array(v)), h)
        return h

    jp.channel_model = recording
    want = jax_covariance.compute_cov_matrices(jp, num_batches=2,
                                               batch_size=3, seed=9)
    assert len(drawn) == 2
    sums = None
    for h in drawn:  # [b, ant, 2 users, 2 ports, 14, sc]
        covs = covariance.accumulate(torch.as_tensor(
            h.reshape(h.shape[0], h.shape[1], -1, *h.shape[-2:])))
        sums = covs if sums is None else [s + c for s, c in zip(sums, covs)]
    for s, w in zip(sums, want):
        assert _rel(s.numpy() / 2, w) <= 1e-5


def test_covariance_draw_shapes():
    """`compute_cov_matrices` on the port's own draws: Hermitian, unit mean
    power on the diagonals."""
    p = Parameters("e2e_baseline", training=True,
                   overrides={"channel_type": "TDL-B100"})
    cf, ct, cs = covariance.compute_cov_matrices(
        p, torch.Generator().manual_seed(0), num_batches=2, batch_size=3)
    for c, n in ((cf, 48), (ct, 14), (cs, 4)):
        assert c.shape == (n, n) and c.dtype == np.complex64
        np.testing.assert_allclose(c, c.conj().T, atol=1e-6)
        assert abs(np.real(np.trace(c)) / n - 1.0) < 1e-5
    # UMi (the training channel, drawn for every user): [b, ant, T*ports]
    h = covariance.draw(Parameters("nrx_rt", training=True),
                        torch.Generator().manual_seed(1), 2)
    assert h.shape == (2, 4, 4, 14, 48) and h.dtype == torch.complex64


# -- Parameters ---------------------------------------------------------------

def test_parameters_system_and_overrides():
    p = Parameters("nrx_rt", system="baseline_lsnn_lmmse", training=False,
                   overrides={"channel_type": "TDL-B100", "n_size_bwp": 4})
    assert p.system == "baseline_lsnn_lmmse"
    # overrides land after the eval values and before any component
    assert p.channel_type_name == "TDL-B100" and p.channel_num_tx == 1
    assert p.resource_grid.num_subcarriers == 48
    dummy = Parameters("nrx_rt", system="dummy")
    assert dummy.label == "nrx_rt" and not hasattr(dummy, "transmitters")
    with pytest.raises(KeyError, match="no_such_key"):
        Parameters("nrx_rt", overrides={"no_such_key": 1})
    jp = JaxParameters("nrx_rt", system="baseline_lsnn_lmmse", training=False,
                       overrides={"channel_type": "TDL-B100",
                                  "n_size_bwp": 4})
    assert jp.channel_type_name == "TDL-B100"
    assert jp.transmitters[0].resource_grid.num_subcarriers == 48
