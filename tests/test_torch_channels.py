"""The PyTorch port's TDL and DoubleTDL channels against the JAX package.

- Parity given JAX's draws: JAX `TDLChannel.__call__` draws (speed, alpha,
  phi, los_phase) from a key with `jax.random.split(key, 4)` and uniform
  draws; the test makes the same draws and feeds them to the port's
  deterministic `TDLChannel.cfr` (DoubleTDL: `split(key)`, one key per
  link). Bar: max |port - JAX| / max |JAX| <= 1e-5.
- Static tables (correlation matrix, its square root, the phase matrix)
  equal JAX's within 1e-6.
- Statistics of the port's own draws (a torch.Generator), at the bars of
  tests/test_channels.py.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.special import j0

from neural_rx_tpu.channel import double_tdl as jax_double_tdl
from neural_rx_tpu.channel import tdl as jax_tdl
from neural_rx_tpu_torch.channel.double_tdl import DoubleTDLChannel
from neural_rx_tpu_torch.channel.tdl import (SPEED_OF_LIGHT, TDLChannel,
                                             _corr_sqrt,
                                             exp_correlation_matrix)

FC = 2.14e9
SCS = 30e3
PARITY_BAR = 1e-5


def jax_draws(ch, key, batch):
    """The draws JAX `TDLChannel.__call__` makes from `key`, as tensors."""
    k_speed, k_alpha, k_phi, k_los = jax.random.split(key, 4)
    shape = (batch, ch.num_rx_ant, ch.num_tx_ant, ch.num_taps, 32)
    speed = jax.random.uniform(
        k_speed, (batch,), minval=ch.min_speed,
        maxval=max(ch.max_speed, ch.min_speed + 1e-9))
    alpha = jax.random.uniform(k_alpha, shape, minval=-np.pi, maxval=np.pi)
    phi = jax.random.uniform(k_phi, shape, minval=-np.pi, maxval=np.pi)
    los = None
    if ch.k_factor_db is not None:
        los = jax.random.uniform(k_los, (batch,), minval=-np.pi,
                                 maxval=np.pi)
    return tuple(None if a is None else torch.as_tensor(np.asarray(a))
                 for a in (speed, alpha, phi, los))


def rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


TDL_CASES = [(m, corr, norm, 48, 3) for m in "ABCDE"
             for corr in (False, True) for norm in (False, True)] + [
    ("B", False, False, 1584, 2), ("C", True, False, 1584, 2)]


@pytest.mark.parametrize(
    "model,corr,normalize,num_sc,batch", TDL_CASES,
    ids=[f"{m}-{'corr' if c else 'iid'}-{'norm' if n else 'raw'}-{s}"
         for m, c, n, s, _ in TDL_CASES])
def test_tdl_cfr_matches_jax_given_its_draws(model, corr, normalize, num_sc,
                                             batch):
    kwargs = dict(min_speed=3.0, max_speed=56.0, num_rx_ant=4, num_tx_ant=2,
                  normalize=normalize)
    if corr:
        kwargs.update(rx_corr=exp_correlation_matrix(4, 0.9),
                      tx_corr=exp_correlation_matrix(2, 0.3))
    jch = jax_tdl.TDLChannel(model, 100e-9, FC, **kwargs)
    ch = TDLChannel(model, 100e-9, FC, **kwargs)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jch(key, batch, 14, num_sc, SCS))
    got = ch.cfr(jax_draws(jch, key, batch), 14, num_sc, SCS)
    assert got.dtype == torch.complex64
    assert got.shape == want.shape == (batch, 4, 2, 14, num_sc)
    assert rel_err(got.numpy(), want) <= PARITY_BAR


@pytest.mark.parametrize("correlation", ["low", "medium", "high"])
def test_double_tdl_matches_jax_given_its_draws(correlation):
    jch = jax_double_tdl.DoubleTDLChannel(FC, 4, 2, correlation=correlation)
    ch = DoubleTDLChannel(FC, 4, 2, correlation=correlation)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jch(key, 2, 14, 1584, SCS))
    k1, k2 = jax.random.split(key)
    got = ch.cfr([jax_draws(jch.tdl1, k1, 2), jax_draws(jch.tdl2, k2, 2)],
                 14, 1584, SCS)
    assert got.shape == want.shape == (2, 4, 2, 2, 14, 1584)
    assert rel_err(got.numpy(), want) <= PARITY_BAR
    # the links' speeds come from their Doppler, 400 Hz and 100 Hz
    assert [link.max_speed for link in ch.links] == [
        jch.tdl1.max_speed, jch.tdl2.max_speed]


@pytest.mark.parametrize("num_ant,a", [(1, 0.5), (2, 0.3), (4, 0.9),
                                       (8, 0.9), (4, 0.0)])
def test_static_tables_match_jax(num_ant, a):
    mat = exp_correlation_matrix(num_ant, a)
    np.testing.assert_allclose(
        mat, jax_tdl.exp_correlation_matrix(num_ant, a), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_corr_sqrt(mat), jax_tdl._corr_sqrt(mat),
                               rtol=0, atol=1e-6)
    ch = TDLChannel("C", 300e-9, FC)
    jch = jax_tdl.TDLChannel("C", 300e-9, FC)
    np.testing.assert_allclose(ch.phase_matrix(1584, SCS),
                               jch.phase_matrix(1584, SCS), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ch.powers, jch.powers)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _unit_power():
    h = TDLChannel("B", 100e-9, FC, max_speed=10.0, num_rx_ant=2,
                   num_tx_ant=1)(_gen(0), 512, 14, 48, SCS).numpy()
    assert abs(np.mean(np.abs(h) ** 2) - 1.0) < 0.1


def _jakes_autocorrelation():
    ch = TDLChannel("A", 30e-9, FC, min_speed=50.0, max_speed=50.0,
                    num_rx_ant=1, num_tx_ant=1)
    h = ch(_gen(1), 2048, 14, 4, SCS).numpy()
    fd = 50.0 * FC / SPEED_OF_LIGHT
    for lag in (1, 4, 8):
        corr = np.mean(h[..., 0, :-lag, :] * np.conj(h[..., 0, lag:, :]))
        assert abs(corr.real - j0(2 * np.pi * fd * lag / SCS)) < 0.05, lag


def _spatial_covariance(h):
    x = h.reshape(h.shape[0], -1)
    return (x.T @ x.conj()) / x.shape[0]


def _antenna_correlation():
    rx_corr = exp_correlation_matrix(4, 0.9)
    h = TDLChannel("B", 100e-9, FC, max_speed=0.0, num_rx_ant=4,
                   num_tx_ant=1, rx_corr=rx_corr)(_gen(2), 2048, 1, 1,
                                                  SCS).numpy()
    assert np.allclose(_spatial_covariance(h[:, :, 0, 0, 0]), rx_corr,
                       atol=0.08)


def _uncorrelated_by_default():
    h = TDLChannel("C", 300e-9, FC, max_speed=0.0, num_rx_ant=2,
                   num_tx_ant=2)(_gen(3), 4096, 1, 1, SCS).numpy()
    emp = _spatial_covariance(h)
    assert np.abs(emp - np.diag(np.diag(emp))).max() < 0.08


def _delay_spread_selectivity():
    def sc_corr(spread):
        g = TDLChannel("B", spread, FC, num_rx_ant=1, num_tx_ant=1)(
            _gen(4), 512, 1, 64, SCS).numpy()[:, 0, 0, 0]
        return abs(np.mean(g[:, :-32] * np.conj(g[:, 32:])))
    assert sc_corr(30e-9) > 0.9
    assert sc_corr(1000e-9) < 0.5


def _rician_k_factor_tdl_d():
    mag = np.abs(TDLChannel("D", 30e-9, FC, max_speed=0.0, num_rx_ant=1,
                            num_tx_ant=1)(_gen(5), 4096, 1, 1,
                                          SCS).numpy().ravel())
    assert mag.std() / mag.mean() < 0.5  # Rician, not Rayleigh (~0.52)


def _double_tdl_users_independent():
    h = DoubleTDLChannel(FC, 1, 1, correlation="low")(_gen(6), 2048, 1, 1,
                                                      SCS).numpy()
    assert h.shape == (2048, 1, 2, 1, 1, 1)
    assert abs(np.mean(h[:, 0, 0, 0, 0, 0] * np.conj(h[:, 0, 1, 0, 0, 0]))) \
        < 0.08


STATISTICS = [_unit_power, _jakes_autocorrelation, _antenna_correlation,
              _uncorrelated_by_default, _delay_spread_selectivity,
              _rician_k_factor_tdl_d, _double_tdl_users_independent]


@pytest.mark.parametrize("check", STATISTICS,
                         ids=[f.__name__[1:] for f in STATISTICS])
def test_statistics_of_own_draws(check):
    check()


def test_static_tables_built_once_per_device():
    ch = TDLChannel("B", 100e-9, FC, num_rx_ant=2, num_tx_ant=1,
                    rx_corr=exp_correlation_matrix(2, 0.5))
    gen = _gen(0)
    ch(gen, 2, 14, 48, SCS)
    first = dict(ch._device_tables(48, SCS, torch.device("cpu")))
    ch(gen, 2, 14, 48, SCS)
    again = ch._device_tables(48, SCS, torch.device("cpu"))
    assert all(again[k] is v for k, v in first.items())
