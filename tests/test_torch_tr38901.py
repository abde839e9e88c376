"""The PyTorch port's TR 38.901 UMi/UMa channel against the JAX package.

- Parity given JAX's draws: JAX `UMiUMaChannel.__call__` draws from 16
  split keys (the zenith spreads and angles from `fold_in(keys[15], i)`,
  the azimuth perturbations from `fold_in(keys[10|11], 1)`, the cluster
  signs by `jax.random.choice`); `jax_draws` makes the same draws and feeds
  them to the port's deterministic `UMiUMaChannel.cfr`. UMi and UMa, 48 and
  1584 subcarriers, batch 2, 2 users. Bar: max |port - JAX| / max |JAX|
  <= 1e-5.
- Static tables (Cholesky factors, scenario parameters, LOS probability,
  ZSD parameters, element pattern, zenith mirroring) within 1e-6.
- Statistics of the port's own draws (a torch.Generator) at the bars of
  tests/test_tr38901.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.channel import tr38901 as jax_tr
from neural_rx_tpu_torch.channel import tr38901 as tr
from neural_rx_tpu_torch.channel.tr38901 import UMiUMaChannel

FC = 2.14e9
SCS = 30e3
PARITY_BAR = 1e-5


def make(scenario="umi", port=True, **kw):
    kw.setdefault("num_rx_ant", 4)
    kw.setdefault("num_tx_ant", 2)
    cls = UMiUMaChannel if port else jax_tr.UMiUMaChannel
    return cls(scenario, FC, **kw)


def jax_draws(jch, key, batch, num_tx):
    """The draws JAX `UMiUMaChannel.__call__` makes from `key`, under the
    port's names."""
    ks = list(jax.random.split(key, 16))
    shape = (batch, num_tx)
    cl = shape + (jch.n_cl,)
    kz = [jax.random.fold_in(ks[15], i) for i in range(8)]
    u = jax.random.uniform
    n = jax.random.normal
    signs = jnp.asarray([-1.0, 1.0])
    d = {"d2d_u": u(ks[0], shape),
         "phi_los_aod": u(ks[1], shape, minval=-60.0, maxval=60.0),
         "phi_los_aoa": u(ks[2], shape, minval=-180.0, maxval=180.0),
         "speed": u(ks[3], shape, minval=jch.min_speed,
                    maxval=jch.max_speed + 1e-9),
         "v_dir": u(ks[4], shape, minval=-np.pi, maxval=np.pi),
         "los_u": u(ks[5], shape),
         "lsp_los": n(ks[6], shape + (4,)),
         "lsp_nlos": n(ks[7], shape + (4,)),
         "zsa_los": n(kz[0], shape), "zsa_nlos": n(kz[1], shape),
         "zsd_los": n(kz[2], shape), "zsd_nlos": n(kz[3], shape),
         "u_tau": u(ks[8], cl, minval=1e-6, maxval=1.0),
         "z": n(ks[9], cl),
         "ph": u(ks[12], cl + (20, 4), minval=-np.pi, maxval=np.pi),
         "xpr": n(ks[13], cl + (20,)),
         "los_phase": u(ks[14], shape, minval=-np.pi, maxval=np.pi)}
    for name, k1, k2 in (("aoa", ks[10], jax.random.fold_in(ks[10], 1)),
                         ("aod", ks[11], jax.random.fold_in(ks[11], 1)),
                         ("zoa", kz[4], kz[5]), ("zod", kz[6], kz[7])):
        d["sign_" + name] = jax.random.choice(k1, signs, cl)
        d["y_" + name] = n(k2, cl)
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


CFR_CASES = [("umi", 48, {}), ("uma", 48, {}), ("umi", 1584, {}),
             ("uma", 1584, {}),
             ("umi", 48, {"min_speed": 0.0, "max_speed": 56.0,
                          "normalize": True}),
             ("uma", 48, {"min_speed": 3.0, "max_speed": 30.0,
                          "cluster_split": False})]


@pytest.mark.parametrize(
    "scenario,num_sc,kw", CFR_CASES,
    ids=[f"{s}-{n}" + ("-" + "-".join(sorted(k)) if k else "")
         for s, n, k in CFR_CASES])
def test_cfr_matches_jax_given_its_draws(scenario, num_sc, kw):
    jch = make(scenario, port=False, **kw)
    ch = make(scenario, **kw)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jch(key, 2, 2, 14, num_sc, SCS))
    got = ch.cfr(jax_draws(jch, key, 2, 2), 14, num_sc, SCS)
    assert got.dtype == torch.complex64
    assert got.shape == want.shape == (2, 4, 2, 2, 14, num_sc)
    assert np.isfinite(want).all()
    assert rel_err(got.numpy(), want) <= PARITY_BAR


@pytest.mark.parametrize("scenario", ["umi", "uma"])
def test_static_tables_match_jax(scenario):
    ch, jch = make(scenario), make(scenario, port=False)
    for state in ("los", "nlos"):
        np.testing.assert_allclose(ch.lsp_chol[state], jch.lsp_chol[state],
                                   rtol=0, atol=1e-6)
        assert ch.params[state] == pytest.approx(jch.params[state],
                                                 abs=1e-6)
        d = np.asarray([5.0, 18.0, 50.0, 120.0, 400.0], np.float32)
        mu, sig, off = tr.zsd_lg_params(scenario, state, torch.tensor(d),
                                        1.5, ch.h_bs, FC / 1e9)
        jmu, jsig, joff = jax_tr.zsd_lg_params(scenario, state,
                                               jnp.asarray(d), 1.5, jch.h_bs,
                                               FC / 1e9)
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6,
                                   atol=1e-6)
        assert sig == jsig
        np.testing.assert_allclose(off.numpy(), np.asarray(joff), rtol=1e-6,
                                   atol=1e-6)
    assert (ch.n_cl, ch.cell_radius, ch.min_dist, ch.h_bs) == (
        jch.n_cl, jch.cell_radius, jch.min_dist, jch.h_bs)
    d = np.linspace(1.0, 400.0, 97).astype(np.float32)
    np.testing.assert_allclose(
        tr._los_probability(torch.tensor(d), scenario).numpy(),
        np.asarray(jax_tr._los_probability(jnp.asarray(d), scenario)),
        rtol=0, atol=1e-6)


def test_angle_helpers_match_jax():
    rng = np.random.default_rng(0)
    phi = rng.uniform(-200, 200, 64).astype(np.float32)
    theta = rng.uniform(-50, 400, 64).astype(np.float32)
    np.testing.assert_allclose(
        tr._bs_element_gain_db(torch.tensor(phi), torch.tensor(theta)),
        np.asarray(jax_tr._bs_element_gain_db(jnp.asarray(phi),
                                              jnp.asarray(theta))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tr.mirror_zenith(torch.tensor(theta)).numpy(),
        np.asarray(jax_tr.mirror_zenith(jnp.asarray(theta))), rtol=0,
        atol=1e-5)
    np.testing.assert_array_equal(tr.RAY_SUBCLUSTER, jax_tr.RAY_SUBCLUSTER)
    np.testing.assert_array_equal(tr.RAY_OFFSETS, jax_tr.RAY_OFFSETS)


def test_draws_have_the_documented_shapes_and_ranges():
    ch = make(min_speed=3.0, max_speed=56.0)
    d = ch.draw(torch.Generator().manual_seed(0), 3, 2)
    jd = jax_draws(make(port=False, min_speed=3.0, max_speed=56.0),
                   jax.random.PRNGKey(0), 3, 2)
    assert d.keys() == jd.keys()
    for k in d:
        assert d[k].shape == jd[k].shape and d[k].dtype == torch.float32, k
    assert set(d["sign_aoa"].unique().tolist()) <= {-1.0, 1.0}
    assert (d["u_tau"] >= 1e-6).all() and (d["u_tau"] < 1.0).all()
    assert (d["speed"] >= 3.0).all() and (d["speed"] <= 56.0).all()
    assert d["phi_los_aod"].abs().max() <= 60.0


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _shape_and_finite():
    for scenario in ("umi", "uma"):
        h = make(scenario)(_gen(0), 4, 2, 14, 48, SCS)
        assert h.shape == (4, 4, 2, 2, 14, 48)
        assert torch.isfinite(torch.view_as_real(h)).all()


def _mean_power_order_unity():
    h = make()(_gen(1), 64, 1, 1, 16, SCS).numpy()
    assert 0.03 < (np.abs(h) ** 2).mean() < 3.0


def _frequency_selectivity():
    h0 = make()(_gen(2), 128, 1, 1, 256, SCS).numpy()[:, 0, 0, 0, 0]
    c_near = np.mean(h0[:, :-1] * np.conj(h0[:, 1:]))
    c_far = np.mean(h0[:, :-128] * np.conj(h0[:, 128:]))
    p = np.mean(np.abs(h0) ** 2)
    assert abs(c_near) / p > 0.8
    assert abs(c_far) / p < 0.7


def _time_variation_with_speed():
    def var_t(h):
        return np.mean(np.abs(h[..., -1, :] - h[..., 0, :]) ** 2) \
            / np.mean(np.abs(h) ** 2)
    hs = make(min_speed=0.0, max_speed=0.0)(_gen(3), 64, 1, 14, 4, SCS)
    hf = make(min_speed=56.0, max_speed=56.0)(_gen(3), 64, 1, 14, 4, SCS)
    assert var_t(hs.numpy()) < 1e-6
    assert var_t(hf.numpy()) > 1e-3


def _users_independent():
    h = make()(_gen(4), 512, 2, 1, 1, SCS).numpy()
    u1, u2 = h[:, 0, 0, 0, 0, 0], h[:, 0, 1, 0, 0, 0]
    p = np.sqrt(np.mean(np.abs(u1) ** 2) * np.mean(np.abs(u2) ** 2))
    assert abs(np.mean(u1 * np.conj(u2))) / p < 0.1


def _antennas_equal_power():
    h = make()(_gen(6), 256, 1, 1, 8, SCS).numpy()
    p_ant = (np.abs(h[:, :, 0, 0, 0]) ** 2).mean(axis=(0, 2))
    assert p_ant.std() / p_ant.mean() < 0.2


def _lsp_cross_correlation():
    ch = make()
    n = torch.randn((60000, 4), generator=_gen(7))
    ds, asa, asd, k_db = ch.lsp(n, "los")
    lds, lasa, lasd = (np.log10(x.numpy()) for x in (ds, asa, asd))

    def c(a, b):
        return float(np.corrcoef(a, b)[0, 1])
    assert abs(c(lds, k_db.numpy()) - (-0.7)) < 0.03
    assert abs(c(lds, lasa) - 0.8) < 0.1
    assert abs(c(lds, lasd) - 0.5) < 0.1
    assert abs(c(lasa, lasd) - 0.4) < 0.1


def _normalize_gives_unit_power():
    h = make(normalize=True)(_gen(8), 8, 2, 14, 48, SCS)
    mp = (h.abs() ** 2).mean(dim=(1, 3, 4, 5))
    np.testing.assert_allclose(mp.numpy(), 1.0, rtol=1e-4)


def _zero_cds_split_is_identity():
    off = make(cluster_split=False)
    on = make()
    for st in ("los", "nlos"):
        on.params[st] = dict(on.params[st], c_ds_ns=0.0)
    d = on.draw(_gen(9), 4, 2)
    np.testing.assert_allclose(on.cfr(d, 14, 48, SCS).numpy(),
                               off.cfr(d, 14, 48, SCS).numpy(), rtol=1e-4,
                               atol=1e-5)


STATISTICS = {f.__name__[1:]: f for f in (
    _shape_and_finite, _mean_power_order_unity, _frequency_selectivity,
    _time_variation_with_speed, _users_independent, _antennas_equal_power,
    _lsp_cross_correlation, _normalize_gives_unit_power,
    _zero_cds_split_is_identity)}


@pytest.mark.parametrize("name", list(STATISTICS))
def test_statistics_of_own_draws(name):
    STATISTICS[name]()


def test_compute_cov_cli_on_umi_at_the_eval_width(tmp_path):
    """`cli.compute_cov` on the CPU: nrx_rt's UMi training channel at its
    132-PRB eval grid; three Hermitian PSD matrices with unit mean diagonal
    power written as {label}_{freq,time,space}_cov_mat.npy."""
    from neural_rx_tpu_torch.cli import compute_cov
    compute_cov.main(["--config", "nrx_rt", "--batches", "1",
                      "--batch-size", "2", "--device", "cpu", "--out-dir",
                      str(tmp_path)])
    for name, n in (("freq", 1584), ("time", 14), ("space", 4)):
        c = np.load(tmp_path / f"nrx_rt_{name}_cov_mat.npy")
        assert c.shape == (n, n) and c.dtype == np.complex64
        np.testing.assert_allclose(c, c.conj().T, atol=1e-6)
        eig = np.linalg.eigvalsh(c.astype(np.complex128))
        assert eig.min() > -1e-5 * eig.max(), name
        assert abs(np.real(np.trace(c)) / n - 1.0) < 1e-4
