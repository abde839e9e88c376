"""TR 38.901 UMi/UMa stochastic channel in the frequency domain.

The port's copy of `neural_rx_tpu/channel/tr38901.py`, the training channel
of most configurations: one random single-sector drop per batch item and
user (distance, LOS/NLOS by the distance-dependent LOS probability, speed
and direction), jointly correlated lognormal large-scale parameters (DS,
ASA, ASD, K; Table 7.5-6, shadow fading off), zenith spreads and offsets
(Tables 7.5-7/8), cluster delays and powers with the LOS K-correction, the
two strongest clusters split into three sub-clusters, wrapped-Gaussian
azimuths and inverse-Laplacian zeniths with 20 rays per cluster, random
coupling phases and XPR, a dual-polarised BS ULA with the 38.901 element
pattern and a single-polarised UT ULA, per-ray Doppler across the slot,
and a LOS specular ray. Pathloss is off, as in the reference's setup.

As `channel/tdl.py`, the random draws and the arithmetic are separate:
`draw` takes a `torch.Generator` and returns every draw as a named tensor
(standard normals, uniforms and signs before the parameter-dependent
scaling); `cfr` is deterministic, so a test can feed it the draws of the
JAX package's 16 split keys. Both LOS states are computed for every item
and selected by the LOS draw, as in the JAX package, with its guards: the
NLOS K-factor held at -100 dB, the angle spreads clipped at 104 degrees,
the delay uniforms floored at 1e-6.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .tdl import SPEED_OF_LIGHT

# Ray offset angles within a cluster (38.901 Table 7.5-3), M = 20
RAY_OFFSETS = np.array([
    0.0447, -0.0447, 0.1413, -0.1413, 0.2492, -0.2492, 0.3715, -0.3715,
    0.5129, -0.5129, 0.6797, -0.6797, 0.8844, -0.8844, 1.1481, -1.1481,
    1.5195, -1.5195, 2.1551, -2.1551])

# Fixed ray -> sub-cluster assignment of a split cluster (Table 7.5-5,
# 0-based: R1 = {1-8, 19, 20}, R2 = {9-12, 17, 18}, R3 = {13-16}); one-hot
# [num_rays, 3]
_SUB_OF_RAY = np.zeros(20, np.int64)
_SUB_OF_RAY[[8, 9, 10, 11, 16, 17]] = 1
_SUB_OF_RAY[[12, 13, 14, 15]] = 2
RAY_SUBCLUSTER = np.eye(3, dtype=np.float32)[_SUB_OF_RAY]
# sub-cluster delay offsets in units of c_DS (38.901 §7.5 step 11)
SUBCLUSTER_DELAY_OFFSETS = np.array([0.0, 1.28, 2.56], np.float32)

# Inter-LSP cross-correlations (Table 7.5-6, SF rows dropped), order
# (DS, ASA, ASD, K)
_LSP_XCORR = {
    ("umi", "los"): dict(ds_asa=0.8, ds_asd=0.5, ds_k=-0.7,
                         asa_asd=0.4, asa_k=-0.3, asd_k=-0.2),
    ("umi", "nlos"): dict(ds_asa=0.4, ds_asd=0.0, ds_k=0.0,
                          asa_asd=0.0, asa_k=0.0, asd_k=0.0),
    ("uma", "los"): dict(ds_asa=0.8, ds_asd=0.4, ds_k=-0.4,
                         asa_asd=0.0, asa_k=-0.2, asd_k=0.0),
    ("uma", "nlos"): dict(ds_asa=0.6, ds_asd=0.4, ds_k=0.0,
                          asa_asd=0.4, asa_k=0.0, asd_k=0.0),
}
# cluster-count factors of the azimuth (7.5-9) and zenith (7.5-14) inverses
_C_PHI = {8: 0.703, 10: 0.737, 11: 0.753, 12: 0.779, 14: 0.810, 15: 0.831,
          16: 0.844, 19: 0.889, 20: 0.957}
_C_THETA = {8: 0.889, 10: 0.957, 11: 1.031, 12: 1.104, 15: 1.1088,
            16: 1.1088, 19: 1.184, 20: 1.178}
_NUM_RAYS = 20
_STATES = ("los", "nlos")


def _lsp_cholesky(scenario: str, state: str) -> np.ndarray:
    """Lower Cholesky factor of the (DS, ASA, ASD, K) correlation matrix."""
    c = _LSP_XCORR[(scenario, state)]
    m = np.array([
        [1.0, c["ds_asa"], c["ds_asd"], c["ds_k"]],
        [c["ds_asa"], 1.0, c["asa_asd"], c["asa_k"]],
        [c["ds_asd"], c["asa_asd"], 1.0, c["asd_k"]],
        [c["ds_k"], c["asa_k"], c["asd_k"], 1.0]], np.float64)
    return np.linalg.cholesky(m).astype(np.float32)


def _umi_params(fc):
    """Table 7.5-6 UMi parameters per LOS state; fc in GHz."""
    lf = np.log10(1 + fc)
    return {
        "los": dict(
            ds_mu=-0.24 * lf - 7.14, ds_sig=0.38,
            asd_mu=-0.05 * lf + 1.21, asd_sig=0.41,
            asa_mu=-0.08 * lf + 1.73, asa_sig=0.014 * lf + 0.28,
            zsa_mu=-0.1 * lf + 0.73, zsa_sig=-0.04 * lf + 0.34,
            k_mu=9.0, k_sig=5.0, r_tau=3.0, num_clusters=12,
            c_asd=3.0, c_asa=17.0, c_zsa=7.0,
            xpr_mu=9.0, xpr_sig=3.0, zeta=3.0,
            c_ds_ns=5.0),
        "nlos": dict(
            ds_mu=-0.24 * lf - 6.83, ds_sig=0.16 * lf + 0.28,
            asd_mu=-0.23 * lf + 1.53, asd_sig=0.11 * lf + 0.33,
            asa_mu=-0.08 * lf + 1.81, asa_sig=0.05 * lf + 0.3,
            zsa_mu=-0.04 * lf + 0.92, zsa_sig=-0.07 * lf + 0.41,
            k_mu=0.0, k_sig=0.0, r_tau=2.1, num_clusters=19,
            c_asd=10.0, c_asa=22.0, c_zsa=7.0,
            xpr_mu=8.0, xpr_sig=3.0, zeta=3.0,
            c_ds_ns=11.0),
    }


def _uma_params(fc):
    """Table 7.5-6 UMa parameters per LOS state; fc in GHz, floored at 6."""
    fc = max(fc, 6.0)
    lf = np.log10(fc)
    c_ds = max(0.25, 6.5622 - 3.4084 * lf)
    return {
        "los": dict(
            ds_mu=-6.955 - 0.0963 * lf, ds_sig=0.66,
            asd_mu=1.06 + 0.1114 * lf, asd_sig=0.28,
            asa_mu=1.81, asa_sig=0.20,
            zsa_mu=0.95, zsa_sig=0.16,
            k_mu=9.0, k_sig=3.5, r_tau=2.5, num_clusters=12,
            c_asd=5.0, c_asa=11.0, c_zsa=7.0,
            xpr_mu=8.0, xpr_sig=4.0, zeta=3.0,
            c_ds_ns=c_ds),
        "nlos": dict(
            ds_mu=-6.28 - 0.204 * lf, ds_sig=0.39,
            asd_mu=1.5 - 0.1144 * lf, asd_sig=0.28,
            asa_mu=2.08 - 0.27 * lf, asa_sig=0.11,
            zsa_mu=-0.3236 * lf + 1.512, zsa_sig=0.16,
            k_mu=0.0, k_sig=0.0, r_tau=2.3, num_clusters=20,
            c_asd=2.0, c_asa=15.0, c_zsa=7.0,
            xpr_mu=7.0, xpr_sig=3.0, zeta=3.0,
            c_ds_ns=c_ds),
    }


def zsd_lg_params(scenario: str, state: str, d2d: torch.Tensor, h_ut, h_bs,
                  fc_ghz: float = 2.14):
    """(mu_lgZSD [like d2d], sigma_lgZSD, ZOD offset [deg, like d2d]) of
    Tables 7.5-7/8 for 2D distances d2d [m]."""
    d_km = d2d / 1000.0
    if scenario == "umi":
        if state == "los":
            mu = torch.clamp(-14.8 * d_km + 0.01 * abs(h_ut - h_bs) + 0.83,
                             min=-0.21)
            return mu, 0.35, torch.zeros_like(d2d)
        mu = torch.clamp(-3.1 * d_km + 0.01 * max(h_ut - h_bs, 0.0) + 0.2,
                         min=-0.5)
        off = -(10 ** (-1.5 * torch.log10(torch.clamp(d2d, min=10.0))
                       + 3.3))
        return mu, 0.35, off
    lf = np.log10(max(fc_ghz, 6.0))
    if state == "los":
        mu = torch.clamp(-2.1 * d_km - 0.01 * (h_ut - 1.5) + 0.75, min=-0.5)
        return mu, 0.40, torch.zeros_like(d2d)
    mu = torch.clamp(-2.1 * d_km - 0.01 * (h_ut - 1.5) + 0.9, min=-0.5)
    off = (7.66 * lf - 5.96
           - 10 ** ((0.208 * lf - 0.782)
                    * torch.log10(torch.clamp(d2d, min=25.0))
                    - 0.13 * lf + 2.03 - 0.07 * (h_ut - 1.5)))
    return mu, 0.49, off


def mirror_zenith(theta_deg: torch.Tensor) -> torch.Tensor:
    """Zenith angles folded into [0, 180] (38.901 step 7b)."""
    t = torch.remainder(theta_deg, 360.0)
    return torch.where(t > 180.0, 360.0 - t, t)


def _los_probability(d2d: torch.Tensor, scenario: str) -> torch.Tensor:
    """Table 7.4.2-1 LOS probability at 2D distance d2d (UMa: h_UT <= 13
    m)."""
    d1 = 36.0 if scenario == "umi" else 63.0
    return torch.clamp(18.0 / d2d, max=1.0) * (1 - torch.exp(-d2d / d1)) \
        + torch.exp(-d2d / d1)


def _bs_element_gain_db(phi_deg, theta_deg=90.0):
    """38.901 §7.3 element power pattern [dB]: 65 degree HPBW in both cuts,
    30 dB floor."""
    a_v = torch.clamp(12.0 * ((theta_deg - 90.0) / 65.0) ** 2, max=30.0)
    a_h = torch.clamp(12.0 * (phi_deg / 65.0) ** 2, max=30.0)
    return -torch.clamp(a_v + a_h, max=30.0)


def _uniform(generator, shape, lo, hi):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def _normal(generator, shape):
    return torch.randn(shape, generator=generator, device=generator.device)


def _phase(x: torch.Tensor) -> torch.Tensor:
    """exp(j x) of a real phase, complex64."""
    return torch.polar(torch.ones_like(x), x)


class UMiUMaChannel:
    """Multi-user 38.901 UMi/UMa channel, one random drop per batch item
    and user.

    `cfr(draw(generator, batch, num_tx), num_symbols, num_sc, spacing)` ->
    h [batch, num_rx_ant, num_tx, num_tx_ant, num_symbols, num_sc]
    complex64; normalize: scale each (item, user) to unit mean power.
    """

    def __init__(self, scenario: str, carrier_frequency: float,
                 num_rx_ant: int = 4, num_tx_ant: int = 2,
                 min_speed: float = 0.0, max_speed: float = 0.0,
                 normalize: bool = False, cell_radius: float = 120.0,
                 min_dist: float = 10.0, cluster_split: bool = True):
        if scenario not in ("umi", "uma"):
            raise ValueError(f"scenario umi or uma, not {scenario!r}")
        self.scenario = scenario
        self.cluster_split = cluster_split
        self.lsp_chol = {s: _lsp_cholesky(scenario, s) for s in _STATES}
        self.fc = carrier_frequency
        fc_ghz = carrier_frequency / 1e9
        self.params = (_umi_params(fc_ghz) if scenario == "umi"
                       else _uma_params(fc_ghz))
        self.num_rx_ant = num_rx_ant
        self.num_tx_ant = num_tx_ant
        self.min_speed = float(min_speed)
        self.max_speed = float(max(max_speed, min_speed))
        self.normalize = normalize
        self.cell_radius = cell_radius if scenario == "umi" else 250.0
        self.min_dist = min_dist if scenario == "umi" else 35.0
        self.h_bs = 10.0 if scenario == "umi" else 25.0
        self.h_ut = 1.5
        self.wavelength = SPEED_OF_LIGHT / carrier_frequency
        # BS: dual-pol cross columns at half a wavelength; UT: vertical
        self.num_bs_cols = max(num_rx_ant // 2, 1)
        self.bs_dual_pol = num_rx_ant >= 2
        self.n_cl = max(self.params[s]["num_clusters"] for s in _STATES)

    # -- draws -----------------------------------------------------------
    def draw(self, generator: torch.Generator, batch_size: int,
             num_tx: int) -> dict:
        """Every random draw of one call, float32 on the generator's device,
        drawn in this order, shape [b, T] unless given:

        d2d_u U[0, 1) (distance), phi_los_aod U[-60, 60), phi_los_aoa
        U[-180, 180) (degrees), speed U[min, max + 1e-9), v_dir U[-pi, pi),
        los_u U[0, 1) (LOS if below the LOS probability), lsp_los and
        lsp_nlos N(0, 1) [b, T, 4] (DS, ASA, ASD, K before correlation),
        zsa_los, zsa_nlos, zsd_los, zsd_nlos N(0, 1), u_tau U[1e-6, 1) [b,
        T, NC], z N(0, 1) [b, T, NC] (cluster shadowing), then for aoa,
        aod, zoa and zod in turn sign_* in {-1, 1} and y_* N(0, 1) [b, T,
        NC], ph U[-pi, pi) [b, T, NC, 20, 4] (coupling phases), xpr N(0, 1)
        [b, T, NC, 20], los_phase U[-pi, pi)."""
        g = generator
        shape = (batch_size, num_tx)
        cl = shape + (self.n_cl,)
        d = {"d2d_u": _uniform(g, shape, 0.0, 1.0),
             "phi_los_aod": _uniform(g, shape, -60.0, 60.0),
             "phi_los_aoa": _uniform(g, shape, -180.0, 180.0),
             "speed": _uniform(g, shape, self.min_speed,
                               self.max_speed + 1e-9),
             "v_dir": _uniform(g, shape, -math.pi, math.pi),
             "los_u": _uniform(g, shape, 0.0, 1.0),
             "lsp_los": _normal(g, shape + (4,)),
             "lsp_nlos": _normal(g, shape + (4,))}
        for name in ("zsa_los", "zsa_nlos", "zsd_los", "zsd_nlos"):
            d[name] = _normal(g, shape)
        d["u_tau"] = _uniform(g, cl, 1e-6, 1.0)
        d["z"] = _normal(g, cl)
        for name in ("aoa", "aod", "zoa", "zod"):
            d["sign_" + name] = 2.0 * torch.randint(
                0, 2, cl, generator=g, device=g.device).float() - 1.0
            d["y_" + name] = _normal(g, cl)
        d["ph"] = _uniform(g, cl + (_NUM_RAYS, 4), -math.pi, math.pi)
        d["xpr"] = _normal(g, cl + (_NUM_RAYS,))
        d["los_phase"] = _uniform(g, shape, -math.pi, math.pi)
        return d

    def lsp(self, normals: torch.Tensor, state: str):
        """(DS [s], ASA, ASD [deg, clipped at 104], K [dB]) of one LOS state
        from standard normals [..., 4], correlated by the Cholesky factor
        of Table 7.5-6."""
        p = self.params[state]
        chol = torch.as_tensor(self.lsp_chol[state], device=normals.device)
        x = torch.einsum("...j,ij->...i", normals, chol)
        ds = 10 ** (p["ds_mu"] + p["ds_sig"] * x[..., 0])
        asa = torch.clamp(10 ** (p["asa_mu"] + p["asa_sig"] * x[..., 1]),
                          max=104.0)
        asd = torch.clamp(10 ** (p["asd_mu"] + p["asd_sig"] * x[..., 2]),
                          max=104.0)
        k_db = p["k_mu"] + p["k_sig"] * x[..., 3]
        return ds, asa, asd, k_db

    # -- channel ---------------------------------------------------------
    def cfr(self, draws: dict, num_symbols: int, num_sc: int,
            subcarrier_spacing: float,
            symbol_duration: float | None = None) -> torch.Tensor:
        """CFRs h [b, num_rx_ant, T, num_tx_ant, num_symbols, num_sc]
        complex64 from `draw`'s draws, on their device."""
        if symbol_duration is None:
            symbol_duration = 1.0 / subcarrier_spacing
        d = draws
        dev = d["d2d_u"].device
        nc, nr = self.n_cl, _NUM_RAYS
        pl, pn = self.params["los"], self.params["nlos"]

        # topology drop
        d2d = torch.sqrt(d["d2d_u"] * (self.cell_radius ** 2
                                       - self.min_dist ** 2)
                         + self.min_dist ** 2)
        phi_los_aod, phi_los_aoa = d["phi_los_aod"], d["phi_los_aoa"]
        speed, v_dir = d["speed"], d["v_dir"]
        is_los = d["los_u"] < _los_probability(d2d, self.scenario)

        def sel(a, b):
            return torch.where(is_los, a, b)

        def per_state(key):
            return torch.where(
                is_los, torch.tensor(float(pl[key]), device=dev),
                torch.tensor(float(pn[key]), device=dev))

        # LSPs of both states, selected by the LOS draw; K only for LOS,
        # -100 dB (not -inf) elsewhere so every lane stays finite
        lsp_l = self.lsp(d["lsp_los"], "los")
        lsp_n = self.lsp(d["lsp_nlos"], "nlos")
        ds, asa, asd = (sel(a, b) for a, b in zip(lsp_l[:3], lsp_n[:3]))
        k_db = torch.where(is_los, lsp_l[3], -100.0)
        k_lin = torch.where(is_los, 10 ** (k_db / 10), 0.0)
        r_tau, c_asa, c_asd = (per_state(k) for k in ("r_tau", "c_asa",
                                                      "c_asd"))
        xpr_mu, xpr_sig = per_state("xpr_mu"), per_state("xpr_sig")
        n_active = per_state("num_clusters")
        cl_mask = (torch.arange(nc, device=dev)[None, None, :]
                   < n_active[..., None]).float()

        # zenith LSPs (step 4b), independent of the azimuth block
        fc_ghz = self.fc / 1e9
        zsa = torch.clamp(sel(
            10 ** (pl["zsa_mu"] + pl["zsa_sig"] * d["zsa_los"]),
            10 ** (pn["zsa_mu"] + pn["zsa_sig"] * d["zsa_nlos"])), max=52.0)
        zl_mu, zl_sig, zl_off = zsd_lg_params(self.scenario, "los", d2d,
                                              self.h_ut, self.h_bs, fc_ghz)
        zn_mu, zn_sig, zn_off = zsd_lg_params(self.scenario, "nlos", d2d,
                                              self.h_ut, self.h_bs, fc_ghz)
        zsd = torch.clamp(sel(
            10 ** (zl_mu + zl_sig * d["zsd_los"]),
            10 ** (zn_mu + zn_sig * d["zsd_nlos"])), max=52.0)
        mu_lg_zsd = sel(zl_mu, zn_mu)
        zod_off = sel(zl_off, zn_off)
        c_zsa = per_state("c_zsa")
        # geometric LOS zenith: arrival at the BS, departure at the UT
        d3d = torch.sqrt(d2d ** 2 + (self.h_bs - self.h_ut) ** 2)
        th_los_zoa = torch.rad2deg(torch.arccos((self.h_ut - self.h_bs)
                                                / d3d))
        th_los_zod = 180.0 - th_los_zoa

        # cluster delays and powers (steps 5-6)
        tau_p = -r_tau[..., None] * ds[..., None] * torch.log(d["u_tau"])
        tau = torch.sort(tau_p - tau_p.amin(-1, keepdim=True), dim=-1)[0]
        z = per_state("zeta")[..., None] * d["z"]
        p_cl = torch.exp(-tau * (r_tau[..., None] - 1)
                         / (r_tau[..., None] * ds[..., None])) \
            * 10 ** (-z / 10)
        p_cl = p_cl * cl_mask
        p_cl = p_cl / p_cl.sum(-1, keepdim=True)
        p_cl = p_cl / (1 + k_lin[..., None])
        p_spec = k_lin / (1 + k_lin)
        # LOS delay scaling (7.5-3/4)
        k_db_s = torch.where(is_los, k_db, 0.0)
        c_tau = 0.7705 - 0.0433 * k_db_s + 0.0002 * k_db_s ** 2 \
            + 0.000017 * k_db_s ** 3
        tau = torch.where(is_los[..., None],
                          tau / torch.clamp(c_tau[..., None], min=1e-3), tau)

        # cluster splitting (step 11): the two strongest clusters get
        # sub-delays {0, 1.28, 2.56} c_DS; unsplit clusters keep three
        # equal sub-delays, so the three ray subsets sum to the cluster
        if self.cluster_split:
            order = torch.argsort(-p_cl, dim=-1, stable=True)
            ranks = torch.argsort(order, dim=-1, stable=True)
            is_split = ((ranks < 2) & (cl_mask > 0)).float()
        else:
            is_split = torch.zeros_like(p_cl)
        c_ds_s = per_state("c_ds_ns") * 1e-9
        sub_off = torch.as_tensor(SUBCLUSTER_DELAY_OFFSETS, device=dev)
        tau_sub = tau[..., None] + (is_split * c_ds_s[..., None])[..., None] \
            * sub_off  # [b, T, NC, 3]
        ray_sub = torch.as_tensor(RAY_SUBCLUSTER, device=dev)  # [NR, 3]

        # azimuths (step 7, wrapped Gaussian)
        c_phi = sel(
            _C_PHI.get(pl["num_clusters"], 0.779)
            * (1.1035 - 0.028 * k_db_s - 0.002 * k_db_s ** 2
               + 0.0001 * k_db_s ** 3),
            torch.full_like(k_db_s, _C_PHI.get(pn["num_clusters"], 0.889)))
        pmax = p_cl.amax(-1, keepdim=True)
        neg_log = torch.clamp(-torch.log(
            p_cl / torch.clamp(pmax, min=1e-12) + 1e-12), min=0.0)

        def spread_angles(raw, center, spread, name):
            # random sign X_n, Gaussian Y_n ~ N(0, (spread/7)^2), center
            yn = (spread[..., None] / 7.0) * d["y_" + name]
            return d["sign_" + name] * raw + yn + center[..., None]

        def azimuths(center, spread, name):
            raw = 2 * (spread[..., None] / 1.4) * torch.sqrt(neg_log) \
                / torch.clamp(c_phi[..., None], min=1e-6)
            return spread_angles(raw, center, spread, name)

        offs = torch.as_tensor(RAY_OFFSETS, dtype=torch.float32, device=dev)
        phi_aoa_r = azimuths(phi_los_aoa, asa, "aoa")[..., None] \
            + c_asa[..., None, None] * offs
        phi_aod_r = azimuths(phi_los_aod, asd, "aod")[..., None] \
            + c_asd[..., None, None] * offs

        # zeniths (step 7b, inverse Laplacian)
        c_th = sel(
            _C_THETA.get(pl["num_clusters"], 1.104)
            * (1.3086 + 0.0339 * k_db_s - 0.0077 * k_db_s ** 2
               + 0.0002 * k_db_s ** 3),
            torch.full_like(k_db_s, _C_THETA.get(pn["num_clusters"], 1.184)))

        def zeniths(center, spread, name):
            raw = spread[..., None] * neg_log \
                / torch.clamp(c_th[..., None], min=1e-6)
            return spread_angles(raw, center, spread, name)

        th_zoa_r = mirror_zenith(
            zeniths(th_los_zoa, zsa, "zoa")[..., None]
            + c_zsa[..., None, None] * offs)
        th_zod_r = mirror_zenith(
            zeniths(th_los_zod + zod_off, zsd, "zod")[..., None]
            + (3.0 / 8.0) * (10 ** mu_lg_zsd)[..., None, None] * offs)
        sin_zoa_r = torch.sin(torch.deg2rad(th_zoa_r))
        sin_zod_r = torch.sin(torch.deg2rad(th_zod_r))

        # coupling phases and XPR (steps 9-10): the BS's +-45 degree slants
        # see cos45 (m_tt +- m_pt) of a vertical UT element
        ph = d["ph"]
        xpr_db = xpr_mu[..., None, None] + xpr_sig[..., None, None] \
            * d["xpr"]
        sq = torch.sqrt(10 ** (-xpr_db / 10))
        m_tt = _phase(ph[..., 0])
        m_pt = sq * _phase(ph[..., 2])
        c45 = 1 / np.sqrt(2)
        amp_p = c45 * (m_tt + m_pt)
        amp_m = c45 * (m_tt - m_pt)

        # array responses: BS ULA columns over sin(zenith) sin(azimuth)
        # with the element pattern, UT ULA over the departure angles
        d_ant = 0.5
        col_idx = torch.arange(self.num_bs_cols, device=dev)
        steer_bs = _phase(
            2 * np.pi * d_ant * col_idx * (
                sin_zoa_r * torch.sin(torch.deg2rad(phi_aoa_r)))[..., None])
        steer_bs = steer_bs * (10 ** (_bs_element_gain_db(
            phi_aoa_r, th_zoa_r) / 20.0))[..., None]
        ut_idx = torch.arange(self.num_tx_ant, device=dev)
        steer_ut = _phase(
            2 * np.pi * d_ant * ut_idx * (
                sin_zod_r * torch.sin(torch.deg2rad(phi_aod_r)))[..., None])

        # Doppler of the moving UT across the slot
        t = torch.arange(num_symbols, dtype=torch.float32,
                         device=dev) * symbol_duration
        doppler = (speed[..., None, None] / self.wavelength) * sin_zod_r \
            * torch.cos(torch.deg2rad(phi_aod_r) - v_dir[..., None, None])
        ray_t = _phase(2 * np.pi * doppler[..., None] * t)  # [.., NR, sym]

        # per-cluster ray sums into sub-cluster taps
        p_ray = torch.sqrt(p_cl[..., None] / nr)  # [b, T, NC, 1]

        def taps(amp):
            w = (p_ray * amp)[..., None] * ray_t  # [b, T, NC, NR, sym]
            return torch.einsum("btcrs,rk,btcrm,btcrn->btkcsmn", w,
                                ray_sub.to(w.dtype), steer_bs, steer_ut)

        # LOS specular ray on the first cluster's delay
        sin_zoa_los = torch.sin(torch.deg2rad(th_los_zoa))
        sin_zod_los = torch.sin(torch.deg2rad(th_los_zod))
        los_bs = _phase(2 * np.pi * d_ant * col_idx * (
            sin_zoa_los * torch.sin(torch.deg2rad(phi_los_aoa)))[..., None]) \
            * (10 ** (_bs_element_gain_db(phi_los_aoa, th_los_zoa)
                      / 20.0))[..., None]
        los_ut = _phase(2 * np.pi * d_ant * ut_idx * (
            sin_zod_los * torch.sin(torch.deg2rad(phi_los_aod)))[..., None])
        dop_los = (speed / self.wavelength) * sin_zod_los \
            * torch.cos(torch.deg2rad(phi_los_aod) - v_dir)
        los_t = _phase(d["los_phase"][..., None]
                       + 2 * np.pi * dop_los[..., None] * t)
        los_amp = torch.sqrt(p_spec)[..., None] * los_t  # [b, T, sym]

        # onto the subcarriers: the phase -2 pi f tau in the JAX package's
        # rounding order, (fl32(-2 pi) f) tau
        f = (torch.arange(num_sc, dtype=torch.float32, device=dev)
             - (num_sc - 1) / 2.0) * subcarrier_spacing
        w_f = f * float(np.float32(-2 * np.pi))
        phase = _phase(w_f * tau_sub[..., None])  # [b, T, NC, 3, sc]
        los_ph = _phase(w_f * tau[..., 0][..., None])  # [b, T, sc]

        def to_cfr(amp, sign):
            h = torch.einsum("btkcsmn,btckf->btsmnf", taps(amp), phase)
            los_tap = torch.einsum("bts,btm,btn->btsmn", los_amp,
                                   los_bs * (sign * c45), los_ut)
            return h + torch.einsum("btsmn,btf->btsmnf", los_tap, los_ph)

        h = to_cfr(amp_p, 1.0)  # [b, T, sym, cols, ut, sc]
        if self.bs_dual_pol:
            # rx antennas interleave the polarisations: [col0+, col0-, ...]
            h = torch.stack([h, to_cfr(amp_m, -1.0)], dim=4)
            h = h.reshape(h.shape[:3] + (self.num_bs_cols * 2,)
                          + h.shape[5:])
        h = h.permute(0, 3, 1, 4, 2, 5)  # [b, rx, T, ut, sym, sc]
        if self.normalize:
            mp = (h.abs() ** 2).mean(dim=(1, 3, 4, 5), keepdim=True)
            h = h / torch.sqrt(mp).to(h.dtype)
        return h.to(torch.complex64)

    def __call__(self, generator: torch.Generator, batch_size: int,
                 num_tx: int, num_symbols: int, num_sc: int,
                 subcarrier_spacing: float) -> torch.Tensor:
        """`cfr` of fresh draws."""
        return self.cfr(self.draw(generator, batch_size, num_tx),
                        num_symbols, num_sc, subcarrier_spacing)
