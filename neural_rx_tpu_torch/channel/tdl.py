"""3GPP TR 38.901 §7.7.2 TDL channel models in the frequency domain.

The port's copy of `neural_rx_tpu/channel/tdl.py`. The CFR of a whole slot
is made directly in the frequency domain: per-tap Rayleigh processes with
the Jakes Doppler spectrum (32 sinusoids) evolved across the OFDM symbols,
a Rician line-of-sight ray on the first tap of TDL-D/E, spatial
correlation by matrix square roots of the antenna correlation matrices,
then a projection onto the subcarriers by a static [taps, sc] phase
matrix. Tap powers are normalised to unit total power; each batch item
draws a speed uniformly in [min_speed, max_speed].

The random draws and the arithmetic are separate: `draw` takes a
`torch.Generator` and returns (speed, alpha, phi, los_phase); `cfr` is
deterministic, so a test can feed it the JAX package's own draws. The
static tables (phase matrix, correlation square roots, tap amplitudes) are
uploaded once per (num_sc, spacing, device).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0

# TR 38.901 Table 7.7.2-1..5: (normalized delays, powers [dB])
TDL_PROFILES = {
    "A": (
        [0.0000, 0.3819, 0.4025, 0.5868, 0.4610, 0.5375, 0.6708, 0.5750,
         0.7618, 1.5375, 1.8978, 2.2242, 2.1718, 2.4942, 2.5119, 3.0582,
         4.0810, 4.4579, 4.5695, 4.7966, 5.0066, 5.3043, 9.6586],
        [-13.4, 0.0, -2.2, -4.0, -6.0, -8.2, -9.9, -10.5, -7.5, -15.9,
         -6.6, -16.7, -12.4, -15.2, -10.8, -11.3, -12.7, -16.2, -18.3,
         -18.9, -16.6, -19.9, -29.7],
    ),
    "B": (
        [0.0000, 0.1072, 0.2155, 0.2095, 0.2870, 0.2986, 0.3752, 0.5055,
         0.3681, 0.3697, 0.5700, 0.5283, 1.1021, 1.2756, 1.5474, 1.7842,
         2.0169, 2.8294, 3.0219, 3.6187, 4.1067, 4.2790, 4.7834],
        [0.0, -2.2, -4.0, -3.2, -9.8, -1.2, -3.4, -5.2, -7.6, -3.0, -8.9,
         -9.0, -4.8, -5.7, -7.5, -1.9, -7.6, -12.2, -9.8, -11.4, -14.9,
         -9.2, -11.3],
    ),
    "C": (
        [0.0000, 0.2099, 0.2219, 0.2329, 0.2176, 0.6366, 0.6448, 0.6560,
         0.6584, 0.7935, 0.8213, 0.9336, 1.2285, 1.3083, 2.1704, 2.7105,
         4.2589, 4.6003, 5.4902, 5.6077, 6.3065, 6.6374, 7.0427, 8.6523],
        [-4.4, -1.2, -3.5, -5.2, -2.5, 0.0, -2.2, -3.9, -7.4, -7.1, -10.7,
         -11.1, -5.1, -6.8, -8.7, -13.2, -13.9, -13.9, -15.8, -17.1, -16.0,
         -15.7, -21.6, -22.8],
    ),
    # D/E: the first tap carries a LOS ray with the K-factor below
    "D": (
        [0.0, 0.035, 0.612, 1.363, 1.405, 1.804, 2.596, 1.775, 4.042,
         7.937, 9.424, 9.708, 12.525],
        [-0.2, -13.5, -18.8, -21.0, -22.8, -17.9, -20.1, -21.9, -22.9,
         -27.8, -23.6, -24.8, -30.0],
    ),
    "E": (
        [0.0, 0.5133, 0.5440, 0.5630, 0.5440, 0.7112, 1.9092, 1.9293,
         1.9589, 2.6426, 3.7136, 5.4524, 12.0034, 20.6519],
        [-0.03, -22.03, -15.8, -18.1, -19.8, -22.9, -22.4, -18.6, -20.8,
         -22.6, -20.3, -24.6, -20.7, -32.4],
    ),
}
# LOS first-tap Rician K-factors [dB] for D/E
TDL_LOS_K = {"D": 13.3, "E": 22.0}
_NUM_SINUSOIDS = 32


def _corr_sqrt(mat: np.ndarray) -> np.ndarray:
    """Hermitian PSD matrix square root (eigh-based, NumPy)."""
    w, v = np.linalg.eigh(mat)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)[None, :]) @ v.conj().T


def exp_correlation_matrix(num_ant: int, a: float) -> np.ndarray:
    """38.901 exponential correlation: Toeplitz with first row a**exponents
    (exponents spaced quadratically for 4/8 antennas)."""
    if num_ant not in (1, 2, 4, 8):
        raise ValueError(f"1, 2, 4 or 8 antennas, got {num_ant}")
    exponents = {
        1: [0.0], 2: [0.0, 1.0], 4: [0.0, 1 / 9, 4 / 9, 1.0],
        8: [0.0, 1 / 49, 4 / 49, 9 / 49, 16 / 49, 25 / 49, 36 / 49, 1.0],
    }[num_ant]
    row = np.power(float(a), exponents).astype(np.complex128)
    n = num_ant
    mat = np.empty((n, n), np.complex128)
    for i in range(n):
        for j in range(n):
            mat[i, j] = row[abs(i - j)] if j >= i else np.conj(
                row[abs(i - j)])
    return mat


def _uniform(generator: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


class TDLChannel:
    """One TDL link (one UE): CFRs of a 14-symbol slot.

    model letter, delay spread [s], carrier frequency [Hz], speed range
    [m/s], antenna counts, optional rx/tx correlation matrices; normalize:
    scale each batch item's CFR to unit mean power.
    """

    def __init__(self, model: str, delay_spread: float,
                 carrier_frequency: float, min_speed: float = 0.0,
                 max_speed: float | None = None, num_rx_ant: int = 4,
                 num_tx_ant: int = 2, rx_corr: np.ndarray | None = None,
                 tx_corr: np.ndarray | None = None,
                 normalize: bool = False):
        delays_n, powers_db = TDL_PROFILES[model]
        self.model = model
        self.delays = np.asarray(delays_n, np.float64) * delay_spread
        p = 10.0 ** (np.asarray(powers_db, np.float64) / 10.0)
        self.powers = (p / p.sum()).astype(np.float32)
        self.k_factor_db = TDL_LOS_K.get(model)
        self.num_taps = len(self.delays)
        self.carrier_frequency = carrier_frequency
        self.min_speed = float(min_speed)
        self.max_speed = float(max_speed if max_speed is not None
                               else min_speed)
        self.num_rx_ant = num_rx_ant
        self.num_tx_ant = num_tx_ant
        self.normalize = normalize
        self._rx_sqrt = (_corr_sqrt(rx_corr).astype(np.complex64)
                         if rx_corr is not None else None)
        self._tx_sqrt = (_corr_sqrt(tx_corr).astype(np.complex64)
                         if tx_corr is not None else None)
        self._tables: dict = {}

    def phase_matrix(self, num_sc: int, subcarrier_spacing: float
                     ) -> np.ndarray:
        """Static [num_taps, num_sc] tap->subcarrier projection
        exp(-j 2 pi f_k tau_l) with centered subcarrier frequencies."""
        f = (np.arange(num_sc) - (num_sc - 1) / 2.0) * subcarrier_spacing
        return np.exp(-2j * np.pi * f[None, :] * self.delays[:, None]
                      ).astype(np.complex64)

    def _device_tables(self, num_sc: int, subcarrier_spacing: float,
                       device: torch.device) -> dict:
        key = (num_sc, float(subcarrier_spacing), device)
        if key not in self._tables:
            def t(a):
                return None if a is None else torch.as_tensor(a,
                                                              device=device)
            self._tables[key] = {
                "pm": t(self.phase_matrix(num_sc, subcarrier_spacing)),
                "amp": torch.sqrt(t(self.powers)),
                "rx_sqrt": t(self._rx_sqrt), "tx_sqrt": t(self._tx_sqrt)}
        return self._tables[key]

    def draw(self, generator: torch.Generator, batch_size: int):
        """(speed [b], alpha [b, rx, tx, taps, 32], phi [same], los_phase
        [b] or None), float32 on the generator's device, drawn in that
        order: uniform speed in [min, max(max, min + 1e-9)), arrival angle
        and phase of each sinusoid in [-pi, pi), and for D/E the LOS
        phase in [-pi, pi)."""
        shape = (batch_size, self.num_rx_ant, self.num_tx_ant,
                 self.num_taps, _NUM_SINUSOIDS)
        speed = _uniform(generator, (batch_size,), self.min_speed,
                         max(self.max_speed, self.min_speed + 1e-9))
        alpha = _uniform(generator, shape, -math.pi, math.pi)
        phi = _uniform(generator, shape, -math.pi, math.pi)
        los_phase = None
        if self.k_factor_db is not None:
            los_phase = _uniform(generator, (batch_size,), -math.pi, math.pi)
        return speed, alpha, phi, los_phase

    def cfr(self, draws, num_symbols: int, num_sc: int,
            subcarrier_spacing: float,
            symbol_duration: float | None = None) -> torch.Tensor:
        """CFRs h [batch, num_rx_ant, num_tx_ant, num_symbols, num_sc]
        complex64 from `draw`'s draws, on their device."""
        speed, alpha, phi, los_phase = draws
        if symbol_duration is None:
            symbol_duration = 1.0 / subcarrier_spacing
        tb = self._device_tables(num_sc, subcarrier_spacing, speed.device)
        fd = speed * self.carrier_frequency / SPEED_OF_LIGHT  # [b]
        t = torch.arange(num_symbols, dtype=torch.float32,
                         device=speed.device) * symbol_duration
        # theta [b, rx, tx, taps, sinusoid, sym]
        doppler = 2.0 * math.pi * fd[:, None, None, None, None] \
            * torch.cos(alpha)
        theta = doppler[..., None] * t + phi[..., None]
        # g = (1/sqrt(32)) sum_n exp(j theta_n): unit-power Rayleigh taps
        # with the Jakes autocorrelation J0(2 pi fd dt); [b, rx, tx, l, sym]
        g = torch.exp(1j * theta.to(torch.complex64)).sum(dim=-2) \
            / np.sqrt(_NUM_SINUSOIDS)
        if self.k_factor_db is not None:
            # deterministic LOS ray, AoA = 0 -> Doppler shift fd
            k_lin = 10.0 ** (self.k_factor_db / 10.0)
            los = torch.exp(1j * (los_phase[:, None] + 2.0 * math.pi
                                  * fd[:, None] * t).to(torch.complex64))
            g0 = (np.sqrt(k_lin / (k_lin + 1)) * los[:, None, None, :]
                  + np.sqrt(1.0 / (k_lin + 1)) * g[:, :, :, 0, :])
            g = torch.cat([g0[:, :, :, None], g[:, :, :, 1:]], dim=3)
        # spatial correlation; the tx factor applies tx_sqrt[k, x] as given
        if tb["rx_sqrt"] is not None:
            g = torch.einsum("ij,bjxls->bixls", tb["rx_sqrt"], g)
        if tb["tx_sqrt"] is not None:
            g = torch.einsum("kx,bjxls->bjkls", tb["tx_sqrt"], g)
        g = g * tb["amp"][:, None]
        # [b, rx, tx, sym, taps] @ [taps, sc]
        h = torch.matmul(g.transpose(-1, -2), tb["pm"])
        if self.normalize:
            mean_pow = (h.abs() ** 2).mean(dim=(1, 2, 3, 4), keepdim=True)
            h = h / torch.sqrt(mean_pow).to(h.dtype)
        return h

    def __call__(self, generator: torch.Generator, batch_size: int,
                 num_symbols: int, num_sc: int, subcarrier_spacing: float
                 ) -> torch.Tensor:
        """`cfr` of fresh draws: [batch, rx, tx, num_symbols, num_sc]."""
        return self.cfr(self.draw(generator, batch_size), num_symbols, num_sc,
                        subcarrier_spacing)
