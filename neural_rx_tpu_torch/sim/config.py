"""Experiment configuration: INI parsing + PUSCH grid assembly.

The port's counterpart of `neural_rx_tpu/sim/config.py:Parameters`, cut to
what the serving and eval paths read: the config fields, the per-(MCS, UE)
`PUSCHConfig`s, the shared resource grid, one `PUSCHTransmitter` per MCS,
the noise-variance rule of the JAX package's `sim/e2e.py` (per batch item
in training, with the rate shift of masked pilots), and the channel model:
TDL-B100, TDL-C300, DoubleTDL{low,medium,high}, the 38.901 UMi and UMa
(the training channel of most configurations), the site-specific CIR
dataset (`channel.dataset.DatasetChannel`, read from
`{data_dir}/{tfrecord_filename}`, data_dir the repository's `data/` unless
the caller names another; an absolute `tfrecord_filename` override names
the file itself) and AWGN. The [training] section's keys (`training_schedule`,
`mcs_training_probs`, `mcs_training_snr_db_offset`, `eval_ebno_db_arr`)
are attributes, the optional two None where a file lacks them. A carrier
frequency offset (`cfo_offset_ppm` > 0) becomes `frequency_offset`, a
`channel.cfo.FrequencyOffset` relative to the bandwidth, constant at eval
and drawn per user in training, as in the JAX package (None without one).

Values are parsed with `ast.literal_eval`. `X_eval` keys override `X` when
training=False, so `nrx_rt` serves 132 PRB (1584 subcarriers) in eval mode
and trains on 4 PRB (48 subcarriers); the caller's `overrides` come after
them (the JAX package's 1-UE TDL evaluation slices set `channel_type` so).
"""

from __future__ import annotations

import ast
import configparser
import math
import os

import torch

from ..channel.cfo import FrequencyOffset
from ..channel.dataset import DatasetChannel
from ..channel.double_tdl import DoubleTDLChannel
from ..channel.tdl import TDLChannel
from ..channel.tr38901 import UMiUMaChannel
from ..phy.nr.dmrs import DMRSConfig
from ..phy.misc import ebnodb2no
from ..phy.nr.pusch import CarrierConfig, PUSCHConfig
from ..phy.nr.transmitter import PUSCHTransmitter

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
# where the site-specific configurations' CIR datasets live by default
DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")

_EVAL_OVERRIDES = ["channel_type", "n_size_bwp", "max_ut_velocity",
                   "min_ut_velocity", "channel_norm", "cfo_offset_ppm",
                   "tfrecord_filename", "random_subsampling"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16,
           "torch.float32": torch.float32, "tf.float32": torch.float32,
           "torch.float16": torch.float16}


def _parse_value(raw: str):
    raw = raw.strip()
    if raw in _DTYPES:
        return _DTYPES[raw]
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw  # bare string


class Parameters:
    """Parsed configuration plus the PUSCH configs and resource grid.

    system: 'nrx', 'baseline_*', or 'dummy' (parse only: no component is
    built). overrides: {key: value} set after the file is parsed and
    before any component is built; a key the configuration lacks raises
    KeyError (`cir_max_records`, the Dataset channel's cap on records,
    -1 by default, is one). pusch_configs: [mcs][ue] PUSCHConfig;
    transmitters: one per MCS; resource_grid: the grid of the first MCS
    (identical across MCS). data_dir: where the Dataset channel's files
    are (default `DATA_DIR`).
    """

    def __init__(self, config_name: str, system: str = "nrx",
                 training: bool = False, num_tx_eval: int | None = None,
                 config_dir: str | None = None,
                 overrides: dict | None = None,
                 data_dir: str | None = None):
        if not config_name.endswith(".cfg"):
            config_name += ".cfg"
        path = os.path.join(config_dir or CONFIG_DIR, config_name)
        cp = configparser.ConfigParser(inline_comment_prefixes=("#",))
        with open(path) as f:
            cp.read_string(f.read())

        self.system = system
        self.training = training
        for section in cp.sections():
            for key, raw in cp[section].items():
                setattr(self, key, _parse_value(raw))

        if not training:
            for name in _EVAL_OVERRIDES:
                ev = name + "_eval"
                if hasattr(self, ev):
                    setattr(self, name, getattr(self, ev))
        self.cir_max_records = -1
        for key, value in (overrides or {}).items():
            if not hasattr(self, key):
                raise KeyError(f"unknown Parameters override: {key}")
            setattr(self, key, value)
        if not hasattr(self, "mcs_var_mcs_masking"):
            self.mcs_var_mcs_masking = False
        if not hasattr(self, "random_subsampling"):
            self.random_subsampling = True
        for name in ("mcs_training_probs", "mcs_training_snr_db_offset"):
            if not hasattr(self, name):
                setattr(self, name, None)
        if system == "dummy":
            return

        carrier = CarrierConfig(
            n_cell_id=self.n_cell_id, cyclic_prefix=self.cyclic_prefix,
            subcarrier_spacing=float(self.subcarrier_spacing),
            n_size_grid=self.n_size_bwp, n_start_grid=self.n_start_grid,
            slot_number=self.slot_number, frame_number=self.frame_number,
            carrier_frequency=float(self.carrier_frequency))
        self.carrier = carrier

        if self.num_nrx_iter_eval > self.num_nrx_iter:
            raise ValueError("num_nrx_iter_eval must be <= num_nrx_iter")

        if not training:
            if num_tx_eval is None:
                num_tx_eval = len(self.dmrs_port_sets)
            self.max_num_tx = num_tx_eval
            self.min_num_tx = num_tx_eval
        port_sets = self.dmrs_port_sets[:self.max_num_tx]

        self.pusch_configs = []  # [mcs][ue]
        for mcs in self.mcs_index:
            per_ue = []
            for ue, ports in enumerate(port_sets):
                dmrs = DMRSConfig(
                    config_type=self.dmrs_config_type,
                    type_a_position=self.dmrs_type_a_position,
                    additional_position=self.dmrs_additional_position,
                    length=self.dmrs_length,
                    dmrs_port_set=tuple(ports), n_scid=self.n_scid,
                    num_cdm_groups_without_data=(
                        self.num_cdm_groups_without_data),
                    n_id=tuple(self.dmrs_nid[ue]),
                    mapping_type=self.dmrs_mapping_type)
                per_ue.append(PUSCHConfig(
                    carrier, dmrs, mcs_index=mcs, mcs_table=self.mcs_table,
                    num_antenna_ports=self.num_antenna_ports,
                    precoding=self.precoding, tpmi=self.tpmi,
                    symbol_allocation=tuple(self.symbol_allocation),
                    n_rnti=self.n_rntis[ue], n_id=self.n_ids[ue],
                    num_bp_iter=self.num_bp_iter, cn_type=self.cn_type))
            self.pusch_configs.append(per_ue)
        self.transmitters = [PUSCHTransmitter(per_ue)
                             for per_ue in self.pusch_configs]
        self.resource_grid = self.transmitters[0].resource_grid
        self._channel(carrier, data_dir or DATA_DIR)

    def _channel(self, carrier, data_dir: str):
        """channel_model, channel_num_tx, channel_type_name and
        frequency_offset (JAX `Parameters.__init__`'s channel section)."""
        ct = self.channel_type
        ports = self.pusch_configs[0][0].num_antenna_ports
        self.channel_model = None
        self.channel_num_tx = None
        if ct in ("TDL-B100", "TDL-C300"):
            model, spread = ("B", 100e-9) if ct == "TDL-B100" else ("C",
                                                                    300e-9)
            self.channel_model = TDLChannel(
                model, spread, carrier.carrier_frequency,
                min_speed=self.min_ut_velocity,
                max_speed=self.max_ut_velocity,
                num_rx_ant=self.num_rx_antennas, num_tx_ant=ports,
                normalize=self.channel_norm)
            self.channel_num_tx = 1
        elif ct.startswith("DoubleTDL"):
            self.channel_model = DoubleTDLChannel(
                carrier.carrier_frequency, num_rx_ant=self.num_rx_antennas,
                num_tx_ant=ports, norm_channel=self.channel_norm,
                correlation=ct[len("DoubleTDL"):])
            self.channel_num_tx = 2
        elif ct in ("UMi", "UMa"):
            self.channel_model = UMiUMaChannel(
                ct.lower(), carrier.carrier_frequency,
                num_rx_ant=self.num_rx_antennas, num_tx_ant=ports,
                min_speed=self.min_ut_velocity,
                max_speed=self.max_ut_velocity,
                normalize=self.channel_norm)
        elif ct == "Dataset":
            self.channel_model = DatasetChannel(
                os.path.join(data_dir, self.tfrecord_filename),
                training=self.training, num_tx=self.max_num_tx,
                random_subsampling=self.random_subsampling,
                num_rx_ant=self.num_rx_antennas, num_tx_ant=ports,
                max_num_examples=self.cir_max_records)
        elif ct != "AWGN":
            raise ValueError(f"Unknown channel type {ct}")
        self.channel_type_name = ct
        self.frequency_offset = None
        if self.cfo_offset_ppm > 0:
            offset = carrier.carrier_frequency / 1e6 * self.cfo_offset_ppm
            self.frequency_offset = FrequencyOffset(
                offset / (self.resource_grid.num_subcarriers
                          * carrier.subcarrier_spacing),
                cp_length=0, constant_offset=not self.training)

    def noise_variance(self, ebno_db, mcs_idx: int = 0):
        """N0 for an Eb/N0 (or, with ebno=False, an SNR) in dB, for the
        transmitter of MCS `mcs_idx` (`sim/e2e.py:_noise_variance` of the
        JAX package): rate-adjusted, with the resource-grid overhead
        (pilots and CP) in the energy per bit, and with masked pilots the
        Eb/N0 shifted by the share of pilot REs, which carry no energy.
        ebno_db: a number (a float N0) or a float32 tensor of one Eb/N0 per
        batch item (a tensor)."""
        if not self.ebno:
            return 10.0 ** (-ebno_db / 10.0)
        tx = self.transmitters[mcs_idx]
        rg = tx.resource_grid
        if self.mask_pilots:
            ebno_db = ebno_db - 10.0 * math.log10(
                1.0 - rg.num_pilot_symbols / rg.num_resource_elements)
        return ebnodb2no(ebno_db, tx.num_bits_per_symbol,
                         tx.target_coderate,
                         rg.num_resource_elements * (1.0 + rg.cp_overhead),
                         rg.num_data_symbols)
