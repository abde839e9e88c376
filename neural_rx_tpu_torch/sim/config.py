"""Experiment configuration: INI parsing + PUSCH grid assembly.

The port's counterpart of `neural_rx_tpu/sim/config.py:Parameters`, cut to
what the serving path reads: the `[system]` and `[neural_receiver]` fields,
the per-(MCS, UE) `PUSCHConfig`s and the shared resource grid. Channels,
transmitters and CFO belong to the eval chain.

Values are parsed with `ast.literal_eval`. `X_eval` keys override `X` when
training=False, so `nrx_rt` serves 132 PRB (1584 subcarriers) in eval mode
and trains on 4 PRB (48 subcarriers).
"""

from __future__ import annotations

import ast
import configparser
import os

import torch

from ..phy.grid import ResourceGrid
from ..phy.nr.dmrs import DMRSConfig
from ..phy.nr.pusch import CarrierConfig, PUSCHConfig

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")

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

    pusch_configs: [mcs][ue] PUSCHConfig; resource_grid: the grid of the
    first MCS (identical across MCS).
    """

    def __init__(self, config_name: str, training: bool = False,
                 num_tx_eval: int | None = None,
                 config_dir: str | None = None):
        if not config_name.endswith(".cfg"):
            config_name += ".cfg"
        path = os.path.join(config_dir or CONFIG_DIR, config_name)
        cp = configparser.ConfigParser(inline_comment_prefixes=("#",))
        with open(path) as f:
            cp.read_string(f.read())

        self.training = training
        for section in cp.sections():
            for key, raw in cp[section].items():
                setattr(self, key, _parse_value(raw))

        if not training:
            for name in _EVAL_OVERRIDES:
                ev = name + "_eval"
                if hasattr(self, ev):
                    setattr(self, name, getattr(self, ev))
        if not hasattr(self, "mcs_var_mcs_masking"):
            self.mcs_var_mcs_masking = False

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
                    n_rnti=self.n_rntis[ue], n_id=self.n_ids[ue]))
            self.pusch_configs.append(per_ue)
        self.resource_grid = ResourceGrid(self.pusch_configs[0])
