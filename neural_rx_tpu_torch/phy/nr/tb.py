"""Transport-block encoder/decoder, 38.212 §5.2.2/§6.2 + scrambling.

The port's copy of `neural_rx_tpu/phy/nr/tb.py`. Pipeline (static config
in NumPy, hot path in torch):
  TB CRC (16 / 24A) -> code-block segmentation (+CRC24B if C>1, filler
  bits) -> QC-LDPC encode -> rate matching per block -> concatenation ->
  scrambling (Gold, c_init = n_rnti*2^15 + n_id).

`tb_decode` hands all C code blocks of a transport block to the codeword
decoder in one call ([..., C, n_full]); the JAX package calls it once per
block. The decoder works per codeword, so the function is the same, and
the layered kernel (`kernels/ldpc.py`) then decodes a user's transport
block in one launch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ... import tables
from . import crc as crc_mod
from .ldpc import decode as ldpc_decode
from .ldpc import encode as ldpc_encode
from .ldpc import get_code
from .ldpc_tables import select_base_graph, select_lifting_size
from .rate_match import cb_bit_allocation, rate_match, rate_recover
from .sequences import pusch_scrambling_sequence

# decoder-internal LLRs are clipped to +-20 (the filler LLR's magnitude)
LLR_CLIP = 20.0


class TBConfig:
    """Static transport-block configuration for one (TBS, G) pair."""

    def __init__(self, tb_size: int, num_coded_bits: int, qm: int,
                 coderate: float, n_rnti: int = 1, n_id: int = 1,
                 num_layers: int = 1, num_bp_iter: int = 20,
                 cn_type: str = "boxplus"):
        self.tb_size = int(tb_size)  # A
        self.num_coded_bits = int(num_coded_bits)  # G
        self.qm = qm
        self.coderate = coderate
        self.n_rnti = n_rnti
        self.n_id = n_id
        self.num_layers = num_layers
        self.num_bp_iter = num_bp_iter
        self.cn_type = cn_type

        a = self.tb_size
        self.tb_crc = "CRC16" if a <= 3824 else "CRC24A"
        self.tb_crc_len = 16 if a <= 3824 else 24
        b = a + self.tb_crc_len

        self.bg = select_base_graph(a, coderate)
        k_cb = 8448 if self.bg == 1 else 3840
        if b <= k_cb:
            self.num_cbs = 1
            b_prime = b
            self.cb_crc_len = 0
        else:
            self.num_cbs = math.ceil(b / (k_cb - 24))
            b_prime = b + self.num_cbs * 24
            self.cb_crc_len = 24
        if b_prime % self.num_cbs:
            raise ValueError(f"TBS {a}: {b_prime} bits do not split into "
                             f"{self.num_cbs} equal code blocks")
        self.k_prime = b_prime // self.num_cbs

        if self.bg == 1:
            k_b = 22
        elif b > 640:
            k_b = 10
        elif b > 560:
            k_b = 9
        elif b > 192:
            k_b = 8
        else:
            k_b = 6
        self.z = select_lifting_size(self.k_prime, k_b)
        self.code = get_code(self.bg, self.z)
        self.k = self.code.k  # = k_b_graph * z (22Z / 10Z)
        self.num_filler = self.k - self.k_prime
        self.cb_es = cb_bit_allocation(self.num_coded_bits, self.num_cbs,
                                       qm, num_layers)
        self.scramb_seq = pusch_scrambling_sequence(
            n_rnti, n_id, self.num_coded_bits).astype(np.float32)


def _scrambling(cfg: TBConfig, device) -> torch.Tensor:
    return tables.on_device(("scrambling", cfg.n_rnti, cfg.n_id,
                             cfg.num_coded_bits), device,
                            lambda: cfg.scramb_seq)


def tb_codewords(cfg: TBConfig, bits: torch.Tensor) -> torch.Tensor:
    """bits [..., A] float {0,1} -> the LDPC codewords of its code blocks
    [..., C, num_cols*Z] (TB CRC, segmentation, CB CRC, filler, encode)."""
    b = crc_mod.crc_attach(bits, cfg.tb_crc)  # [..., B]
    blocks = b.reshape(b.shape[:-1] + (cfg.num_cbs, -1))
    if cfg.num_cbs > 1:
        blocks = crc_mod.crc_attach(blocks, "CRC24B")  # [..., C, K']
    filler = torch.zeros(blocks.shape[:-1] + (cfg.num_filler,),
                         dtype=blocks.dtype, device=blocks.device)
    info = torch.cat([blocks, filler], dim=-1)  # [..., C, K]
    return ldpc_encode(cfg.code, info)


def tb_encode(cfg: TBConfig, bits: torch.Tensor) -> torch.Tensor:
    """bits [..., A] float {0,1} -> scrambled coded bits [..., G]."""
    cw = tb_codewords(cfg, bits)  # [..., C, n_full]
    coded = torch.cat([rate_match(cfg.code, cw[..., r, :], cfg.k_prime,
                                  cfg.cb_es[r], cfg.qm)
                       for r in range(cfg.num_cbs)], dim=-1)  # [..., G]
    return torch.remainder(coded + _scrambling(cfg, bits.device), 2.0)


def codeword_llrs(cfg: TBConfig, llr: torch.Tensor) -> torch.Tensor:
    """llr [..., G] (Sionna convention log(p1/p0)) -> the decoder's input
    [..., C, num_cols*Z]: descrambled, in the internal log(p0/p1)
    convention, clipped to +-20, rate-recovered per code block."""
    # descramble: flip the LLR sign where the scrambling bit is 1, then
    # negate to the decoder-internal log(p0/p1) convention
    llr_int = -llr * (1.0 - 2.0 * _scrambling(cfg, llr.device))
    llr_int = torch.clamp(llr_int, -LLR_CLIP, LLR_CLIP)
    full, offset = [], 0
    for e_r in cfg.cb_es:
        full.append(rate_recover(cfg.code, llr_int[..., offset:offset + e_r],
                                 cfg.k_prime, cfg.qm))
        offset += e_r
    return torch.stack(full, dim=-2)


def tb_decode(cfg: TBConfig, llr: torch.Tensor, decoder=None):
    """llr [..., G] (Sionna convention log(p1/p0)) ->
    (b_hat [..., A], tb_crc_pass [...] bool).

    decoder: optional codeword decoder fn(llr_internal [..., n_full]) ->
    hard bits of the same shape, replacing the default flooding BP (the
    layered kernel's `tb_decode_fast` passes its own). It is called once,
    on all code blocks: [..., C, n_full].
    """
    if decoder is None:
        def decoder(full):
            return ldpc_decode(cfg.code, full, cfg.num_bp_iter, cfg.cn_type)
    hard = decoder(codeword_llrs(cfg, llr))  # [..., C, n_full]
    blocks = hard[..., :cfg.k_prime]  # drop filler + parity
    if cfg.num_cbs > 1:
        blocks = blocks[..., :-24]  # strip CB CRC
    b = blocks.reshape(blocks.shape[:-2] + (-1,))  # [..., B]
    tb_ok = crc_mod.crc_check(b, cfg.tb_crc)
    return b[..., :cfg.tb_size], tb_ok
