"""Batched L2 burst decode: symbols -> RS-corrected octets.

Port of ``dumpvdl2_tpu/fec/l2_tpu.py``: the bit-level decode chain of
the reference's ``decode_vdl2_burst`` (decode.c:196-380) for a batch of
candidate bursts,

    symbols -> bits -> PRBS descramble (XOR) -> (25,20) header FEC
    -> transmission length / RS geometry -> octet packing
    -> deinterleave (gather) -> batched RS(255,249).

The JAX package compiles the chain into one executable; here it is
two kernels (fec/l2_kernel.py: L2H header and geometry, L2P octet
packing, deinterleave and RS decode) with the burst compaction between
them and the frame power after them in plain PyTorch.
HDLC unstuffing and CRC stay on the host (burst._result_from_batch).
Every shape is static; rejected rows decode with fec_octets == 0 (a
no-op in RS).
"""
from __future__ import annotations

import torch

from .l2_kernel import l2_header, l2_payload


def l2_decode_batch(symbols: torch.Tensor, max_symbols: int,
                    power: torch.Tensor | None = None,
                    rs_burst_cap: int | None = None) -> dict:
    """Decode a batch of candidate bursts from their raw D8PSK symbols.

    Args:
      symbols: (B, S) uint8 gray-decoded 3-bit symbols, S == max_symbols.
      power: optional (B, S) float32 per-symbol power; when given, the
        output gains "frame_pwr" (B,), the mean power over each burst's
        symbol count (decode.c:268-269).
      rs_burst_cap: when set (< B), the payload stages run only for the
        first ``rs_burst_cap`` hdr-ok bursts; blocks/counts/fec_row then
        have rs_burst_cap rows and "blocks_row" maps burst index ->
        compacted row (-1 = overflow, reported by the host as
        decoder.errors.l2_overflow).
    Returns a dict of per-burst tensors (see dumpvdl2_tpu/fec/l2_tpu.py):
      syndrome, synd_weight, datalen, datalen_octets, num_blocks,
      last_len, bits_consumed (B,) int32; reserved_bad, too_long,
      no_fec, hdr_ok (B,) bool; blocks (B', 9, 255) uint8; counts,
      fec_row (B', 9) int32.
    """
    B, S = symbols.shape
    if S != max_symbols:
        raise ValueError(f"symbols have {S} columns, expected {max_symbols}")
    dev = symbols.device
    symbols = symbols.contiguous()
    hdr = l2_header(symbols)
    lf = hdr.pop("lf")
    hdr_ok = hdr["hdr_ok"]

    # ---- optional burst compaction before the payload stages ---------
    sel = blocks_row = None
    if rs_burst_cap is not None and rs_burst_cap < B:
        order = torch.argsort((~hdr_ok).to(torch.int32), stable=True)
        sel = order[:rs_burst_cap]
        blocks_row = torch.full((B,), -1, dtype=torch.int32, device=dev)
        blocks_row[sel] = torch.arange(rs_burst_cap, dtype=torch.int32,
                                       device=dev)
    blocks, counts, fec_row = l2_payload(symbols, sel, hdr_ok,
                                         hdr["num_blocks"], hdr["last_len"],
                                         lf, hdr["datalen_octets"])
    extra = {}
    if blocks_row is not None:
        extra["blocks_row"] = blocks_row
    if power is not None:
        bits_consumed = hdr["bits_consumed"]
        total_syms = torch.clamp(-torch.div(-bits_consumed, 3,
                                            rounding_mode="floor"), min=1)
        sidx = torch.arange(S, dtype=torch.int32, device=dev)
        msk = sidx[None, :] < total_syms[:, None]
        extra["frame_pwr"] = torch.where(
            hdr_ok, (power * msk).sum(dim=1) / total_syms.to(torch.float32),
            0.0)
    return {
        **extra, **hdr,
        "blocks": blocks, "counts": counts, "fec_row": fec_row,
    }
