"""Batched L2 burst decode: symbols -> RS-corrected octets.

Port of ``dumpvdl2_tpu/fec/l2_tpu.py``: the bit-level decode chain of
the reference's ``decode_vdl2_burst`` (decode.c:196-380) for a batch of
candidate bursts,

    symbols -> bits -> PRBS descramble (XOR) -> (25,20) header FEC
    -> transmission length / RS geometry -> octet packing
    -> deinterleave (gather) -> batched RS(255,249).

The JAX package compiles the chain into one executable; here it is
two kernels (fec/l2_kernel.py): L2H, the header and geometry, and L2P,
octet packing, deinterleave and RS decode, behind the hdr-ok
compaction when the batch is capped.  (The sliced step,
core/pipeline.l2_sliced, runs L2H's front kernel in place of the
header and then :func:`decode_payload`.)
HDLC unstuffing and CRC stay on the host (burst._result_from_batch).
Every shape is static; rejected rows decode with fec_octets == 0 (a
no-op in RS).
"""
from __future__ import annotations

import torch

from .l2_kernel import l2_header, l2_payload, l2_payload_capped


def frame_power(power: torch.Tensor, hdr_ok: torch.Tensor,
                bits_consumed: torch.Tensor) -> torch.Tensor:
    """Mean per-symbol power over each burst's symbol count
    (decode.c:268-269), 0 where the header is rejected.  ``power`` (B, S)
    float32."""
    S = power.shape[1]
    total_syms = torch.clamp(-torch.div(-bits_consumed, 3,
                                        rounding_mode="floor"), min=1)
    sidx = torch.arange(S, dtype=torch.int32, device=power.device)
    msk = sidx[None, :] < total_syms[:, None]
    return torch.where(
        hdr_ok, (power * msk).sum(dim=1) / total_syms.to(torch.float32),
        0.0)


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
    symbols = symbols.contiguous()
    hdr = l2_header(symbols)
    frame_pwr = None if power is None else frame_power(
        power, hdr["hdr_ok"], hdr["bits_consumed"])
    return decode_payload(symbols, hdr, frame_pwr, rs_burst_cap)


def decode_payload(symbols: torch.Tensor, hdr: dict,
                    frame_pwr: torch.Tensor | None,
                    rs_burst_cap: int | None) -> dict:
    """L2P on L2H's results (``hdr``, its ``lf`` consumed), behind the
    hdr-ok compaction when ``rs_burst_cap`` is below the batch; the
    batch's result dict."""
    lf = hdr.pop("lf")
    geom = (hdr["hdr_ok"], hdr["num_blocks"], hdr["last_len"], lf,
            hdr["datalen_octets"])
    extra = {}
    if rs_burst_cap is not None and rs_burst_cap < symbols.shape[0]:
        blocks, counts, fec_row, extra["blocks_row"] = l2_payload_capped(
            symbols, rs_burst_cap, *geom)
    else:
        blocks, counts, fec_row = l2_payload(symbols, *geom)
    if frame_pwr is not None:
        extra["frame_pwr"] = frame_pwr
    return {
        **extra, **hdr,
        "blocks": blocks, "counts": counts, "fec_row": fec_row,
    }

