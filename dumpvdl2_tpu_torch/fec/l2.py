"""Batched L2 burst decode: symbols -> RS-corrected octets.

Port of ``dumpvdl2_tpu/fec/l2_tpu.py``: the bit-level decode chain of
the reference's ``decode_vdl2_burst`` (decode.c:196-380) for a batch of
candidate bursts,

    symbols -> bits -> PRBS descramble (XOR) -> (25,20) header FEC
    -> transmission length / RS geometry -> octet packing
    -> deinterleave (gather) -> batched RS(255,249) (fec/rs_batch.py).

HDLC unstuffing and CRC stay on the host (burst._result_from_batch).
Every shape is static; rejected rows decode with fec_octets == 0 (a
no-op in rs_verify_batch).  Header arithmetic is int32, as in the JAX
code.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import (HDRFECLEN, HEADER_LEN, MAX_FRAME_LENGTH,
                         MAX_FRAME_LENGTH_CORRECTED, RS_K, RS_N, TRLEN)
from .header import H_ROWS, SYND_WEIGHT, SYNDTABLE
from .rs_batch import rs_verify_batch
from .scramble import PRBS

# Worst-case burst geometry (decode.c:45-48): datalen <= 0x3FFF bits
# -> 2048 data octets -> 9 RS blocks -> 8*6+4 = 52 FEC octets.
MAX_DATA_OCT = (MAX_FRAME_LENGTH + 7) // 8              # 2048
MAX_BLOCKS = -(-MAX_DATA_OCT // RS_K)                   # 9
MAX_TOTAL_OCT = MAX_DATA_OCT + (MAX_BLOCKS - 1) * (RS_N - RS_K) + 4  # 2100


@functools.lru_cache(maxsize=4)
def _tables(device: torch.device) -> dict[str, torch.Tensor]:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)
    return {"synd": t(SYNDTABLE), "weight": t(SYND_WEIGHT),
            "prbs": t(PRBS)}


def _parity32(v: torch.Tensor) -> torch.Tensor:
    """Bitwise parity of each int32 element (shift/xor fold)."""
    v = v ^ (v >> 16)
    v = v ^ (v >> 8)
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    return v & 1


def _fec_octetcount(last_len: torch.Tensor) -> torch.Tensor:
    """get_fec_octetcount (decode.c:124-133) as nested selects."""
    return torch.where(last_len < 3, 0,
                       torch.where(last_len < 31, 2,
                                   torch.where(last_len < 68, 4, 6)))


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


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
    tb = _tables(dev)
    nbits = 3 * S

    # symbols -> bits (MSB of each 3-bit symbol first, demod.c:274)
    shifts = torch.tensor([2, 1, 0], dtype=torch.int32, device=dev)
    bits = ((_i32(symbols)[:, :, None] >> shifts) & 1).reshape(B, nbits)
    clear = bits ^ tb["prbs"][None, :nbits]

    # ---- (25,20) header FEC (decode.c:111-122) ----------------------
    w_hdr = 1 << torch.arange(HEADER_LEN - 1, -1, -1, dtype=torch.int32,
                              device=dev)
    word = (clear[:, :HEADER_LEN] * w_hdr[None, :]).sum(dim=1,
                                                        dtype=torch.int32)
    word = word & ((1 << (TRLEN + HDRFECLEN)) - 1)      # zero reserved bits
    synd = torch.zeros_like(word)
    for i, row in enumerate(H_ROWS):
        synd = synd | (_parity32(word & row) << (HDRFECLEN - 1 - i))
    corrected = word ^ tb["synd"][synd.long()]
    weight = tb["weight"][synd.long()]
    reserved_bad = (corrected >> (TRLEN + HDRFECLEN)) != 0

    trfield = (corrected >> HDRFECLEN) & ((1 << TRLEN) - 1)
    datalen = torch.zeros_like(trfield)
    for i in range(TRLEN):                              # bit-reverse TRLEN
        datalen = datalen | (((trfield >> i) & 1) << (TRLEN - 1 - i))
    too_long = ((synd != 0) & (datalen > MAX_FRAME_LENGTH_CORRECTED)) \
        | (datalen > MAX_FRAME_LENGTH)

    # ---- geometry (burst_geometry / decode.c:222-258) ----------------
    doct = torch.div(datalen + 7, 8, rounding_mode="floor")
    q = torch.div(doct, RS_K, rounding_mode="floor")
    r = doct - q * RS_K
    num_blocks = _i32(q + (r != 0).to(torch.int32))
    last_len = _i32(torch.where(r == 0, RS_K, r))
    fec_last = _i32(torch.where(r == 0, 0, _fec_octetcount(r)))
    fec_total = _i32(q * (RS_N - RS_K) + fec_last)
    no_fec = fec_total == 0
    hdr_ok = ~reserved_bad & ~too_long & ~no_fec
    # last row's parity count (r == 0 -> full 6-octet final block)
    lf = _i32(torch.where(r == 0, RS_N - RS_K, fec_last))
    bits_consumed = _i32(HEADER_LEN + 8 * (doct + fec_total))

    # Gate geometry of rejected bursts to zero so downstream index math
    # stays in range and RS rows skip (fec_row == 0).
    nb = _i32(torch.where(hdr_ok, num_blocks, 0))

    # ---- optional burst compaction before the payload stages ---------
    blocks_row = None
    if rs_burst_cap is not None and rs_burst_cap < B:
        order = torch.argsort((~hdr_ok).to(torch.int32), stable=True)
        sel = order[:rs_burst_cap]
        blocks_row = torch.full((B,), -1, dtype=torch.int32, device=dev)
        blocks_row[sel] = torch.arange(rs_burst_cap, dtype=torch.int32,
                                       device=dev)
        clear_p, nb_p = clear[sel], nb[sel]
        hdr_p, ll_p = hdr_ok[sel], last_len[sel]
        lf_p, doct_p = lf[sel], doct[sel]
    else:
        clear_p, nb_p, hdr_p = clear, nb, hdr_ok
        ll_p, lf_p, doct_p = last_len, lf, doct
    Bp = clear_p.shape[0]

    # ---- octet packing (LSB-first, bitstream_read_lsbfirst order) ----
    w_oct = 1 << torch.arange(8, dtype=torch.int32, device=dev)
    po = clear_p[:, HEADER_LEN:HEADER_LEN + 8 * MAX_TOTAL_OCT]
    octets = (po.reshape(Bp, MAX_TOTAL_OCT, 8) * w_oct).sum(
        dim=2, dtype=torch.int32)                       # (Bp, 2100)

    # ---- deinterleave as a gather (fec/interleave.py mapping) --------
    # Destination cell (row, col) of the (nb, 255) table takes
    # transmission index  col*(nb-1) + min(col, cpr) + row.
    rows = torch.arange(MAX_BLOCKS, dtype=torch.int32, device=dev)[None, :, None]
    cols = torch.arange(RS_N, dtype=torch.int32, device=dev)[None, None, :]
    nb_ = nb_p[:, None, None]
    ll_ = torch.where(hdr_p, ll_p, 0)[:, None, None]
    lf_ = torch.where(hdr_p, lf_p, 0)[:, None, None]
    doct_ = torch.where(hdr_p, doct_p, 0)[:, None, None]

    is_data = cols < RS_K
    cf = cols - RS_K                                    # FEC-region column
    src_data = cols * (nb_ - 1) + torch.minimum(cols, ll_) + rows
    src_fec = doct_ + cf * (nb_ - 1) + torch.minimum(cf, lf_) + rows
    src = torch.where(is_data, src_data, src_fec)
    cpr = torch.where(is_data,
                      torch.where(rows < nb_ - 1, RS_K, ll_),
                      torch.where(rows < nb_ - 1, RS_N - RS_K, lf_))
    valid = (rows < nb_) & (torch.where(is_data, cols, cf) < cpr)
    src = torch.clamp(torch.where(valid, src, 0), 0, MAX_TOTAL_OCT - 1)
    tab = torch.gather(octets, 1, src.reshape(Bp, -1).long())
    tab = tab.reshape(Bp, MAX_BLOCKS, RS_N) * valid     # pad cells zero

    # ---- batched RS(255,249) -----------------------------------------
    rows1 = rows[0, :, 0]
    row_is_last = rows1 == (nb_p[:, None] - 1)          # (Bp, MAX_BLOCKS)
    fec_row = torch.where(rows1 < nb_p[:, None] - 1, RS_N - RS_K,
                          torch.where(row_is_last, lf_p[:, None], 0))
    fec_row = _i32(torch.where(hdr_p[:, None], fec_row, 0))
    corr, counts = rs_verify_batch(
        tab.reshape(Bp * MAX_BLOCKS, RS_N).to(torch.uint8),
        fec_row.reshape(Bp * MAX_BLOCKS))
    extra = {}
    if blocks_row is not None:
        extra["blocks_row"] = blocks_row
    if power is not None:
        total_syms = torch.clamp(-torch.div(-bits_consumed, 3,
                                            rounding_mode="floor"), min=1)
        sidx = torch.arange(S, dtype=torch.int32, device=dev)
        msk = sidx[None, :] < total_syms[:, None]
        extra["frame_pwr"] = torch.where(
            hdr_ok, (power * msk).sum(dim=1) / total_syms.to(torch.float32),
            0.0)
    return {
        **extra,
        "syndrome": synd, "synd_weight": weight,
        "reserved_bad": reserved_bad, "too_long": too_long,
        "no_fec": no_fec, "hdr_ok": hdr_ok,
        "datalen": datalen, "datalen_octets": _i32(doct),
        "num_blocks": num_blocks, "last_len": last_len,
        "bits_consumed": bits_consumed,
        "blocks": corr.reshape(Bp, MAX_BLOCKS, RS_N),
        "counts": counts.reshape(Bp, MAX_BLOCKS),
        "fec_row": fec_row,
    }
