"""L2 burst decoder: demodulated bits -> AVLC frame payloads.

Follows the VDL2 burst structure handled by the reference's
``decode_vdl2_burst`` (decode.c:196-384) but as a pure function over the
whole burst bit-vector instead of an incremental state machine:

    descramble -> 25-bit header (FEC-corrected, reserved-bit check)
    -> transmission length -> RS block geometry -> deinterleave
    -> RS(255,249) errors+erasures decode per block -> truncate to
    datalen -> HDLC unstuff/flag framing -> frames (octets, LSB-first).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .constants import (HDRFECLEN, HEADER_LEN, MAX_FRAME_LENGTH,
                        MAX_FRAME_LENGTH_CORRECTED, RS_K, RS_N, TRLEN)
from .fec.header import SYND_WEIGHT, decode_header
from .fec.interleave import burst_geometry, deinterleave_burst, get_fec_octetcount
from .fec.l2 import l2_decode_batch
from .fec.rs import rs_verify
from .fec.scramble import descramble
from .link.unstuff import UnstuffError, frames_from_bits
from .utils.bits import bits_to_word_msb, pack_lsb, reverse_bits
from .utils.devices import resolve_device


@dataclass
class BurstResult:
    """Outcome of decoding one burst."""
    ok: bool
    reason: str = ""
    datalen: int = 0                 # transmission length, bits
    datalen_octets: int = 0
    syndrome: int = 0                # header FEC syndrome
    synd_weight: int = 0
    num_fec_corrections: int = 0
    blocks_processed: int = 0        # RS codeword rows attempted
    blocks_fec_ok: int = 0           # RS rows that verified/corrected
    frames: list[np.ndarray] = field(default_factory=list)  # octet arrays
    bits_consumed: int = HEADER_LEN  # demodulated bits this burst used


def header_info(header_bits: np.ndarray) -> BurstResult:
    """Decode the 25-bit burst header; no payload processing.

    ``header_bits`` are the first HEADER_LEN descrambled bits of the
    burst (MSB-first word order).
    """
    word = bits_to_word_msb(header_bits[:HEADER_LEN])
    # Reserved symbol bits forced to zero before FEC decode improves the
    # decode odds (same trick as the reference, decode.c:209).
    word &= (1 << (TRLEN + HDRFECLEN)) - 1
    corrected, syndrome = decode_header(word)
    res = BurstResult(ok=False, syndrome=syndrome,
                      synd_weight=SYND_WEIGHT[syndrome])
    if corrected >> (TRLEN + HDRFECLEN):
        res.reason = "hdr_reserved_bits"
        return res
    trfield = (corrected >> HDRFECLEN) & ((1 << TRLEN) - 1)
    datalen = reverse_bits(trfield, TRLEN)
    if (syndrome != 0 and datalen > MAX_FRAME_LENGTH_CORRECTED) \
            or datalen > MAX_FRAME_LENGTH:
        res.datalen = datalen
        res.reason = "too_long"
        return res
    res.datalen = datalen
    res.datalen_octets = (datalen + 7) // 8
    num_blocks, last_len, fec_octets = burst_geometry(res.datalen_octets)
    if fec_octets == 0:
        res.reason = "no_fec"
        return res
    res.ok = True
    res.bits_consumed = HEADER_LEN + 8 * (res.datalen_octets + fec_octets)
    return res


def decode_bursts_device(symbols: np.ndarray, max_symbols: int,
                         device: str | torch.device | None = None
                         ) -> list[BurstResult]:
    """Batched burst decode on the card (fec/l2.py: kernels L2H, L2D
    and RS), or on the CPU when ``device="cpu"``.

    ``symbols``: (B, S) uint8 gray-decoded symbols, one row per
    candidate burst.  Descramble, header FEC, deinterleave and RS run
    batched on the device for the whole batch; only HDLC unstuff +
    framing happen here per burst.  Result list matches what
    ``decode_burst`` returns for each row's bit expansion.
    """
    syms = torch.as_tensor(np.asarray(symbols, dtype=np.uint8),
                           device=resolve_device(device))
    out = tree_to_numpy(l2_decode_batch(syms, max_symbols))
    return [_result_from_batch(out, i) for i in range(syms.shape[0])]


def tree_to_numpy(tree: dict) -> dict:
    """A dict of device tensors as numpy arrays on the host."""
    return {k: v.cpu().numpy() for k, v in tree.items()}


def _result_from_batch(out: dict, i: int) -> BurstResult:
    """Assemble one BurstResult from l2_decode_batch output row ``i``."""
    res = BurstResult(ok=False, syndrome=int(out["syndrome"][i]),
                      synd_weight=int(out["synd_weight"][i]))
    if out["reserved_bad"][i]:
        res.reason = "hdr_reserved_bits"
        return res
    res.datalen = int(out["datalen"][i])
    if out["too_long"][i]:
        res.reason = "too_long"
        return res
    res.datalen_octets = int(out["datalen_octets"][i])
    if out["no_fec"][i]:
        res.reason = "no_fec"
        return res
    res.bits_consumed = int(out["bits_consumed"][i])

    num_blocks = int(out["num_blocks"][i])
    last_len = int(out["last_len"][i])
    bi = i
    if "blocks_row" in out:
        # the payload stage ran on the hdr-ok compaction's rows
        # (l2_decode_batch's rs_burst_cap): blocks, counts and fec_row
        # are at the compacted row
        bi = int(out["blocks_row"][i])
        if bi < 0:
            res.reason = "l2_overflow"
            return res
    counts = out["counts"][bi]
    fec_row = out["fec_row"][bi]
    rows = []
    for r in range(num_blocks):
        res.blocks_processed += 1
        if counts[r] < 0:
            res.reason = "fec_bad"
            return res
        res.blocks_fec_ok += 1
        if counts[r] > 0:
            res.num_fec_corrections += int(counts[r]) \
                - (RS_N - RS_K - int(fec_row[r]))
        rows.append(out["blocks"][bi, r,
                                  :RS_K if r != num_blocks - 1 else last_len])

    data_bits = np.unpackbits(np.concatenate(rows).astype(np.uint8),
                              bitorder="little")[:res.datalen]
    try:
        for frame_bits in frames_from_bits(data_bits):
            if frame_bits.size % 8 != 0:
                res.reason = "truncated_octets"
                return res
            if frame_bits.size == 0:
                continue
            res.frames.append(pack_lsb(frame_bits))
    except UnstuffError:
        res.reason = "unstuff"
        return res
    res.ok = True
    return res


def decode_burst(bits: np.ndarray) -> BurstResult:
    """Decode a full burst from its raw (scrambled) demodulated bits.

    ``bits`` must contain at least the header; extra trailing bits beyond
    the transmission length are ignored (block-based demodulation slices
    generously).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.size < HEADER_LEN:
        return BurstResult(ok=False, reason="no_header")
    clear = descramble(bits)
    res = header_info(clear[:HEADER_LEN])
    if not res.ok:
        return res
    res.ok = False

    num_blocks, last_len, fec_octets = burst_geometry(res.datalen_octets)
    payload_bits = 8 * (res.datalen_octets + fec_octets)
    if clear.size < HEADER_LEN + payload_bits:
        res.reason = "data_truncated"
        return res
    payload = clear[HEADER_LEN:HEADER_LEN + payload_bits]
    octets = pack_lsb(payload)  # transmission order, LSB-first per octet

    rs_tab, num_blocks, last_len = deinterleave_burst(octets, res.datalen_octets)
    corrected_rows = []
    for r in range(num_blocks):
        nfec = RS_N - RS_K if r != num_blocks - 1 else get_fec_octetcount(last_len)
        res.blocks_processed += 1
        row, ret = rs_verify(rs_tab[r], nfec)
        if ret < 0:
            res.reason = "fec_bad"
            return res
        res.blocks_fec_ok += 1
        if ret > 0:
            # corrected octets excluding the intended erasures
            res.num_fec_corrections += ret - (RS_N - RS_K - nfec)
        corrected_rows.append(row[:RS_K if r != num_blocks - 1 else last_len])

    data_octets = np.concatenate(corrected_rows)
    data_bits = np.unpackbits(data_octets, bitorder="little")[:res.datalen]

    try:
        for frame_bits in frames_from_bits(data_bits):
            if frame_bits.size % 8 != 0:
                res.reason = "truncated_octets"
                return res
            if frame_bits.size == 0:
                # A trailing run with no content; the reference emits a
                # zero-length frame here which the AVLC layer drops.
                continue
            res.frames.append(pack_lsb(frame_bits))
    except UnstuffError:
        res.reason = "unstuff"
        return res
    res.ok = True
    return res
