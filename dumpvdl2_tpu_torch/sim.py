"""VDL2 burst/waveform synthesizer for tests and benchmarks.

Builds spec-conformant bursts (the transmit direction the reference
never implements): AVLC frames -> FCS -> flags/stuffing -> RS encode ->
interleave -> header -> scramble -> D8PSK symbols -> IQ samples.  Used
to validate the receive pipeline end-to-end at controlled SNR/ppm and to
generate load for benchmarks.
"""
from __future__ import annotations

import numpy as np

from .constants import (ARITY, BPS, GRAYCODE, HDRFECLEN, HEADER_LEN,
                        PREAMBLE_PHASE_UNITS, RS_K, RS_N, SPS, TRLEN)
from .fec import rs
from .fec.header import syndrome_of
from .fec.interleave import _fill_order, burst_geometry, get_fec_octetcount
from .fec.scramble import PRBS
from .link.crc import crc16_ccitt
from .utils.bits import symbols_to_bits_msb, unpack_lsb


def frame_with_fcs(payload: bytes) -> bytes:
    crc = crc16_ccitt(payload) ^ 0xFFFF
    return payload + bytes([crc & 0xFF, (crc >> 8) & 0xFF])


def stuff_frames(frames: list[bytes]) -> np.ndarray:
    """Flag-delimit and bit-stuff frames into a burst payload bit vector."""
    flag = [0, 1, 1, 1, 1, 1, 1, 0]
    bits: list[int] = list(flag)
    for frame in frames:
        ones = 0
        for bit in unpack_lsb(np.frombuffer(frame, dtype=np.uint8)).tolist():
            bits.append(bit)
            if bit:
                ones += 1
                if ones == 5:
                    bits.append(0)
                    ones = 0
            else:
                ones = 0
        bits.extend(flag)
    return np.array(bits, dtype=np.uint8)


def interleave_burst(rs_tab: np.ndarray, datalen_octets: int) -> np.ndarray:
    """Inverse of fec.interleave.deinterleave_burst."""
    num_blocks, last_len, fec_octets = burst_geometry(datalen_octets)
    data_cols = np.full(num_blocks, RS_K, dtype=np.int64)
    data_cols[-1] = last_len
    data_order = _fill_order(num_blocks, data_cols, 0)
    out = [rs_tab.reshape(-1)[data_order]]
    last_fec = get_fec_octetcount(last_len)
    fec_rows = num_blocks if last_fec > 0 else num_blocks - 1
    if fec_rows > 0:
        fec_cols = np.full(fec_rows, RS_N - RS_K, dtype=np.int64)
        if fec_rows == num_blocks:
            fec_cols[-1] = last_fec
        fec_order = _fill_order(fec_rows, fec_cols, RS_K)
        out.append(rs_tab.reshape(-1)[fec_order])
    return np.concatenate(out)


def build_header(datalen_bits: int) -> np.ndarray:
    """25 header bits (MSB-first order) with valid FEC, reserved bits 0."""
    trfield = 0
    for i in range(TRLEN):
        trfield = (trfield << 1) | ((datalen_bits >> i) & 1)  # bit-reversed
    word = trfield << HDRFECLEN
    for fec in range(1 << HDRFECLEN):
        if syndrome_of(word | fec) == 0:
            word |= fec
            break
    else:
        raise AssertionError("no parity bits satisfy header code")
    return np.array([(word >> (HEADER_LEN - 1 - i)) & 1
                     for i in range(HEADER_LEN)], dtype=np.uint8)


def build_burst_bits(frames: list[bytes]) -> np.ndarray:
    """Scrambled on-air bit vector for a burst carrying ``frames``.

    Frames are raw AVLC payloads WITHOUT FCS; the FCS is appended here.
    """
    payload_bits = stuff_frames([frame_with_fcs(f) for f in frames])
    datalen = int(payload_bits.size)
    datalen_octets = (datalen + 7) // 8
    num_blocks, last_len, fec_octets = burst_geometry(datalen_octets)
    if fec_octets == 0:
        raise ValueError("burst too short to carry FEC")

    padded = np.zeros(datalen_octets * 8, dtype=np.uint8)
    padded[:datalen] = payload_bits
    data_octets = np.packbits(padded, bitorder="little")

    rs_tab = np.zeros((num_blocks, RS_N), dtype=np.uint8)
    row_lens = [RS_K] * (num_blocks - 1) + [last_len]
    start = 0
    for r, rl in enumerate(row_lens):
        rs_tab[r, :rl] = data_octets[start:start + rl]
        start += rl
        full = rs.encode(np.concatenate([rs_tab[r, :RS_K]]).astype(np.uint8)
                         if rl == RS_K else
                         np.concatenate([rs_tab[r, :rl],
                                         np.zeros(RS_K - rl, np.uint8)]))
        nfec = RS_N - RS_K if r < num_blocks - 1 else get_fec_octetcount(last_len)
        rs_tab[r, RS_K:RS_K + nfec] = full[RS_K:RS_K + nfec]

    tx_octets = interleave_burst(rs_tab, datalen_octets)
    burst = np.concatenate([
        build_header(datalen),
        unpack_lsb(tx_octets),
    ])
    return burst ^ PRBS[:burst.size]


def bits_to_symbols(bits: np.ndarray) -> np.ndarray:
    """Map a bit vector (3 bits/symbol, MSB-first) to D8PSK phase steps.

    Returns the per-symbol phase increment index k (0..7) such that the
    carrier phase advances by k * pi/4 each symbol.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.size % BPS:
        bits = np.concatenate([bits, np.zeros(BPS - bits.size % BPS, np.uint8)])
    tri = bits.reshape(-1, BPS)
    sym = (tri[:, 0] << 2) | (tri[:, 1] << 1) | tri[:, 2]
    inv_gray = np.zeros(ARITY, dtype=np.uint8)
    for idx, g in enumerate(GRAYCODE):
        inv_gray[g] = idx
    return inv_gray[sym]


def synthesize_iq_raw(frames: list[bytes], oversample: int = 10,
                      carrier_offset_hz: float = 0.0, snr_db: float = 40.0,
                      lead_in_syms: int = 60, tail_syms: int = 30,
                      seed: int = 0) -> np.ndarray:
    """Complex64 burst at the ingest rate (oversample * SPS per symbol).

    Shifts the burst to ``carrier_offset_hz`` relative to the receiver
    center frequency to exercise the NCO/channelizer path.
    """
    from .constants import SYMBOL_RATE
    rng = np.random.default_rng(seed)
    fs = SYMBOL_RATE * SPS * oversample
    bits = build_burst_bits(frames)
    steps = bits_to_symbols(bits)
    pre = np.array(PREAMBLE_PHASE_UNITS, dtype=np.float64) * (np.pi / 4)
    phase = list(pre)
    cur = pre[-1]
    for k in steps:
        cur += k * np.pi / 4
        phase.append(cur)
    spsym = SPS * oversample
    sym_samples = np.repeat(np.exp(1j * np.array(phase)), spsym)
    sig = np.concatenate([
        np.zeros(lead_in_syms * spsym, np.complex128),
        sym_samples,
        np.zeros(tail_syms * spsym, np.complex128)])
    if carrier_offset_hz:
        t = np.arange(sig.size) / fs
        sig = sig * np.exp(2j * np.pi * carrier_offset_hz * t)
    npow = 10 ** (-snr_db / 10)
    noise = rng.standard_normal(sig.size) + 1j * rng.standard_normal(sig.size)
    return (sig + noise * np.sqrt(npow / 2)).astype(np.complex64)


def synthesize_iq(frames: list[bytes], fs_decimated: float = SPS * 10500.0,
                  snr_db: float = 40.0, freq_offset_hz: float = 0.0,
                  lead_in_syms: int = 50, seed: int = 0,
                  ) -> np.ndarray:
    """Complex64 baseband at SPS samples/symbol containing one burst.

    The burst = 16-symbol preamble (the spec training sequence) followed
    by the scrambled header+payload symbols.  Rectangular pulse shaping
    (constant phase over each symbol) -- adequate for exercising the
    sync/slicer path.
    """
    rng = np.random.default_rng(seed)
    bits = build_burst_bits(frames)
    steps = bits_to_symbols(bits)

    pre = np.array(PREAMBLE_PHASE_UNITS, dtype=np.float64) * (np.pi / 4)
    phase = [0.0]
    for i in range(1, len(pre)):
        phase.append(pre[i])
    cur = pre[-1]
    for k in steps:
        cur = cur + k * np.pi / 4
        phase.append(cur)
    phase = np.array(phase)

    sym_samples = np.repeat(np.exp(1j * phase), SPS)
    lead = np.zeros(lead_in_syms * SPS, dtype=np.complex128)
    tail = np.zeros(20 * SPS, dtype=np.complex128)
    sig = np.concatenate([lead, sym_samples, tail])
    if freq_offset_hz:
        t = np.arange(sig.size) / fs_decimated
        sig = sig * np.exp(2j * np.pi * freq_offset_hz * t)
    npow = 10 ** (-snr_db / 10)
    noise = (rng.standard_normal(sig.size) + 1j * rng.standard_normal(sig.size))
    sig = sig + noise * np.sqrt(npow / 2)
    return sig.astype(np.complex64)
