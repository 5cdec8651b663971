"""VDL2 burst/waveform synthesizer for tests and benchmarks.

Builds spec-conformant bursts (the transmit direction the reference
never implements): AVLC frames -> FCS -> flags/stuffing -> RS encode ->
interleave -> header -> scramble -> D8PSK symbols -> IQ samples.  Used
to validate the receive pipeline end-to-end at controlled SNR/ppm and to
generate load for benchmarks.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import (ARITY, BPS, GRAYCODE, HDRFECLEN, HEADER_LEN,
                        MAX_FRAME_LENGTH, PREAMBLE_PHASE_UNITS, RS_K, RS_N,
                        SPS, TRLEN)
from .fec import rs
from .fec.header import syndrome_of
from .fec.interleave import _fill_order, burst_geometry, get_fec_octetcount
from .fec.scramble import PRBS
from .link.crc import crc16_ccitt
from .dsp.frontend import to_planar
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


# rs_fuzz's cases, in turn: (parity octets present, fewest and most
# random symbol errors); the absent parity octets of a shortened row are
# zero, as the deinterleave leaves them
RS_FUZZ_CASES = (
    (6, 0, 3),       # full block, correctable
    (4, 0, 2),       # shortened, 2 erasures + up to 2 errors
    (2, 0, 1),       # shortened, 4 erasures + up to 1 error
    (6, 4, 20),      # beyond capacity: mostly failures (-1)
    (4, 3, 12),      # shortened, beyond capacity
    (6, 0, 0),       # zero syndrome (a clean codeword)
    (0, 0, 20),      # no parity: RS skipped, bytes through
    (-1, 0, 3),      # odd and out-of-range counts (1, 3, 5, 7, -1)
)


def rs_fuzz(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded rows for the RS decoder (rs_verify): ``(rows (n, 255)
    uint8, fec_octets (n,) int32)``, row i of case
    ``RS_FUZZ_CASES[i % 8]``: a codeword of random data, its absent
    parity zeroed, with random symbol errors at random positions (some
    rows of the zero-syndrome case are all zero)."""
    rng = np.random.default_rng(seed)
    rows = rs.encode_batch(rng.integers(0, 256, (n, RS_K), dtype=np.uint8))
    case = np.arange(n) % len(RS_FUZZ_CASES)
    spec = np.array(RS_FUZZ_CASES)[case]
    fec = spec[:, 0].astype(np.int32)
    odd = fec < 0
    fec[odd] = rng.choice(np.array([1, 3, 5, 7, -1], np.int32),
                          size=int(odd.sum()))
    pos = np.arange(RS_N)[None, :]
    absent = (fec > 0)[:, None] & (pos >= RS_K + fec[:, None])
    rows[absent] = 0
    rows[(spec[:, 2] == 0) & (rng.random(n) < 0.1)] = 0
    n_err = rng.integers(spec[:, 1], spec[:, 2] + 1)
    where = np.argsort(rng.random((n, RS_N)), axis=1)[:, :int(n_err.max())]
    hit = np.arange(where.shape[1])[None, :] < n_err[:, None]
    flips = rng.integers(1, 256, where.shape, dtype=np.uint8) * hit
    np.bitwise_xor.at(rows, (np.repeat(np.arange(n), where.shape[1]),
                             where.reshape(-1)), flips.reshape(-1))
    return rows, fec


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


def bits_to_symbol_row(bits: np.ndarray, max_symbols: int,
                       rng: np.random.Generator) -> np.ndarray:
    """A burst's scrambled bits as one (max_symbols,) uint8 row of 3-bit
    symbols (MSB first), padded with random bits: what the L2 decode
    takes."""
    pad = 3 * max_symbols - bits.size
    bits = np.concatenate([bits, rng.integers(0, 2, pad, dtype=np.uint8)])
    tri = bits.reshape(max_symbols, 3)
    return ((tri[:, 0] << 2) | (tri[:, 1] << 1) | tri[:, 2]).astype(np.uint8)


def l2_fuzz(n: int, seed: int, max_symbols: int = 5616) -> np.ndarray:
    """Seeded (n, max_symbols) uint8 symbol rows for the L2 decode, row i
    of case i % 4: a clean burst of 1 to 9 RS blocks (one frame), the
    same with 1 to 12 random bit flips (header errors, correctable and
    uncorrectable RS rows), a row of noise, and a burst of 1 to 3 short
    frames; row 3 is the 1990-octet near-cap burst."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        case = i % 4
        if case == 2:
            rows.append(rng.integers(0, 8, max_symbols, dtype=np.uint8))
            continue
        if i == 3:
            sizes = [1990]
        elif case == 3:
            sizes = list(rng.integers(1, 120, int(rng.integers(1, 4))))
        else:
            blocks = int(rng.integers(1, 10))
            sizes = [int(rng.integers(max(1, (blocks - 1) * RS_K - 40),
                                      min(1990, blocks * RS_K - 60)))]
        bits = build_burst_bits([bytes(rng.integers(0, 256, int(s),
                                                    dtype=np.uint8))
                                 for s in sizes])
        if case == 1:
            flips = rng.integers(0, bits.size, int(rng.integers(1, 13)))
            bits[flips] ^= 1
        rows.append(bits_to_symbol_row(bits, max_symbols, rng))
    return np.stack(rows)


# l2_rs_fuzz's last RS rows, in turn: (fewest, most) data octets; the
# row's parity count follows from them (get_fec_octetcount): 6 for a
# full block and for 68-248 octets, then 4, 2 and 0
L2_RS_LAST = ((RS_K, RS_K), (68, RS_K - 1), (31, 67), (3, 30), (1, 2))


def l2_rs_fuzz(n: int, seed: int, max_symbols: int = 5616) -> np.ndarray:
    """Seeded (n, max_symbols) uint8 symbol rows for the L2 decode whose
    RS rows carry the cases of ``RS_FUZZ_CASES``.  Burst i has 1 to 9 RS
    blocks of random data, its last row of kind ``L2_RS_LAST[i % 5]``;
    each row, encoded, takes the symbol errors of a random case with its
    parity count (correctable, beyond capacity or a zero syndrome for 6
    parity octets; erasures with errors for 4 and 2; a row without
    parity passes through) at random transmitted positions, and the
    table goes out through ``interleave_burst`` behind a valid header.
    A single block of 1 or 2 octets has no parity: its header is
    rejected (no_fec)."""
    rng = np.random.default_rng(seed)
    cases = np.array(RS_FUZZ_CASES)
    max_oct = (MAX_FRAME_LENGTH + 7) // 8
    rows = []
    for i in range(n):
        lo, hi = L2_RS_LAST[i % len(L2_RS_LAST)]
        nb = int(rng.integers(1, (max_oct - lo) // RS_K + 2))
        last = int(rng.integers(lo, min(hi, max_oct - (nb - 1) * RS_K) + 1))
        doct = (nb - 1) * RS_K + last
        datalen = min(8 * doct - int(rng.integers(0, 8)), MAX_FRAME_LENGTH)
        data = rng.integers(0, 256, (nb, RS_K), dtype=np.uint8)
        data[-1, last:] = 0
        tab = rs.encode_batch(data)
        fec = [RS_N - RS_K] * (nb - 1) + [get_fec_octetcount(last)]
        tab[-1, RS_K + fec[-1]:] = 0
        for r in range(nb):
            kinds = cases[cases[:, 0] == fec[r]]
            _, e_lo, e_hi = kinds[rng.integers(len(kinds))]
            cols = np.r_[0:RS_K if r < nb - 1 else last,
                         RS_K:RS_K + fec[r]]
            n_err = min(int(rng.integers(e_lo, e_hi + 1)), cols.size)
            where = rng.choice(cols, size=n_err, replace=False)
            tab[r, where] ^= rng.integers(1, 256, n_err, dtype=np.uint8)
        bits = np.concatenate([build_header(datalen),
                               unpack_lsb(interleave_burst(tab, doct))])
        rows.append(bits_to_symbol_row(bits ^ PRBS[:bits.size],
                                       max_symbols, rng))
    return np.stack(rows)


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


# The wideband scene: 256 channels 25 kHz apart at oversample 80
# (8.4 Msps), in blocks of the multiple of 80 nearest 2**22 samples.
WIDEBAND_CENTER = 136.975e6
WIDEBAND_BLOCK = 52428 * 80
WIDEBAND_BLOCKS = 6


def wideband_scene(seed: int = 7, device="cuda"):
    """The 256-channel, 8.4 Msps span: noise plus 24 bursts on stride-4
    channels, staggered over WIDEBAND_BLOCKS blocks, made on ``device``
    from ``seed``.  Returns (freqs, fs, oversample, planar (2, N)
    float32 signal, [(frame with FCS, freq)] a burst, [(first raw
    sample, length, channel)] a burst)."""
    from .constants import SYMBOL_RATE
    os_, C = 80, 256
    fs = SYMBOL_RATE * SPS * os_
    freqs = [int(WIDEBAND_CENTER - 25e3 * (i - C // 2)) for i in range(C)]
    total = WIDEBAND_BLOCK * WIDEBAND_BLOCKS
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    sig = torch.randn((2, total), generator=gen, device=device) * 0.02
    n_active = 24
    active = rng.choice(np.arange(0, C, 4), size=n_active, replace=False)
    payloads = [b"wideband e2e burst ch%03d payload " % ch * 4
                for ch in active]
    spans = []
    for k, (ch, payload) in enumerate(zip(active, payloads)):
        burst = synthesize_iq_raw([payload], oversample=os_,
                                  carrier_offset_hz=freqs[ch]
                                  - WIDEBAND_CENTER, seed=int(ch))
        off = 60000 + (k * (total - 2 * 60000 - burst.size)) // n_active
        sig[:, off:off + burst.size] += torch.as_tensor(
            to_planar(burst * 0.5), device=device)
        spans.append((off, burst.size, int(ch)))
    want = [(frame_with_fcs(p), freqs[ch]) for ch, p in zip(active, payloads)]
    return freqs, int(fs), os_, sig, want, spans
