"""VDL2 burst synthesis for the benchmark's traffic (transmit direction).

Frozen copy, at commit 3d62869, of the port's burst synthesis in
``dumpvdl2_tpu_torch/sim.py`` (``frame_with_fcs``, ``stuff_frames``,
``interleave_burst``, ``build_header``, ``build_burst_bits``,
``bits_to_symbols``, ``synthesize_iq_raw``) and of the tables it draws
on (``fec/gf256.py``, ``fec/rs.py::encode_batch``,
``fec/interleave.py``, ``fec/header.py::syndrome_of``,
``fec/scramble.py``, ``link/crc.py``, ``utils/bits.py``).  It imports
nothing of the program, so a later change to the program cannot move
the yardstick.

Changed from the source, for set-up time: bit stuffing and the RS
encode run vectorised over all bursts of a scene, and the IQ of every
burst is written on the device in one pass (``render``) instead of one
numpy array a burst.  Each burst is its clean D8PSK waveform (a
rectangular phase per symbol, as in ``synthesize_iq_raw``) at its
amplitude, carrier offset and starting carrier phase; the scene adds
one Gaussian noise floor for the whole span.
"""
from __future__ import annotations

import numpy as np
import torch

RS_N, RS_K, NROOTS, FCR = 255, 249, 6, 120
TRLEN, HDRFECLEN = 17, 5
HEADER_LEN = 3 + TRLEN + HDRFECLEN
SPS = 10
SYMBOL_RATE = 10500
LFSR_IV = 0x6959
PREAMBLE_PHASE_UNITS = (0, 3, -3, 1, 1, 2, 0, 4, -3, 4, -2, 3, 1, -2, -3, 0)
GRAYCODE = (0, 1, 3, 2, 6, 7, 5, 4)
HEADER_H_ROWS = (
    0b0000000011111111111110000,
    0b0011111100001111111101000,
    0b1100011100110000111100100,
    0b1101101101010011001100010,
    0b0110100111100101010100001,
)


# ---------------------------------------------------------------- GF(2^8)
def _gf_tables(poly: int = 0x187):
    alpha_to = np.zeros(256, np.int32)
    index_of = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        alpha_to[i] = x
        index_of[x] = i
        x <<= 1
        if x & 0x100:
            x ^= poly
    alpha_to[255] = 0
    index_of[0] = 255
    return alpha_to, index_of


ALPHA_TO, INDEX_OF = _gf_tables()


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(ALPHA_TO[(int(INDEX_OF[a]) + int(INDEX_OF[b])) % 255])


def _generator_poly() -> np.ndarray:
    g = [1]
    for i in range(NROOTS):
        root = int(ALPHA_TO[(FCR + i) % 255])
        out = [0] * (len(g) + 1)
        for j, gj in enumerate(g):
            out[j] ^= _gf_mul(gj, root)
            out[j + 1] ^= gj
        g = out
    return np.array(g, np.int32)      # g[0] = constant term


GENPOLY = _generator_poly()


def rs_encode_batch(data: np.ndarray) -> np.ndarray:
    """Systematic RS(255,249) encode of each row of ``data`` (n, 249)."""
    data = np.asarray(data, np.int32)
    rem = np.zeros((data.shape[0], NROOTS), np.int32)
    glog = [int(INDEX_OF[int(GENPOLY[NROOTS - 1 - i])])
            for i in range(NROOTS)]
    for col in range(RS_K):
        feedback = data[:, col] ^ rem[:, 0]
        rem = np.concatenate([rem[:, 1:], np.zeros_like(rem[:, :1])], axis=1)
        flog = INDEX_OF[feedback]
        for i in range(NROOTS):
            if glog[i] != 255:
                rem[:, i] ^= np.where(feedback != 0,
                                      ALPHA_TO[(flog + glog[i]) % 255], 0)
    return np.concatenate([data, rem], axis=1).astype(np.uint8)


# ----------------------------------------------------------- burst layout
def fec_octetcount(last_block_len: int) -> int:
    if last_block_len < 3:
        return 0
    if last_block_len < 31:
        return 2
    if last_block_len < 68:
        return 4
    return 6


def burst_geometry(datalen_octets: int) -> tuple[int, int, int]:
    """(num_blocks, last_block_len, fec_octets) of a burst."""
    num_blocks, last_len = divmod(datalen_octets, RS_K)
    fec = num_blocks * (RS_N - RS_K)
    if last_len != 0:
        num_blocks += 1
    fec += fec_octetcount(last_len)
    if last_len == 0:
        last_len = RS_K
    return num_blocks, last_len, fec


def _fill_order(rows: int, cols_per_row: np.ndarray, col_base: int
                ) -> np.ndarray:
    max_cols = int(cols_per_row.max()) if rows > 0 else 0
    cols = np.arange(max_cols)
    valid = cols[:, None] < cols_per_row[None, :]
    flat = np.arange(rows)[None, :] * RS_N + col_base + cols[:, None]
    return flat[valid]


def interleave_burst(rs_tab: np.ndarray, datalen_octets: int) -> np.ndarray:
    """RS table (num_blocks, 255) -> octets in transmission order."""
    num_blocks, last_len, _ = burst_geometry(datalen_octets)
    data_cols = np.full(num_blocks, RS_K, np.int64)
    data_cols[-1] = last_len
    out = [rs_tab.reshape(-1)[_fill_order(num_blocks, data_cols, 0)]]
    last_fec = fec_octetcount(last_len)
    fec_rows = num_blocks if last_fec > 0 else num_blocks - 1
    if fec_rows > 0:
        fec_cols = np.full(fec_rows, RS_N - RS_K, np.int64)
        if fec_rows == num_blocks:
            fec_cols[-1] = last_fec
        out.append(rs_tab.reshape(-1)[_fill_order(fec_rows, fec_cols, RS_K)])
    return np.concatenate(out)


def _prbs(length: int, iv: int = LFSR_IV) -> np.ndarray:
    out = np.empty(length, np.uint8)
    lfsr = iv
    for i in range(length):
        bit = (lfsr ^ (lfsr >> 14)) & 1
        lfsr = (lfsr >> 1) | (bit << 14)
        out[i] = bit
    return out


PRBS = _prbs(32 * 1024)


def _crc_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x8408 if crc & 1 else 0)
        table[byte] = crc
    return table


CRC_TABLE = _crc_table()


def crc16_ccitt(data: bytes, crc: int = 0xFFFF) -> int:
    for byte in data:
        crc = (crc >> 8) ^ int(CRC_TABLE[(crc ^ byte) & 0xFF])
    return crc


def frame_with_fcs(payload: bytes) -> bytes:
    crc = crc16_ccitt(payload) ^ 0xFFFF
    return payload + bytes([crc & 0xFF, (crc >> 8) & 0xFF])


def unpack_lsb(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, np.uint8)
    return ((data[:, None] >> np.arange(8, dtype=np.uint8)) & 1) \
        .astype(np.uint8).reshape(-1)


_FLAG = np.array([0, 1, 1, 1, 1, 1, 1, 0], np.uint8)


def stuff(bits: np.ndarray) -> np.ndarray:
    """HDLC bit stuffing: a 0 after every fifth 1 of a run of ones
    (vectorised form of sim.stuff_frames' loop: within a run of L ones
    the zeros go after its 5th, 10th, ... one)."""
    bits = np.asarray(bits, np.uint8)
    n = bits.size
    if n == 0:
        return bits
    # position of each bit inside its run of ones (1-based), 0 for zeros
    idx = np.arange(n)
    zeros_at = np.where(bits == 0, idx, -1)
    last_zero = np.maximum.accumulate(zeros_at)
    run_pos = np.where(bits == 1, idx - last_zero, 0)
    insert_after = np.nonzero((run_pos > 0) & (run_pos % 5 == 0))[0]
    return np.insert(bits, insert_after + 1, 0)


def stuff_frames(frames: list[bytes]) -> np.ndarray:
    parts = [_FLAG]
    for frame in frames:
        parts.append(stuff(unpack_lsb(np.frombuffer(frame, np.uint8))))
        parts.append(_FLAG)
    return np.concatenate(parts)


def header_syndrome(word: int) -> int:
    s = 0
    for i, row in enumerate(HEADER_H_ROWS):
        s |= (bin(word & row).count("1") & 1) << (HDRFECLEN - 1 - i)
    return s


def build_header(datalen_bits: int) -> np.ndarray:
    """25 header bits (MSB-first) with valid FEC, reserved bits 0."""
    trfield = 0
    for i in range(TRLEN):
        trfield = (trfield << 1) | ((datalen_bits >> i) & 1)
    word = trfield << HDRFECLEN
    for fec in range(1 << HDRFECLEN):
        if header_syndrome(word | fec) == 0:
            word |= fec
            break
    else:
        raise AssertionError("no parity bits satisfy the header code")
    return np.array([(word >> (HEADER_LEN - 1 - i)) & 1
                     for i in range(HEADER_LEN)], np.uint8)


class BurstBits:
    """One burst's transmit-side layout: ``bits`` (scrambled, on air),
    ``datalen`` bits, the RS table ``rs_tab`` (num_blocks, 255) with its
    parity, and ``frame`` (the AVLC frame with its FCS)."""

    __slots__ = ("bits", "datalen", "rs_tab", "frame")

    def __init__(self, bits, datalen, rs_tab, frame):
        self.bits, self.datalen, self.rs_tab, self.frame = \
            bits, datalen, rs_tab, frame


def build_bursts(payloads: list[bytes]) -> list[BurstBits]:
    """sim.build_burst_bits for one frame a burst, all bursts' RS rows
    encoded in one batch."""
    frames = [frame_with_fcs(p) for p in payloads]
    layouts, rows = [], []
    for frame in frames:
        payload_bits = stuff_frames([frame])
        datalen = int(payload_bits.size)
        doct = (datalen + 7) // 8
        num_blocks, last_len, fec_octets = burst_geometry(doct)
        if fec_octets == 0:
            raise ValueError("burst too short to carry FEC")
        padded = np.zeros(doct * 8, np.uint8)
        padded[:datalen] = payload_bits
        data = np.packbits(padded, bitorder="little")
        tab = np.zeros((num_blocks, RS_K), np.uint8)
        for r in range(num_blocks):
            chunk = data[r * RS_K:(r + 1) * RS_K]
            tab[r, :chunk.size] = chunk
        layouts.append((datalen, doct, num_blocks, last_len))
        rows.append(tab)
    coded = rs_encode_batch(np.concatenate(rows)) if rows else \
        np.zeros((0, RS_N), np.uint8)
    out, at = [], 0
    for frame, (datalen, doct, num_blocks, last_len), tab in \
            zip(frames, layouts, rows):
        rs_tab = coded[at:at + num_blocks].copy()
        at += num_blocks
        # the shortened last block carries only its first parity octets
        rs_tab[-1, RS_K + fec_octetcount(last_len):] = 0
        bits = np.concatenate([build_header(datalen),
                               unpack_lsb(interleave_burst(rs_tab, doct))])
        out.append(BurstBits(bits ^ PRBS[:bits.size], datalen, rs_tab,
                             frame))
    return out


_INV_GRAY = np.argsort(np.array(GRAYCODE))


def bits_to_steps(bits: np.ndarray) -> np.ndarray:
    """D8PSK phase step index (0..7, units of pi/4) of each symbol."""
    bits = np.asarray(bits, np.uint8)
    if bits.size % 3:
        bits = np.concatenate([bits, np.zeros(3 - bits.size % 3, np.uint8)])
    tri = bits.reshape(-1, 3)
    return _INV_GRAY[(tri[:, 0] << 2) | (tri[:, 1] << 1) | tri[:, 2]]


def symbol_phases(bits: np.ndarray) -> np.ndarray:
    """Carrier phase (radians) of each transmitted symbol: the preamble's
    16, then the cumulative D8PSK steps of the bits."""
    pre = np.array(PREAMBLE_PHASE_UNITS, np.float64) * (np.pi / 4)
    steps = np.cumsum(bits_to_steps(bits)) * (np.pi / 4) + pre[-1]
    return np.concatenate([pre, steps])


def n_symbols(bits: np.ndarray) -> int:
    """Symbols a burst occupies on air (preamble included)."""
    return len(PREAMBLE_PHASE_UNITS) + -(-bits.size // 3)


def render(sig: torch.Tensor, starts, phases: list[np.ndarray], amps,
           offsets_hz, carrier0, fs: float, oversample: int,
           chunk: int = 1 << 24) -> None:
    """``_render`` in groups of bursts of about ``chunk`` samples, which
    bounds the transient device memory."""
    spsym = SPS * oversample
    group, size = [], 0
    for i, p in enumerate(phases):
        group.append(i)
        size += p.size * spsym
        if size >= chunk or i == len(phases) - 1:
            _render(sig, [starts[j] for j in group],
                    [phases[j] for j in group], [amps[j] for j in group],
                    [offsets_hz[j] for j in group],
                    [carrier0[j] for j in group], fs, oversample)
            group, size = [], 0


def _render(sig: torch.Tensor, starts, phases: list[np.ndarray], amps,
            offsets_hz, carrier0, fs: float, oversample: int) -> None:
    """Add every burst to the planar (2, N) float32 signal ``sig`` in
    place: burst i's symbol phases ``phases[i]`` from raw sample
    ``starts[i]``, each symbol held for SPS * oversample samples, at
    amplitude ``amps[i]``, shifted by ``offsets_hz[i]`` with starting
    carrier phase ``carrier0[i]``.  One gather and one scatter-add for
    the whole list; the carrier's phase is formed in float64."""
    if not phases:
        return
    dev = sig.device
    spsym = SPS * oversample
    nsym = np.array([p.size for p in phases], np.int64)
    sym_ph = torch.as_tensor(np.concatenate(phases), device=dev)
    lens = torch.as_tensor(nsym * spsym, device=dev)
    owner = torch.repeat_interleave(
        torch.arange(len(phases), device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    local = torch.arange(int(lens.sum()), device=dev) - first[owner]
    sym_first = torch.as_tensor(np.cumsum(nsym) - nsym, device=dev)
    ph = sym_ph[sym_first[owner] + torch.div(local, spsym,
                                             rounding_mode="floor")]
    off = torch.as_tensor(np.asarray(offsets_hz, np.float64), device=dev)
    c0 = torch.as_tensor(np.asarray(carrier0, np.float64), device=dev)
    ph = ph + c0[owner] + (2.0 * np.pi / fs) * off[owner] * local
    amp = torch.as_tensor(np.asarray(amps, np.float64), device=dev)[owner]
    pos = torch.as_tensor(np.asarray(starts, np.int64), device=dev)[owner] \
        + local
    sig[0].index_add_(0, pos, (amp * torch.cos(ph)).to(torch.float32))
    sig[1].index_add_(0, pos, (amp * torch.sin(ph)).to(torch.float32))
