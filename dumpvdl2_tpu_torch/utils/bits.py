"""Vectorized bit-level helpers (NumPy).

The VDL2 burst decoder works on bit vectors (one bit per array element,
dtype uint8).  These helpers replace the reference's incremental
``bitstream_t`` (reference bitstream.c) with whole-array operations.
"""
from __future__ import annotations

import numpy as np


def unpack_msb(data: np.ndarray, numbits: int = 8) -> np.ndarray:
    """Expand each byte into ``numbits`` bits, most-significant first."""
    data = np.asarray(data, dtype=np.uint8)
    shifts = np.arange(numbits - 1, -1, -1, dtype=np.uint8)
    return ((data[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)


def unpack_lsb(data: np.ndarray, numbits: int = 8) -> np.ndarray:
    """Expand each byte into ``numbits`` bits, least-significant first."""
    data = np.asarray(data, dtype=np.uint8)
    shifts = np.arange(numbits, dtype=np.uint8)
    return ((data[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)


def pack_lsb(bits: np.ndarray) -> np.ndarray:
    """Pack bits (first bit -> LSB of first byte) into bytes.

    Matches the reference's ``bitstream_read_lsbfirst`` consumption order:
    the first bit in the stream becomes bit 0 of the first octet.
    The bit count must be a multiple of 8.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.size % 8 != 0:
        raise ValueError("bit count not a multiple of 8")
    groups = bits.reshape(-1, 8)
    weights = (1 << np.arange(8, dtype=np.uint16)).astype(np.uint16)
    return (groups.astype(np.uint16) * weights).sum(axis=1).astype(np.uint8)


def pack_msb(bits: np.ndarray) -> np.ndarray:
    """Pack bits (first bit -> MSB of first byte) into bytes."""
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.size % 8 != 0:
        raise ValueError("bit count not a multiple of 8")
    groups = bits.reshape(-1, 8)
    weights = (1 << np.arange(7, -1, -1, dtype=np.uint16)).astype(np.uint16)
    return (groups.astype(np.uint16) * weights).sum(axis=1).astype(np.uint8)


def bits_to_word_msb(bits: np.ndarray) -> int:
    """Interpret a bit vector as an MSB-first unsigned integer."""
    bits = np.asarray(bits, dtype=np.uint64)
    word = 0
    for b in bits.tolist():
        word = (word << 1) | int(b)
    return word


def symbols_to_bits_msb(symbols: np.ndarray, bps: int = 3) -> np.ndarray:
    """Expand symbol values into bits, MSB of each symbol first.

    Mirrors the reference's ``bitstream_append_msbfirst(bs, &sym, 1, BPS)``
    per demodulated symbol (demod.c:274).
    """
    symbols = np.asarray(symbols, dtype=np.uint8)
    shifts = np.arange(bps - 1, -1, -1, dtype=np.uint8)
    return ((symbols[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)


_REV8 = bytes(
    ((i * 0x0202020202 & 0x010884422010) % 1023) & 0xFF for i in range(256))


def reverse_bits(value: int, numbits: int) -> int:
    """Reverse the low ``numbits`` bits of ``value``."""
    if numbits <= 32:
        v = value & ((1 << numbits) - 1)
        r = (_REV8[v & 0xFF] << 24) | (_REV8[(v >> 8) & 0xFF] << 16) \
            | (_REV8[(v >> 16) & 0xFF] << 8) | _REV8[(v >> 24) & 0xFF]
        return r >> (32 - numbits)
    result = 0
    for i in range(numbits):
        result = (result << 1) | ((value >> i) & 1)
    return result
