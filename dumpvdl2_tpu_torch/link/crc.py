"""CRC-16-CCITT (poly 0x1021, reflected, init 0xFFFF) for the AVLC FCS.

A frame passes its FCS check when the CRC over the whole frame including
the trailing FCS equals the residual 0xF0B8 (reference avlc.c:40,177).
The table is derived from the polynomial at import time.
"""
from __future__ import annotations

import numpy as np

POLY_REFLECTED = 0x8408  # 0x1021 bit-reversed
GOOD_FCS = 0xF0B8


def _build_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ (POLY_REFLECTED if crc & 1 else 0)
        table[byte] = crc
    return table


CRC_TABLE = _build_table()


def crc16_ccitt(data: bytes | bytearray | np.ndarray,
                crc_init: int = 0xFFFF) -> int:
    if isinstance(data, np.ndarray):
        data = data.astype(np.uint8).tobytes()
    crc = crc_init
    for byte in data:
        crc = (crc >> 8) ^ int(CRC_TABLE[(crc ^ byte) & 0xFF])
    return crc


def fcs_check(frame: bytes | np.ndarray) -> bool:
    return crc16_ccitt(frame) == GOOD_FCS
