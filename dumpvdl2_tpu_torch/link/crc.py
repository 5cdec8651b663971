"""CRC-16-CCITT (poly 0x1021, reflected, init 0xFFFF) for the AVLC FCS.

A frame passes its FCS check when the CRC over the whole frame including
the trailing FCS equals the residual 0xF0B8 (reference avlc.c:40,177).
The table is derived from the polynomial at import time.
"""
from __future__ import annotations

import numpy as np

from .. import native

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


_LIB = None
_LIB_TRIED = False
_CRC_FN = None                # bound native function, resolved once


def _lib():
    global _LIB, _LIB_TRIED, _CRC_FN
    if not _LIB_TRIED:
        # raises when the library cannot be built: marked as tried only
        # once it loaded (or DUMPVDL2_TPU_NATIVE=0 chose Python), so a
        # failure never turns into a quiet Python path on the next call
        _LIB = native.load_l2host()
        if _LIB is not None:
            _CRC_FN = _LIB.l2h_crc16_ccitt
        _LIB_TRIED = True
    return _LIB


def crc16_ccitt(data: bytes | bytearray | np.ndarray,
                crc_init: int = 0xFFFF) -> int:
    fn = _CRC_FN
    if fn is None and not _LIB_TRIED:
        _lib()
        fn = _CRC_FN
    if fn is not None and len(data):
        native.calls["l2h_crc16_ccitt"] += 1
        if isinstance(data, bytes):
            # argtypes=c_char_p: ctypes passes the bytes pointer
            # straight through, no per-call cast or copy
            return fn(data, len(data), crc_init)
        if isinstance(data, bytearray):
            return fn(bytes(data), len(data), crc_init)
        import ctypes
        buf = np.ascontiguousarray(data, dtype=np.uint8)
        # zero-copy: reinterpret the array's data pointer as char*
        ptr = ctypes.cast(ctypes.c_void_p(buf.ctypes.data),
                          ctypes.c_char_p)
        return fn(ptr, buf.size, crc_init)
    if isinstance(data, np.ndarray):
        data = data.astype(np.uint8).tobytes()
    crc = crc_init
    for byte in data:
        crc = (crc >> 8) ^ int(CRC_TABLE[(crc ^ byte) & 0xFF])
    return crc


def fcs_check(frame: bytes | np.ndarray) -> bool:
    return crc16_ccitt(frame) == GOOD_FCS
