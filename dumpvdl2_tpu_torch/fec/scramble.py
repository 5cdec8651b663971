"""VDL2 bit descrambler.

The air interface scrambles every burst with a 15-bit LFSR
(polynomial x^15 + x + 1, IV 0x6959, restarted at each burst; see
reference bitstream.c:94-107 and decode.c:50).  Because the sequence is
data-independent and restarts per burst, descrambling is just an XOR
with a precomputed PRBS prefix -- embarrassingly parallel, unlike the
reference's incremental in-place loop.
"""
from __future__ import annotations

import numpy as np

from ..constants import LFSR_IV, MAX_FRAME_LENGTH

# Longest possible burst in bits: 25-bit header is scrambled too, then
# data + FEC.  MAX_FRAME_LENGTH bits of data -> ceil(0x3FFF/8/249)=9 blocks
# -> up to 9*6 FEC octets.  Round generously.
_MAX_PRBS_BITS = 32 * 1024


def _prbs(length: int, iv: int = LFSR_IV) -> np.ndarray:
    """Generate ``length`` bits of the x^15+x+1 LFSR keystream from ``iv``."""
    out = np.empty(length, dtype=np.uint8)
    lfsr = iv
    for i in range(length):
        bit = (lfsr ^ (lfsr >> 14)) & 1
        lfsr = (lfsr >> 1) | (bit << 14)
        out[i] = bit
    return out


PRBS = _prbs(_MAX_PRBS_BITS)


def descramble(bits: np.ndarray) -> np.ndarray:
    """XOR a burst bit vector with the VDL2 scrambler keystream."""
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.size > PRBS.size:
        raise ValueError(f"burst too long to descramble: {bits.size} bits")
    return bits ^ PRBS[: bits.size]
