"""VDL2 burst-header FEC: a (25,20) shortened block code.

The burst header is 3 reserved bits + 17 transmission-length bits +
5 parity bits, protected by the parity-check matrix below (an air
interface constant from ICAO Doc 9776; the reference implements the same
code in decode.c:55-122).  Up to 2 bit errors are correctable.

Instead of shipping a literal syndrome table, we derive it from the
parity-check matrix at import time: every 1-bit error pattern gets its
syndrome; the six syndromes not reachable by a single error are assigned
the 2-bit pattern whose most significant flipped bit is highest (this
deterministic rule reproduces the behavior of the published decoder,
verified by tests/test_header_fec.py).
"""
from __future__ import annotations

from itertools import combinations

from ..constants import HDRFECLEN, HEADER_LEN, TRLEN

# Parity-check matrix rows over the 25 header bits (MSB = bit 24).
H_ROWS = (
    0b0000000011111111111110000,
    0b0011111100001111111101000,
    0b1100011100110000111100100,
    0b1101101101010011001100010,
    0b0110100111100101010100001,
)


def _parity(v: int) -> int:
    return bin(v).count("1") & 1


def syndrome_of(word: int) -> int:
    """Compute the 5-bit syndrome of a 25-bit header word."""
    s = 0
    for i, row in enumerate(H_ROWS):
        s |= _parity(word & row) << (HDRFECLEN - 1 - i)
    return s


def _build_tables() -> tuple[list[int], list[int]]:
    patterns = [0] * (1 << HDRFECLEN)
    weights = [0] * (1 << HDRFECLEN)
    seen = {0}
    for k in range(HEADER_LEN):
        e = 1 << k
        s = syndrome_of(e)
        patterns[s] = e
        weights[s] = 1
        seen.add(s)
    # Remaining syndromes need 2-bit patterns; pick the candidate whose
    # higher flipped bit is largest (lands in the reserved-bits region,
    # which the header sanity check then rejects -- same net behavior as
    # the reference decoder).
    for s in range(1 << HDRFECLEN):
        if s in seen:
            continue
        best = None
        for i, j in combinations(range(HEADER_LEN), 2):
            e = (1 << i) | (1 << j)
            if syndrome_of(e) == s:
                pair = (max(i, j), min(i, j))
                if best is None or pair > best:
                    best = pair
        if best is None:
            raise AssertionError(f"uncovered syndrome {s}")
        patterns[s] = (1 << best[0]) | (1 << best[1])
        weights[s] = 2
    return patterns, weights


SYNDTABLE, SYND_WEIGHT = _build_tables()


def decode_header(word: int) -> tuple[int, int]:
    """Correct a received 25-bit header word.

    Returns ``(corrected_word, syndrome)``.  A zero syndrome means the
    header passed its parity check unchanged.
    """
    s = syndrome_of(word)
    return word ^ SYNDTABLE[s], s
