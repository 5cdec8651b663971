"""HDLC bit-unstuffing and flag framing.

A VDL2 burst carries one or more AVLC frames delimited by 0x7E flags,
with a 0 bit stuffed after every five consecutive 1s.  Semantics mirror
the reference's ``bitstream_copy_next_frame`` (bitstream.c:109-150):

* a 0 following five 1s is a stuffed bit -> dropped;
* seven or more consecutive 1s -> invalid stream;
* six 1s followed by 0 is a flag: if it is the first 8 bits of the
  stream it is an opening flag (skip it), if it arrives mid-stream it
  closes the current frame (trailing flag removed from the result);
* six 1s arriving before 8 bits have been accumulated -> invalid.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class UnstuffError(Exception):
    """Invalid bit-stuffing sequence."""


def frames_from_bits(bits: np.ndarray) -> Iterator[np.ndarray]:
    """Yield unstuffed frame bit-vectors from a descrambled burst payload.

    Raises :class:`UnstuffError` when an invalid sequence is hit; frames
    yielded before the error remain valid (the reference emits them too).
    """
    yield from _frames_py(bits)


def _frames_py(bits: np.ndarray) -> Iterator[np.ndarray]:
    src = np.asarray(bits, dtype=np.uint8).tolist()
    n = len(src)
    pos = 0
    while pos < n:
        ones = 0
        out: list[int] = []
        closed = False
        while pos < n:
            bit = src[pos]
            pos += 1
            if bit == 0 and ones == 5:      # stuffed zero
                ones = 0
                continue
            if bit == 1:
                ones += 1
                if ones > 6:
                    raise UnstuffError("7 consecutive ones")
            out.append(bit)
            if bit == 0:
                if ones == 6:               # flag byte complete
                    if len(out) == 8:       # opening flag: drop and restart
                        out = []
                        ones = 0
                        continue
                    if len(out) < 8:
                        raise UnstuffError("flag at start of stream")
                    out = out[:-8]          # strip trailing flag
                    closed = True
                    break
                ones = 0
        yield np.array(out, dtype=np.uint8)
        if not closed:
            break
