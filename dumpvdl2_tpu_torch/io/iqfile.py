"""Raw IQ file/stream input (U8 or S16_LE interleaved).

Matches the reference's ``process_iq_file`` behavior (dumpvdl2.c:323-358):
the file is treated as headerless interleaved I/Q at the configured
sample format -- even .wav fixtures are read raw, RIFF header included,
exactly as the reference does.
"""
from __future__ import annotations

from typing import BinaryIO, Iterator

import numpy as np

from ..constants import FILE_BUFSIZE

SAMPLE_FORMATS = ("U8", "S16_LE")


def dequantize_block(buf: bytes, sample_format: str) -> np.ndarray:
    """bytes -> complex64 baseband block (host-side reference path)."""
    if sample_format == "U8":
        raw = np.frombuffer(buf, dtype=np.uint8).astype(np.float32)
        flat = (raw - 127.5) / 127.5
    elif sample_format == "S16_LE":
        raw = np.frombuffer(buf, dtype="<i2").astype(np.float32)
        flat = raw / 32768.0
    else:
        raise ValueError(f"unknown sample format {sample_format!r}")
    n = (flat.size // 2) * 2
    flat = flat[:n]
    return (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)


def iq_blocks(fh: BinaryIO, sample_format: str,
              bufsize: int = FILE_BUFSIZE) -> Iterator[np.ndarray]:
    """Yield dequantized complex blocks from a raw IQ stream."""
    itemsize = 1 if sample_format == "U8" else 2
    # keep sample pairs intact across reads
    pending = b""
    while True:
        chunk = fh.read(bufsize)
        if not chunk:
            break
        buf = pending + chunk
        usable = (len(buf) // (2 * itemsize)) * (2 * itemsize)
        pending = buf[usable:]
        if usable:
            yield dequantize_block(buf[:usable], sample_format)
