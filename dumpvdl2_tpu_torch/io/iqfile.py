"""Raw IQ file/stream input (U8 or S16_LE interleaved).

Matches the reference's ``process_iq_file`` behavior (dumpvdl2.c:323-358):
the file is treated as headerless interleaved I/Q at the configured
sample format -- even .wav fixtures are read raw, RIFF header included,
exactly as the reference does.

:func:`feed_iq_file` drives a stream into a pipeline: raw bytes into
pinned staging buffers and through ``VDL2Pipeline.feed_raw``, which
converts them on the device (the mesh's ``feed_raw`` dequantizes them
on the host, as :func:`iq_blocks` does, and calls ``feed``).
"""
from __future__ import annotations

import time
from typing import BinaryIO, Callable, Iterator

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


def _fill(fh: BinaryIO, buf: np.ndarray) -> int:
    """Read into ``buf`` until it is full or the stream ends (a pipe or
    a raw stream may return short reads); the bytes read."""
    view = memoryview(buf)
    got = 0
    while got < len(view):
        n = fh.readinto(view[got:])
        if not n:
            break
        got += n
    return got


def feed_iq_file(pipe, decoder, fh: BinaryIO, sample_format: str,
                 read_bytes: int = FILE_BUFSIZE,
                 stop: Callable[[], bool] | None = None,
                 finish: bool = True) -> None:
    """Feed the raw IQ stream ``fh`` into ``pipe`` in reads of
    ``read_bytes`` bytes, every returned frame to
    ``decoder.process_all``, then (``finish``) the pipeline's
    ``finish()``.  Stops at the end of the stream or, between two
    blocks, once ``stop()`` says so.

    Each read fills the next of the pipeline's two staging buffers
    (``pipe.staging``, pinned on CUDA) with ``readinto``, waiting first
    for that buffer's last copy to the device to be done (the
    pipeline's ``span_log.counts``: ``read_bytes``, ``staging_waits``),
    and goes to ``pipe.feed_raw``, which carries the partial sample
    pair at a buffer's end into the next, so the samples are
    ``iq_blocks``'."""
    bufs, events = pipe.staging(read_bytes)
    counts = pipe.span_log.counts
    k = 0
    while stop is None or not stop():
        if events[k] is not None and not events[k].query():
            counts["staging_waits"] += 1
            events[k].synchronize()
        t0 = time.perf_counter_ns()
        n = _fill(fh, bufs[k].numpy())
        t1 = time.perf_counter_ns()
        if not n:
            break
        counts["read_bytes"] += n
        decoder.process_all(pipe.feed_raw(
            bufs[k][:n], sample_format, copied=events[k], read=(t0, t1)))
        k ^= 1
        if n < read_bytes:
            break
    if finish:
        decoder.process_all(pipe.finish())
