"""Shared plumbing for the two SDRPlay driver generations.

Both reference drivers (sdrplay.c:72-134, sdrplay3.c:54-112) receive
separate I and Q short arrays from the vendor callback, interleave them
into a circular byte buffer and forward fixed-size blocks downstream.
In the block pipeline the natural equivalent is: the callback (called
on a vendor thread) interleaves I/Q into one int16 numpy array and
enqueues it; the main thread drains the queue, scales to float
(/32768.0, reference demod.c:356-365) and feeds the pipeline.
"""
from __future__ import annotations

import queue
import sys
import threading

import numpy as np

# reference dumpvdl2.h:173 — sentinel for "gain not specified"
SDR_AUTO_GAIN = -100


class StreamBridge:
    """Vendor-callback → pipeline-pull adapter.

    ``push(xi, xq, n)`` is invoked from the SDRPlay API worker thread
    with ctypes short pointers; interleaved int16 IQ lands on a bounded
    queue (drop-with-warning backpressure mirroring the output HWM
    discipline).  ``blocks()`` yields complex64 arrays until ``stop()``.
    """

    def __init__(self, max_pairs: int = 8_400_000) -> None:
        # Capacity is bounded by buffered IQ *pairs*, not vendor packets:
        # one packet is only ~250-500 pairs (~0.2 ms at 2.1 Msps), so a
        # packet-count bound gives milliseconds of slack while the
        # reference's 15x512k-short ring holds ~1.8 s (sdrplay3.c:54-113).
        # Default 8.4M pairs = 4 s at 2.1 Msps, enough to ride out the
        # first-block JIT compilation stall without dropping samples.
        self._q: queue.Queue = queue.Queue()
        self._max_pairs = max_pairs
        self._buffered_pairs = 0
        self._lock = threading.Lock()
        self._stopped = False
        self.overflows = 0

    def push(self, xi, xq, n: int) -> None:
        if n <= 0 or self._stopped:
            return
        with self._lock:
            if self._buffered_pairs + n > self._max_pairs:
                self.overflows += 1
                if self.overflows % 1000 == 1:
                    print("sdrplay: sample queue overflow, dropping samples",
                          file=sys.stderr)
                return
            self._buffered_pairs += n
        i = np.ctypeslib.as_array(xi, shape=(n,))
        q = np.ctypeslib.as_array(xq, shape=(n,))
        iq = np.empty(2 * n, dtype=np.int16)
        iq[0::2] = i
        iq[1::2] = q
        self._q.put_nowait(iq)

    def stop(self) -> None:
        self._stopped = True
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass

    def blocks(self, exit_requested, min_samples: int = 1 << 18):
        """Yield complex64 blocks of at least ``min_samples`` IQ pairs
        (except the final flush), polling the exit flag between gets."""
        parts, have = [], 0
        while not exit_requested():
            try:
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            if item is None:
                break
            with self._lock:
                self._buffered_pairs -= item.size // 2
            parts.append(item)
            have += item.size // 2
            if have >= min_samples:
                yield _to_complex(np.concatenate(parts))
                parts, have = [], 0
        if parts:
            yield _to_complex(np.concatenate(parts))


def _to_complex(interleaved_s16: np.ndarray) -> np.ndarray:
    f = interleaved_s16.astype(np.float32) / 32768.0
    return f[0::2] + 1j * f[1::2]
