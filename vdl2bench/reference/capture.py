"""The capture file as a plain reader sees it: a headerless interleaved
S16_LE I/Q file (dumpvdl2's ``process_iq_file``), each value over
32 768, deinterleaved into planar (2, n) float32 samples.

It imports nothing of the program; the file loop (loops/file.py) hands
what it reads to the check as the stream the program was fed.
"""
from __future__ import annotations

import numpy as np
import torch

FULL_SCALE = 32768.0          # an S16 value of 32 768 is 1.0


def read(path: str, device) -> torch.Tensor:
    """(2, n) float32 samples of the S16_LE capture at ``path``, on
    ``device``; a trailing partial pair is dropped."""
    x = np.fromfile(path, "<i2")
    n = x.size // 2
    v = x[:2 * n].astype(np.float32) / np.float32(FULL_SCALE)
    return torch.as_tensor(np.ascontiguousarray(v.reshape(n, 2).T),
                           device=device)
