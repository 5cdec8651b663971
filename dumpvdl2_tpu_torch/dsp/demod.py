"""Block-batched D8PSK frame sync and symbol slicer.

Port of ``dumpvdl2_tpu/dsp/demod.py``: the preamble sync metric is
evaluated at every decimated sample (kernel K1 on CUDA, see
dsp/sync_kernel.py), sync points are below-threshold local minima of
the metric with parabolic-vertex symbol-clock interpolation (kernel KC
on CUDA, see dsp/candidates_kernel.py), and all candidate bursts of a
block are demodulated in one batched gather.  There is no dispatch
switch: the kernels' wrappers decide by the tensor's device.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..constants import ARITY, GRAYCODE, SPS, SYNC_THRESHOLD
from .candidates_kernel import Detections, candidates
from .sync_kernel import sync_error_metric

_TWO_PI = float(np.float32(2 * np.pi))
_QUARTER_PI = float(np.float32(np.pi / 4))


class Candidates(NamedTuple):
    """Fixed-size per-block candidate set (per channel)."""
    count: torch.Tensor      # (C,) int32 number of valid candidates
    det_idx: torch.Tensor    # (C, K) int32 detection index, -1 if unused
    sync_idx: torch.Tensor   # (C, K) int32 sync point (symbol clock origin)
    dphi: torch.Tensor       # (C, K) f32 freq offset per symbol
    pherr: torch.Tensor      # (C, K) f32 metric at the minimum
    symbols: torch.Tensor    # (C, K, S) uint8 gray-decoded 3-bit symbols
    sym_valid: torch.Tensor  # (C, K) int32 number of demodulable symbols
    power: torch.Tensor      # (C, K, S) f32 per-symbol power


def find_candidates(phases: torch.Tensor,
                    threshold: float = SYNC_THRESHOLD,
                    max_candidates: int = 64, max_symbols: int = 5616,
                    detect_lo: int = 0, detect_hi: int | None = None
                    ) -> Detections:
    """Locate sync points in a block (detection only, no slicing).

    ``phases``: (C, M) float32 sample phases.  Detections may fire only
    in ``[detect_lo, detect_hi)``.
    """
    err, freq = sync_error_metric(phases.contiguous())
    return candidates(err, freq, threshold, max_candidates, max_symbols,
                      detect_lo, detect_hi)


def demod_window(sym_phase: torch.Tensor, power_all: torch.Tensor,
                 dphi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """D8PSK-demodulate sliced symbol windows.

    ``sym_phase``/``power_all``: (..., S+1) phase / power at the symbol
    clock; ``dphi``: (...,) fitted per-symbol frequency offset.
    Returns (symbols uint8, power float32), each (..., S).
    """
    dev = sym_phase.device
    dp = sym_phase[..., 1:] - sym_phase[..., :-1] - dphi[..., None]
    dp = torch.where(dp < 0, dp + _TWO_PI, dp)
    dp = torch.where(dp > _TWO_PI, dp - _TWO_PI, dp)
    # divide by a device tensor: a Python-scalar divisor is turned into
    # a reciprocal multiply on CUDA, which rounds differently
    q = dp / torch.full((1,), _QUARTER_PI, dtype=torch.float32, device=dev)
    idx = torch.remainder(torch.round(q).to(torch.int64), ARITY)
    return _gray(dev)[idx], power_all[..., 1:]


@functools.lru_cache(maxsize=4)
def _gray(device: torch.device) -> torch.Tensor:
    """The Gray-code table, uploaded once per device: a blocking copy
    from host memory at every call would wait for all the work queued
    on the device before it."""
    return torch.as_tensor(np.array(GRAYCODE, np.uint8), device=device)


def slice_windows(plane: torch.Tensor, rows: torch.Tensor,
                  starts: torch.Tensor, n: int) -> torch.Tensor:
    """``plane[rows, start + SPS*s]`` for s < n, zero past the end.

    Equivalent to padding ``plane`` (C, M) with zeros and taking a
    dynamic slice of SPS*(n-1)+1 samples strided by SPS at
    ``clip(start, 0, M)``, without materializing the raw-rate windows.
    """
    M = plane.shape[1]
    start = torch.clamp(starts.to(torch.int64), 0, M)
    idx = start[:, None] + SPS * torch.arange(n, dtype=torch.int64,
                                              device=plane.device)
    inside = idx < M
    flat = rows.to(torch.int64)[:, None] * M + torch.clamp(idx, max=M - 1)
    vals = plane.reshape(-1)[flat.reshape(-1)].reshape(idx.shape)
    return torch.where(inside, vals, 0.0)


def find_and_slice(iq: torch.Tensor, threshold: float = SYNC_THRESHOLD,
                   max_candidates: int = 64, max_symbols: int = 5616,
                   detect_lo: int = 0, detect_hi: int | None = None
                   ) -> Candidates:
    """Locate sync points in a block and demodulate candidate bursts.

    ``iq``: (2, C, M) float32 planar decimated channel samples (halo
    already prepended by the caller).
    """
    _, C, M = iq.shape
    K, S = max_candidates, max_symbols
    re, im = iq[0], iq[1]
    phases = torch.atan2(im, re)
    d = find_candidates(phases, threshold, K, S, detect_lo, detect_hi)
    pwr = re * re + im * im
    rows = torch.arange(C, device=iq.device).repeat_interleave(K)
    starts = d.sync_idx.reshape(C * K)
    sym_phase = slice_windows(phases, rows, starts, S + 1).reshape(C, K, S + 1)
    power_all = slice_windows(pwr, rows, starts, S + 1).reshape(C, K, S + 1)
    symbols, power = demod_window(sym_phase, power_all, d.dphi)
    return Candidates(count=d.count, det_idx=d.det_idx,
                      sync_idx=d.sync_idx, dphi=d.dphi, pherr=d.pherr,
                      symbols=symbols, sym_valid=d.sym_valid,
                      power=power)
