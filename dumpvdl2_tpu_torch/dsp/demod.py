"""Block-batched D8PSK frame sync and symbol slicer.

Port of ``dumpvdl2_tpu/dsp/demod.py``: the preamble sync metric is
evaluated at every decimated sample (kernel K1 on CUDA, see
dsp/sync_kernel.py), sync points are below-threshold local minima of
the metric with parabolic-vertex symbol-clock interpolation, and all
candidate bursts of a block are demodulated in one batched gather.
There is no dispatch switch: the K1 wrapper decides by the tensor's
device.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..constants import ARITY, GRAYCODE, SPS, SYNC_THRESHOLD
from .sync_kernel import LOOKBACK, sync_error_metric

_NMS_WIN = 2 * SPS    # duplicate-crossing suppression window (samples)
# Segmented first-K extraction: NMS-kept detections are > _NMS_WIN
# apart, so a _SEG-sample segment holds at most _SEG_P of them.
_SEG = 128
_SEG_P = (_SEG - 1) // (_NMS_WIN + 1) + 2
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


class Detections(NamedTuple):
    """Candidate set without the sliced symbol/power windows."""
    count: torch.Tensor      # (C,) int32
    det_idx: torch.Tensor    # (C, K) int32
    sync_idx: torch.Tensor   # (C, K) int32
    dphi: torch.Tensor       # (C, K) f32
    pherr: torch.Tensor      # (C, K) f32
    sym_valid: torch.Tensor  # (C, K) int32


def _parabola_vertex(y1: torch.Tensor, y2: torch.Tensor,
                     y3: torch.Tensor) -> torch.Tensor:
    """Vertex x of the parabola through (-2,y1), (-1,y2), (0,y3)."""
    a = (y1 - 2.0 * y2 + y3) / 2.0
    b = (3.0 * y3 - 4.0 * y2 + y1) / 2.0
    safe = torch.abs(a) > 1e-12
    return torch.where(safe, -b / (2.0 * torch.where(safe, a, 1.0)), -1.0)


def find_candidates(phases: torch.Tensor,
                    threshold: float = SYNC_THRESHOLD,
                    max_candidates: int = 64, max_symbols: int = 5616,
                    detect_lo: int = 0, detect_hi: int | None = None
                    ) -> Detections:
    """Locate sync points in a block (detection only, no slicing).

    ``phases``: (C, M) float32 sample phases.  Detections may fire only
    in ``[detect_lo, detect_hi)``.
    """
    C, M = phases.shape
    K, S = max_candidates, max_symbols
    dev = phases.device
    err, freq = sync_error_metric(phases.contiguous())

    # Detection: the metric passed a below-threshold local minimum.
    e1 = torch.roll(err, 1, dims=1)
    mask = (e1 < threshold) & (err > e1)
    mask[:, :max(LOOKBACK + 2, detect_lo)] = False
    if detect_hi is not None and detect_hi < M:
        mask[:, detect_hi:] = False

    # Keep only cluster leaders: a detection with another crossing in
    # the preceding _NMS_WIN samples is the same dip re-crossed.
    cs = torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32)
    hi = torch.roll(cs, 1, dims=1)
    hi[:, 0] = 0                                        # cs[i-1]
    lo = torch.roll(cs, _NMS_WIN + 1, dims=1)
    lo[:, :_NMS_WIN + 1] = 0                            # cs[i-W-1]
    mask = mask & ((hi - lo) == 0)

    # First K detections per channel, in time order: each _SEG-sample
    # segment holds at most _SEG_P detections, so extract them by
    # within-segment rank and take the K smallest positions of the
    # small (C, G*P) table.  Empty slots carry the sentinel M.
    pos = torch.where(mask, torch.arange(M, dtype=torch.int64, device=dev),
                      M)
    G = -(-M // _SEG)
    pad_m = G * _SEG - M
    m3 = torch.nn.functional.pad(mask, (0, pad_m)).reshape(C, G, _SEG)
    pos3 = torch.nn.functional.pad(pos, (0, pad_m), value=M) \
        .reshape(C, G, _SEG)
    seg_rank = torch.cumsum(m3.to(torch.int32), dim=2, dtype=torch.int32) - 1
    segpos = [torch.where(m3 & (seg_rank == p), pos3, M).amin(dim=2)
              for p in range(_SEG_P)]
    flat = torch.stack(segpos, dim=2).reshape(C, G * _SEG_P)
    if G * _SEG_P < K:
        flat = torch.nn.functional.pad(flat, (0, K - G * _SEG_P), value=M)
    neg, _ = torch.topk(-flat, K, dim=1, sorted=True)
    det_sorted = -neg                                   # ascending
    valid = det_sorted < M
    det_idx = torch.where(valid, det_sorted, -1)
    count = mask.sum(dim=1).to(torch.int32)

    def take(arr, idx):
        return torch.gather(arr, 1, torch.clamp(idx, min=0))

    y3 = take(err, det_idx)
    y2 = take(err, det_idx - 1)
    y1 = take(err, det_idx - 2)
    vertex = _parabola_vertex(y1, y2, y3)
    sclk = torch.round(-vertex)
    sclk = torch.where(valid, sclk, 0.0).to(torch.int64)
    sync_idx = torch.where(valid, det_idx - sclk, -1)
    dphi = take(freq, det_idx - 1)
    pherr = y2

    # number of demodulable symbols: sp + SPS*j must stay inside M
    nvalid = torch.clamp(torch.div(M - 1 - sync_idx, SPS,
                                   rounding_mode="floor"), 0, S)
    sym_valid = torch.where(valid, nvalid, 0)
    return Detections(count=count, det_idx=det_idx.to(torch.int32),
                      sync_idx=sync_idx.to(torch.int32), dphi=dphi,
                      pherr=pherr, sym_valid=sym_valid.to(torch.int32))


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
