"""Candidate search: CUDA kernel KC and its plain twin.

:func:`candidates` is what the detector calls after the sync metric
(kernel K1): it turns K1's ``(err, freq)`` into the block's
:class:`Detections`.  On a CUDA tensor it launches the hand-written
kernel ``csrc/candidates.cu`` or raises; on a CPU tensor it runs
:func:`candidates_plain`, the port of the XLA stage
``dumpvdl2_tpu/dsp/demod.py:find_candidates_impl`` after ``_metric``.

Contract (both paths): ``err`` and ``freq`` are (C, M) float32.  A
detection is a below-threshold local minimum of ``err`` inside
``[max(LOOKBACK + 2, detect_lo), detect_hi)``; only cluster leaders
count (no other crossing in the ``_NMS_WIN`` samples before).  Returns
the leader count of each row (uncapped) and the first K leaders in time
order with their parabola-vertex sync points, frequencies, metric
values and demodulable symbol counts.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..constants import SPS
from .sync_kernel import LOOKBACK

_NMS_WIN = 2 * SPS    # duplicate-crossing suppression window (samples)
# Segmented first-K extraction: NMS-kept detections are > _NMS_WIN
# apart, so a _SEG-sample segment holds at most _SEG_P of them.
_SEG = 128
_SEG_P = (_SEG - 1) // (_NMS_WIN + 1) + 2

# Kernel launches since start (or the last reset by the caller); only
# the CUDA path counts.
launches = 0


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


def candidates_plain(err: torch.Tensor, freq: torch.Tensor,
                     threshold: float, max_candidates: int,
                     max_symbols: int, detect_lo: int = 0,
                     detect_hi: int | None = None) -> Detections:
    """Plain KC (port of find_candidates_impl after the metric)."""
    C, M = err.shape
    K, S = max_candidates, max_symbols
    dev = err.device

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


def detect_window(M: int, detect_lo: int, detect_hi: int | None
                  ) -> tuple[int, int]:
    """The columns ``[lo, hi)`` in which the plain version's mask may
    keep a detection, clipped to ``[0, M]``: its slice assignments
    ``mask[:, :max(LOOKBACK + 2, detect_lo)]`` and, for ``detect_hi <
    M``, ``mask[:, detect_hi:]`` (a negative ``detect_hi`` counts from
    the end, as a slice does)."""
    lo = min(max(LOOKBACK + 2, detect_lo), M)
    hi = M
    if detect_hi is not None and detect_hi < M:
        hi = max(detect_hi + M, 0) if detect_hi < 0 else detect_hi
    return lo, hi


def _check(name: str, x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{name} must be 2-D float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def candidates_cuda(err: torch.Tensor, freq: torch.Tensor,
                    threshold: float, max_candidates: int,
                    max_symbols: int, detect_lo: int = 0,
                    detect_hi: int | None = None) -> Detections:
    """Launch kernel KC on the current stream (no fallback).  Arguments
    and results as :func:`candidates_plain`."""
    global launches
    dev = err.device
    if dev.type != "cuda":
        raise ValueError("candidates_cuda needs CUDA tensors")
    _check("err", err, dev)
    _check("freq", freq, dev)
    if freq.shape != err.shape:
        raise ValueError(f"freq {tuple(freq.shape)} and err "
                         f"{tuple(err.shape)} differ")
    C, M = err.shape
    K, S = int(max_candidates), int(max_symbols)
    if not 0 < M < 2 ** 31 or K < 0 or S < 0:       # C ints in the kernel
        raise ValueError(f"unsupported shape {(C, M)} with K={K}, S={S}")
    lo, hi = detect_window(M, int(detect_lo), detect_hi)
    # one allocation: count, det_idx, sync_idx, sym_valid, then the floats
    buf = torch.empty(C + 5 * C * K, dtype=torch.int32, device=dev)
    count = buf[:C]
    det_idx, sync_idx, sym_valid, dphi, pherr = (
        buf[C + i * C * K:C + (i + 1) * C * K].reshape(C, K)
        for i in range(5))
    dphi, pherr = dphi.view(torch.float32), pherr.view(torch.float32)
    if C:
        from .. import kernels
        fn = kernels.load("candidates").candidates_launch
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 2
                           + [ctypes.c_int] * 2 + [ctypes.c_float]
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7)
            fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(err.data_ptr(), freq.data_ptr(), C, M, threshold, K, S,
                    lo, hi, count.data_ptr(), det_idx.data_ptr(),
                    sync_idx.data_ptr(), dphi.data_ptr(), pherr.data_ptr(),
                    sym_valid.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"candidates kernel launch failed: CUDA "
                               f"error {rc}")
        launches += 1
    return Detections(count=count, det_idx=det_idx, sync_idx=sync_idx,
                      dphi=dphi, pherr=pherr, sym_valid=sym_valid)


def candidates(err: torch.Tensor, freq: torch.Tensor, threshold: float,
               max_candidates: int, max_symbols: int, detect_lo: int = 0,
               detect_hi: int | None = None) -> Detections:
    """KC on the tensors' device: the kernel on CUDA, plain on CPU."""
    if err.device.type == "cuda":
        return candidates_cuda(err, freq, threshold, max_candidates,
                               max_symbols, detect_lo, detect_hi)
    if err.device.type == "cpu":
        return candidates_plain(err, freq, threshold, max_candidates,
                                max_symbols, detect_lo, detect_hi)
    raise ValueError(f"unsupported device {err.device}")
