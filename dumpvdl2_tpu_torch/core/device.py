"""Per-block device step: channelize, phase/power planes, detection.

Port of ``dumpvdl2_tpu/core/device.py``.  PyTorch runs eagerly, so
"one fused dispatch" becomes one function whose tensors all stay on the
input's device; only the compact results cross to the host later
(utils/fetch.py).
"""
from __future__ import annotations

import torch

from ..constants import SYNC_THRESHOLD
from ..dsp.demod import find_and_slice, find_candidates
from ..dsp.frontend import bandpass_channelize


def process_block(iq: torch.Tensor, taps: torch.Tensor, dphi: torch.Tensor,
                  n0: int, carry: torch.Tensor, hist: torch.Tensor,
                  oversample: int, halo: int,
                  threshold: float = SYNC_THRESHOLD,
                  max_candidates: int = 64, max_symbols: int = 5616):
    """One block through the full-slicing device pipeline.

    Args:
      iq: (2, N) planar wideband block.
      taps/dphi/n0: as in bandpass_channelize.
      carry: (2, T-1) raw wideband tail of the previous block.
      hist: (2, C, H) decimated halo from the previous block.
      halo: halo length to keep for the next block.
    Returns:
      (candidates, new_hist, new_carry, pwr3) where pwr3 is the power
      of every 3rd fresh decimated sample, (C, ceil(M/3)).
    """
    dec, new_carry = bandpass_channelize(iq, taps, dphi, n0, carry,
                                         oversample)
    block = torch.cat([hist, dec], dim=2)
    cands = find_and_slice(block, threshold, max_candidates, max_symbols)
    keep = min(halo, block.shape[2])
    new_hist = block[:, :, block.shape[2] - keep:].contiguous()
    pwr3 = dec[0, :, ::3] ** 2 + dec[1, :, ::3] ** 2
    return cands, new_hist, new_carry, pwr3


def detect_planes(block: torch.Tensor, threshold: float = SYNC_THRESHOLD,
                  max_candidates: int = 64, max_symbols: int = 5616):
    """Detections of a (2, C, M) planar decimated block, with its phase
    and power planes (C, M) for the sliced L2 step: ``(dets, phases,
    pwr)``."""
    phases = torch.atan2(block[1], block[0])
    pwr = block[0] * block[0] + block[1] * block[1]
    dets = find_candidates(phases, threshold, max_candidates, max_symbols)
    return dets, phases, pwr


def process_block_detect(iq: torch.Tensor, taps: torch.Tensor,
                         dphi: torch.Tensor, n0, carry: torch.Tensor,
                         hist: torch.Tensor, oversample: int, halo: int,
                         threshold: float = SYNC_THRESHOLD,
                         max_candidates: int = 64,
                         max_symbols: int = 5616, graph=None):
    """process_block without the symbol slicing (device-L2 path).

    Returns ``(dets, phases, pwr, new_hist, new_carry, pwr3)``: the
    decimated block's phase and power planes (halo + fresh) stay on the
    device so the compacted L2 step (core/pipeline.l2_sliced) slices
    windows for the real candidates only.  ``n0`` is an int or a 0-dim
    tensor (bandpass_channelize).  ``graph``, where given, is this step
    captured on these very tensors (core/graphs.py): the call replays
    it and returns copies of the detections and planes, and the graph's
    own buffers for the rest, which hold the new state.
    """
    if graph is not None:
        return graph.replay()
    dec, new_carry = bandpass_channelize(iq, taps, dphi, n0, carry,
                                         oversample)
    block = torch.cat([hist, dec], dim=2)
    dets, phases, pwr = detect_planes(block, threshold, max_candidates,
                                      max_symbols)
    keep = min(halo, block.shape[2])
    new_hist = block[:, :, block.shape[2] - keep:].contiguous()
    # noise-tracker stream: every 3rd decimated power of the fresh part
    pwr3 = pwr[:, hist.shape[2]::3].contiguous()
    return dets, phases, pwr, new_hist, new_carry, pwr3
