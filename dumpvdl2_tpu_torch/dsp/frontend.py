"""Channelizer front end: dequantize -> NCO-folded band-pass -> decimate.

Port of ``dumpvdl2_tpu/dsp/frontend.py``.  All channels are mixed from
one shared wideband block: the 24-bit fixed-point NCO (reference
demod.c:312-317,385) is folded into per-channel complex band-pass taps,
the strided FIR runs over the shared block, and the channel mix becomes
a residual rotation at the decimated rate.  Where the channels sit on
one uniform grid (every cell of the CLI's rule: a 25 kHz grid tuned at
its middle), the filtering is a polyphase filter bank, kernel KP on
CUDA (dsp/pfb_kernel.py); for any other channel set it is ONE
(M, 2T) x (2T, 2C) float32 im2col matmul.

Complex samples are planar float32 pairs (leading axis 2 = [re, im]).
The NCO phase accumulator wraps modulo 2^24; PyTorch has no full
uint32 arithmetic, so phases are computed in int64 and masked with
``& 0xFFFFFF`` (every product stays below 2^56, so this is exact).

``mix_nco`` and ``mix_filter_decimate_impl`` keep the direct formulation
(mix every channel at the input rate, then filter and decimate) as the
oracle the channelizer is held to; no pipeline runs them.
"""
from __future__ import annotations

import numpy as np
import torch

from . import pfb_kernel

_TWO_PI_OVER_2_24 = float(np.float32(2.0 * np.pi / float(1 << 24)))
_MASK24 = 0xFFFFFF
# bandpass_channelize's ``plan`` where the caller gives none: made from
# the taps and channels at the call
FROM_TAPS = object()


def dequantize_u8(raw: torch.Tensor) -> torch.Tensor:
    """Map unsigned 8-bit samples onto (-1, 1) (demod.c:349-354)."""
    return (raw.to(torch.float32) - 127.5) / 127.5


def dequantize_s16(raw: torch.Tensor) -> torch.Tensor:
    """Map signed 16-bit samples onto [-1, 1) (demod.c:356-365)."""
    return raw.to(torch.float32) / 32768.0


def to_planar(iq: np.ndarray) -> np.ndarray:
    """Host complex array -> (2, N) float32 planar layout."""
    return np.stack([iq.real, iq.imag]).astype(np.float32)


def prepare_taps(taps: np.ndarray, oversample: int) -> np.ndarray:
    """Zero-pad taps to a multiple of the decimation factor (trailing
    zeros multiply samples older than the impulse response, so the
    output is unchanged)."""
    pad = (-len(taps)) % oversample
    return np.concatenate([np.asarray(taps, np.float32),
                           np.zeros(pad, np.float32)])


def nco_dphi(centerfreq: float, freq: float, sample_rate: float) -> np.uint32:
    """24-bit fixed-point NCO increment, matching demod.c:385."""
    return np.uint32(np.int64(int((float(centerfreq) - float(freq))
                                  / float(sample_rate) * 256.0 * 65536.0)))


def _nco_angle(idx: torch.Tensor, dphi: torch.Tensor) -> torch.Tensor:
    """(C, len(idx)) float32 NCO angle ((idx * dphi) mod 2^24) * 2pi/2^24.

    ``idx`` and ``dphi`` are int64 holding uint32 values; only the low
    24 bits of the product matter, so ``idx`` is reduced first to keep
    the int64 product exact."""
    phi = ((idx & _MASK24)[None, :] * dphi[:, None]) & _MASK24
    return phi.to(torch.float32) * _TWO_PI_OVER_2_24


def mix_nco(iq: torch.Tensor, dphi: torch.Tensor, n0: int) -> torch.Tensor:
    """24-bit fixed-point NCO downmix (demod.c:312-317,385).

    ``iq``: (2, N) planar wideband samples whose first sample has
    global index ``n0`` (wraps mod 2^24); ``dphi``: (C,) int64 per-channel
    phase increments (uint32 values).  Returns (2, C, N) mixed samples.
    """
    n = n0 + torch.arange(iq.shape[1], dtype=torch.int64, device=iq.device)
    angle = _nco_angle(n, dphi)
    cosw, sinw = torch.cos(angle), torch.sin(angle)   # (C, N)
    re, im = iq[0], iq[1]
    # (re + j im) * (cos + j sin)
    return torch.stack([re[None, :] * cosw - im[None, :] * sinw,
                        im[None, :] * cosw + re[None, :] * sinw])


def mix_filter_decimate_impl(iq: torch.Tensor, taps: torch.Tensor,
                             dphi: torch.Tensor, n0: int,
                             carry: torch.Tensor, oversample: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The direct NCO-mix front end: mix every channel at the input
    rate, then filter and decimate.  No pipeline runs it; it is the
    oracle that :func:`bandpass_channelize` is held to.

    Args:
      iq: (2, N) float32 planar wideband block, N % oversample == 0.
      taps: (T,) float32 FIR taps, T % oversample == 0 (prepare_taps).
      dphi: (C,) int64 per-channel 24-bit NCO phase increments.
      n0: global index of iq[0] modulo 2^24.
      carry: (2, C, T-1) float32 mixed-sample history from the previous
        block (zeros at stream start).
    Returns:
      (decimated (2, C, N // oversample) float32, new_carry).
    """
    N = iq.shape[1]
    T = taps.shape[0]
    os_ = oversample
    mixed = mix_nco(iq, dphi, n0)                      # (2, C, N)

    z = torch.cat([carry, mixed], dim=2)               # (2, C, N + T - 1)
    new_carry = z[:, :, z.shape[2] - (T - 1):] if T > 1 else z[:, :, :0]

    # Polyphase convolution: output j (the first is filtered sample
    # os-1) is y[j] = sum_t zs[os*j + t] * taps_rev[t], t in [0, T);
    # splitting t = os*q + r makes the decimation phase r the
    # convolution's input channel and q its window
    C2 = 2 * z.shape[1]
    Q = T // os_
    zs = z[:, :, os_ - 1:]
    frames_n = zs.shape[2] // os_
    frames = zs[:, :, :frames_n * os_].reshape(C2, frames_n, os_) \
        .transpose(1, 2)                               # (2C, os, I)
    kernel = taps.flip(0).reshape(Q, os_).T[None]      # (1, os, Q)
    dec = torch.nn.functional.conv1d(frames, kernel)[:, 0, :]
    M = N // os_
    return dec[:, :M].reshape(2, -1, M), new_carry


def bandpass_channelize(iq: torch.Tensor, taps: torch.Tensor,
                        dphi: torch.Tensor, n0: int | torch.Tensor,
                        raw_carry: torch.Tensor, oversample: int,
                        plan=FROM_TAPS
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One front-end block for all channels: the polyphase filter bank
    where there is a plan (:func:`pfb_kernel.plan_for`), else the im2col
    GEMM; both compute the same sum (the bank to the Taylor remainder's
    1e-7 of the output's RMS, and float32 rounding).

    Args:
      iq: (2, N) float32 planar wideband block, N % oversample == 0.
      taps: (T,) float32 FIR taps, T % oversample == 0 (prepare_taps).
      dphi: (C,) int64 per-channel 24-bit NCO phase increments (uint32
        values, see nco_dphi).
      n0: global index of iq[0] modulo 2^24: an int, or a 0-dim int64
        tensor on iq's device (a CUDA graph's input, core/graphs.py),
        which gives the same result.
      raw_carry: (2, T-1) float32 raw wideband tail of the previous
        block (zeros at stream start).
      plan: the bank's :class:`pfb_kernel.Plan` for these taps, channels
        and oversample, or None for the GEMM; by default made here from
        the taps' values (a copy to the host, not allowed inside a CUDA
        graph's capture), so a caller that runs block after block makes
        it once and passes it.
    Returns:
      (decimated (2, C, N // oversample) float32, new_raw_carry).
    """
    if plan is FROM_TAPS:
        plan = pfb_kernel.plan_for(taps, dphi, oversample)
    if plan is None:
        return gemm_channelize(iq, taps, dphi, n0, raw_carry, oversample)
    # the raw tail of [raw_carry, iq], as the GEMM path keeps it
    N, T = iq.shape[1], taps.shape[0]
    if N >= T - 1:
        new_carry = iq[:, N - (T - 1):].clone(
            memory_format=torch.contiguous_format)
    else:
        new_carry = torch.cat([raw_carry[:, N:], iq], dim=1)
    if iq.stride(1) != 1:
        iq = iq.contiguous()
    return pfb_kernel.pfb(iq, raw_carry, plan, n0), new_carry


def gemm_channelize(iq: torch.Tensor, taps: torch.Tensor,
                    dphi: torch.Tensor, n0: int | torch.Tensor,
                    raw_carry: torch.Tensor, oversample: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """bandpass_channelize as one im2col GEMM, for any channel set: the
    JAX package's formulation, and the channelizer where the bank has
    no plan."""
    N = iq.shape[1]
    T = taps.shape[0]
    os_ = oversample
    C = dphi.shape[0]
    M = N // os_
    dev = iq.device

    # Complex band-pass taps (C, T): conjugate NCO phase at tap offset u
    u = torch.arange(T, dtype=torch.int64, device=dev)
    ang_t = _nco_angle(u, dphi)
    cr = taps[None, :] * torch.cos(ang_t)
    ci = -taps[None, :] * torch.sin(ang_t)
    cr_rev, ci_rev = cr.flip(1), ci.flip(1)
    # (2C, 2, T) kernel, plane-major rows: w_re = x_re*cr - x_im*ci,
    # w_im = x_re*ci + x_im*cr
    kernel = torch.stack([torch.stack([cr_rev, -ci_rev], dim=1),
                          torch.stack([ci_rev, cr_rev], dim=1)], dim=0)
    kernel = kernel.reshape(2 * C, 2 * T)

    xe = torch.cat([raw_carry, iq], dim=1)             # (2, N + T - 1)
    new_carry = xe[:, xe.shape[1] - (T - 1):].clone() if T > 1 \
        else iq[:, :0].clone()
    # im2col: frames[j, p, q*os + r] = xe[p, os*(j+q) + r + os-1]
    Q = T // os_
    xr = xe[:, os_ - 1:]
    need = os_ * (M + Q)
    if need > xr.shape[1]:
        xr = torch.nn.functional.pad(xr, (0, need - xr.shape[1]))
    X = xr[:, :need].reshape(2, M + Q, os_)
    frames = X.unfold(1, Q, 1)[:, :M]                  # (2, M, os, Q)
    frames = frames.permute(1, 0, 3, 2).reshape(M, 2 * T)
    w = kernel @ frames.T                              # (2C, M) float32
    wr, wi = w[:C], w[C:]

    return residual_rotation(wr, wi, dphi, n0, os_), new_carry


def residual_rotation(wr: torch.Tensor, wi: torch.Tensor,
                      dphi: torch.Tensor, n0: int | torch.Tensor,
                      oversample: int) -> torch.Tensor:
    """(2, C, M) float32: the (C, M) filtered channels (wr, wi) turned
    by e^{+j phi(G_j)}, the NCO phase at G_j = n0 + os*(j+1) - 1."""
    M = wr.shape[1]
    g = n0 + (torch.arange(M, dtype=torch.int64, device=wr.device) + 1) \
        * oversample - 1
    ang_g = _nco_angle(g, dphi)
    cg, sg = torch.cos(ang_g), torch.sin(ang_g)
    return torch.stack([wr * cg - wi * sg, wi * cg + wr * sg])
