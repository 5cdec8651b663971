"""Chebyshev type-I lowpass design (Smith's recipe) and FIR conversion.

The air interface calls for an anti-alias lowpass ahead of the 10x-20x
decimation to 105 kHz.  The reference uses a 2-pole Chebyshev IIR
designed with the recipe from "The Scientist and Engineer's Guide to
Digital Signal Processing" (S. Smith), ch. 20 (chebyshev.c:32-119).  An
IIR is the wrong shape for a TPU -- it is a sequential recurrence -- so
we design the *same transfer function* with the same published recipe
and then truncate its impulse response into FIR taps: convolution +
strided decimation maps onto the MXU, is numerically identical to the
IIR up to the truncation tail (< 1e-7), and keeps the "Chebyshev
characteristic" the baseline requires.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

MAX_POLES = 20
MAX_RIPPLE = 29.0


def _pole_biquad(p: int, cutoff: float, ripple: float, npoles: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Biquad (a0,a1,a2), (b1,b2) for pole pair ``p`` (1-based).

    Implements the published Smith ch.20 table 20-5 algorithm: place the
    pole pair on the unit circle, warp for the ripple ellipse, apply the
    matched-z prototype at fc=1/(2*pi), then the lowpass-to-lowpass
    frequency transform to ``cutoff`` (fraction of the sample rate).
    """
    angle = math.pi / (2 * npoles) + (p - 1) * math.pi / npoles
    rp = -math.cos(angle)
    ip = math.sin(angle)
    if ripple != 0.0:
        es = math.sqrt((100.0 / (100.0 - ripple)) ** 2 - 1.0)
        vx = (1.0 / npoles) * math.log(1.0 / es + math.sqrt(1.0 / es ** 2 + 1.0))
        kx = (1.0 / npoles) * math.log(1.0 / es + math.sqrt(1.0 / es ** 2 - 1.0))
        kx = math.cosh(kx)
        rp *= math.sinh(vx) / kx
        ip *= math.cosh(vx) / kx
    t = 2.0 * math.tan(0.5)
    w = 2.0 * math.pi * cutoff
    m = rp * rp + ip * ip
    d = 4.0 - 4.0 * rp * t + m * t * t
    x0 = t * t / d
    x1 = 2.0 * x0
    x2 = x0
    y1 = (8.0 - 2.0 * m * t * t) / d
    y2 = (-4.0 - 4.0 * rp * t - m * t * t) / d
    k = math.sin(0.5 - w / 2.0) / math.sin(0.5 + w / 2.0)
    d = 1.0 + y1 * k - y2 * k * k
    a = np.array([
        (x0 - x1 * k + x2 * k * k) / d,
        (-2.0 * x0 * k + x1 + x1 * k * k - 2.0 * x2 * k) / d,
        (x0 * k * k - x1 * k + x2) / d,
    ])
    b = np.array([
        (2.0 * k + y1 + y1 * k * k - 2.0 * y2 * k) / d,
        (-(k * k) - y1 * k + y2) / d,
    ])
    return a, b


def design_lpf(cutoff: float, ripple: float, npoles: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Cascade the biquads and normalize DC gain to 1.

    Returns (a, b): feedforward taps a[0..npoles] and feedback taps
    b[1..npoles] of  y[n] = sum a[i] x[n-i] + sum b[i] y[n-i].
    """
    if npoles <= 0 or npoles > MAX_POLES or npoles % 2:
        raise ValueError("npoles must be even and within range")
    if not (0.0 <= cutoff <= 0.5) or not (0.0 <= ripple <= MAX_RIPPLE):
        raise ValueError("bad cutoff or ripple")
    # polynomial accumulation: numerator/denominator products
    num = np.array([1.0])
    den = np.array([1.0])
    for p in range(1, npoles // 2 + 1):
        a, b = _pole_biquad(p, cutoff, ripple, npoles)
        num = np.convolve(num, a)
        den = np.convolve(den, np.concatenate([[1.0], -b]))
    a_out = np.zeros(npoles + 1)
    b_out = np.zeros(npoles + 1)
    a_out[:num.size] = num
    b_out[1:den.size] = -den[1:]
    gain = a_out.sum() / (1.0 - b_out[1:].sum())
    a_out /= gain
    return a_out, b_out


@lru_cache(maxsize=8)
def fir_taps(sample_rate: int, cutoff_hz: int = 8000,
             ripple_percent: float = 0.5, npoles: int = 2,
             tol: float = 1e-9) -> np.ndarray:
    """Truncated impulse response of the Chebyshev LPF as float32 taps.

    The poles sit close to the unit circle at these cutoffs, so the
    response decays geometrically; taps are truncated where the tail
    falls below ``tol`` of the peak.
    """
    a, b = design_lpf(cutoff_hz / sample_rate, ripple_percent, npoles)
    max_taps = 1 << 16
    h = np.zeros(max_taps)
    x = np.zeros(npoles + 1)
    y = np.zeros(npoles + 1)
    for n in range(max_taps):
        x[1:] = x[:-1]
        x[0] = 1.0 if n == 0 else 0.0
        # direct form: y[n] = sum_i a[i] x[n-i] + sum_i b[i] y[n-i]
        val = float((a * x).sum() + (b[1:] * y[:npoles]).sum())
        y[1:] = y[:-1]
        y[0] = val
        h[n] = val
    peak = np.abs(h).max()
    nz = np.nonzero(np.abs(h) > tol * peak)[0]
    ntaps = int(nz[-1]) + 1 if nz.size else 1
    # round up so strided reshapes stay aligned
    ntaps = -(-ntaps // 16) * 16
    return h[:ntaps].astype(np.float32)
