"""Polyphase filter bank: CUDA kernel KP and its plain twin.

The channelizer (dsp/frontend.py::bandpass_channelize) filters every
channel with the shared band-pass taps ``h`` turned to the channel by
its NCO: output j of channel c is

    w_c[j] = sum_u x[G_j - u] h[u] e^{-j theta_c u},  G_j = os (j+1) - 1,

with theta_c = 2 pi dphi_c / 2^24, then rotated by the absolute NCO
phase at G_j.  Where the channels sit on one uniform grid of a K-point
transform, theta_c = 2 pi (k_c + phi) / K + delta_c with one offset phi
(0, or 1/2 where an even channel count is tuned at its middle) and
delta_c the 24-bit NCO's quantization error (|delta_c| <= 2 pi / 2^24).
The bank then computes the same sum with one fold of the input a
output sample, shared by every channel, and one K-point transform:

    v_n[r] = sum_q x[G_j - r - qK] p_n[r + qK]                 (fold)
    X_n[k] = sum_r e^{-j 2 pi k r / K} e^{-j 2 pi phi r / K} v_n[r]
    w_c[j] = sum_n A[c, n] X_n[k_c mod K]

u = r + qK; the prototypes p_n[u] = h[u] ((u - u0) / L)^n / n! carry
e^{-j 2 pi phi q} = (-1)^(2 phi q) (real for phi in {0, 1/2}) and the
coefficients A[c, n] = e^{-j delta_c u0} (-j delta_c L)^n are the terms
of a Taylor series of e^{-j delta_c u} about the taps' centroid u0 (L
the taps' largest distance from it).  Nothing absolute enters the bank:
the fold, the transform and the Taylor terms depend on the tap index u
alone, so a block's length, its NCO index ``n0`` and the index's wrap
at 2^24 reach only the residual rotation, which is the GEMM
formulation's own (dsp/frontend.py).

:func:`plan_for` decides from the taps, the channels' phase increments
and the oversample factor whether the bank applies (:class:`Plan`) or
not (None: the caller runs the GEMM formulation).  It applies where
K = 105 kHz x oversample / 25 kHz is 21 times a power of two up to 16
(oversample 5, 10, 20, 40, 80), one phi in {0, 1/2} leaves every
|delta_c| within one step of the NCO (2 pi / 2^24), and at most
:data:`MAX_ORDERS` Taylor terms bound the truncation by
:data:`TRUNCATION` of the output's RMS.

:func:`pfb` is what bandpass_channelize calls.  On a CUDA tensor it
launches the hand-written kernel ``csrc/pfb.cu`` or raises; on a CPU
tensor it runs :func:`pfb_plain`, which repeats the kernel's
arithmetic step for step (the fold's order over q, each small DFT's
order of terms, the same float32 twiddle tables, the Taylor sum, the
rotation), so that the two agree bit for bit on the card.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..constants import SPS, SYMBOL_RATE

CHANNEL_SPACING = 25_000         # Hz: the VDL2 channel grid
MAX_P = 16                       # K = 21 P, P a power of two up to this
MAX_ORDERS = 3                   # Taylor terms the kernel takes
TRUNCATION = 1e-7                # of the output's RMS
# The transforms' factors: K = P x 21, P = 1, 2, 4, 8 (2 x 4) or 16
# (4 x 4), 21 = 3 x 7; each factor a direct DFT.
COMPOSITE = {8: (2, 4), 16: (4, 4), 21: (3, 7)}
ODD = 21
_MASK24 = 0xFFFFFF
# csrc/pfb.cu's CTA: 336 threads fold 16 outputs each, J = 256 / P
# outputs a CTA, in at most the shared memory a block can have
CTA_THREADS, FOLD_OUTPUTS, SMEM_BYTES = 21 * 16, 16, 232_448

# Kernel launches since start (or the last reset by the caller); only
# the CUDA path counts.
launches = 0


class Plan(NamedTuple):
    """What the bank needs for one channel set, on the taps' device."""
    K: int                   # transform length, 21 P
    P: int
    phi: float               # 0.0 or 0.5
    orders: int              # Taylor terms
    Q: int                   # fold depth: T padded to Q K taps
    T: int
    oversample: int
    proto: torch.Tensor      # (orders, Q K) float32 prototypes
    pre: torch.Tensor | None  # (K, 2) e^{-j 2 pi phi r / K}; None at phi 0
    wtab: np.ndarray         # (K, 2) float32 e^{-j 2 pi i / K}, host
    bins: torch.Tensor       # (C,) int32 k_c mod K
    dphi24: torch.Tensor     # (C,) int32 dphi mod 2^24
    coef: torch.Tensor       # (C, orders, 2) float32 A[c, n]
    truncation: float        # the bound on the series' remainder


def grid_size(oversample: int) -> int | None:
    """K for this oversample factor, where the bank takes it."""
    fs = SYMBOL_RATE * SPS * int(oversample)
    if fs % CHANNEL_SPACING:
        return None
    K = fs // CHANNEL_SPACING
    P = K // ODD
    if K % ODD or P < 1 or P > MAX_P or P & (P - 1):
        return None
    return K


def _grid(dphi: np.ndarray, K: int):
    """(phi, k, e) for the offset of {0, 1/2} that puts every channel
    within one NCO step of a bin (e: the error in 24-bit steps), or
    None."""
    d = dphi.astype(np.int64) & _MASK24
    s = np.where(d >= 1 << 23, d - (1 << 24), d).astype(np.float64)
    best = None
    for phi in (0.0, 0.5):
        k = np.round(s * K / (1 << 24) - phi)
        e = s - (k + phi) * (1 << 24) / K
        if np.abs(e).max() <= 1.0 and (
                best is None or np.abs(e).max() < np.abs(best[2]).max()):
            best = (phi, k.astype(np.int64), e)
    return best


def truncation_bound(h: np.ndarray, delta: float, orders: int) -> float:
    """Bound on the Taylor remainder after ``orders`` terms over the
    output's RMS: sum |h[u]| (delta |u - u0|)^orders / orders! over the
    taps' L2 norm (the output's RMS a unit of white input) or their sum
    (the gain a tone in the pass band), whichever is smaller."""
    h = np.asarray(h, np.float64)
    u = np.arange(h.size)
    u0 = taps_centroid(h)
    rem = np.abs(h) * (delta * np.abs(u - u0)) ** orders \
        / math.factorial(orders)
    return float(rem.sum() / min(np.sqrt((h * h).sum()), abs(h.sum())))


def taps_centroid(h: np.ndarray) -> float:
    """u0, the Taylor series' centre: the centroid of |h|."""
    a = np.abs(np.asarray(h, np.float64))
    return float((a * np.arange(a.size)).sum() / a.sum())


def make_plan(taps: np.ndarray, dphi: np.ndarray, oversample: int,
              device) -> Plan | None:
    """The bank for these taps and channels, or None where it does not
    apply (module docstring)."""
    K = grid_size(oversample)
    h = np.asarray(taps, np.float64)
    if K is None or dphi.size == 0 or h.size == 0 or not h.any():
        return None
    grid = _grid(np.asarray(dphi), K)
    if grid is None:
        return None
    phi, k, e = grid
    delta = 2.0 * np.pi * e / (1 << 24)
    bounds = [truncation_bound(h, float(np.abs(delta).max()), n)
              for n in range(1, MAX_ORDERS + 1)]
    orders = next((n + 1 for n, b in enumerate(bounds) if b <= TRUNCATION),
                  None)
    T = h.size
    Q = -(-T // K)
    if orders is None or smem_bytes(K, Q, orders, oversample) > SMEM_BYTES:
        return None
    u = np.arange(Q * K)
    u0 = taps_centroid(h)
    L = float(np.abs(np.arange(T) - u0).max())
    hp = np.concatenate([h, np.zeros(Q * K - T)])
    sign = np.where((u // K) % 2 == 1, -1.0, 1.0) if phi else 1.0
    proto = np.stack([hp * sign * ((u - u0) / L) ** n / math.factorial(n)
                      for n in range(orders)]).astype(np.float32)
    i = np.arange(K)
    wtab = np.stack([np.cos(-2 * np.pi * i / K),
                     np.sin(-2 * np.pi * i / K)], 1).astype(np.float32)
    pre = None
    if phi:
        pre = torch.as_tensor(np.stack(
            [np.cos(-2 * np.pi * phi * i / K),
             np.sin(-2 * np.pi * phi * i / K)], 1).astype(np.float32),
            device=device)
    n = np.arange(orders)
    coef = np.exp(-1j * delta * u0)[:, None] \
        * (-1j * delta * L)[:, None] ** n[None, :]
    coef = np.stack([coef.real, coef.imag], -1).astype(np.float32)
    return Plan(
        K=K, P=K // ODD, phi=phi, orders=orders, Q=Q, T=T,
        oversample=int(oversample),
        proto=torch.as_tensor(proto, device=device), pre=pre, wtab=wtab,
        bins=torch.as_tensor((k % K).astype(np.int32), device=device),
        dphi24=torch.as_tensor((np.asarray(dphi, np.int64) & _MASK24)
                               .astype(np.int32), device=device),
        coef=torch.as_tensor(coef, device=device),
        truncation=bounds[orders - 1])


def smem_bytes(K: int, Q: int, orders: int, oversample: int) -> int:
    """Shared memory of a CTA of csrc/pfb.cu: the twiddles, then the
    window of its J outputs' input or their folded values, the larger."""
    J = FOLD_OUTPUTS * CTA_THREADS // K
    window = 2 * (oversample * (J - 1) + Q * K) * 4
    return K * 8 + max(window, J * orders * K * 8)


def plan_for(taps: torch.Tensor, dphi: torch.Tensor,
             oversample: int) -> Plan | None:
    """:func:`make_plan` from these tensors' values, on the taps'
    device.  It copies them to the host, so it is made before a CUDA
    graph's capture, not inside one; whoever channelizes block after
    block makes it once and keeps it beside its taps and channels, and
    a graph captured with it keeps it too, since the graph reads its
    tensors."""
    if taps.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the channelizer's plan is made from its taps' "
                           "values: make it before a capture")
    return make_plan(taps.detach().cpu().numpy(),
                     dphi.detach().cpu().numpy(), oversample, taps.device)


# ------------------------------------------------------------- the twin
def _cmul(xr, xi, wr, wi):
    """(xr + j xi)(wr + j wi), each product rounded."""
    return xr * wr - xi * wi, xr * wi + xi * wr


def _tw(x, idx: int, K: int, wtab: np.ndarray):
    """x e^{-j 2 pi idx / K} for an index the kernel knows when it is
    compiled: exact at the quarter turns, else the table's product."""
    idx %= K
    xr, xi = x
    if idx == 0:
        return x
    if 4 * idx == K:
        return xi, -xr
    if 2 * idx == K:
        return -xr, -xi
    if 4 * idx == 3 * K:
        return -xi, xr
    return _cmul(xr, xi, float(wtab[idx, 0]), float(wtab[idx, 1]))


def _dft(xs: list, K: int, wtab: np.ndarray) -> list:
    """DFT of the list ``xs`` (R complex terms, each a (re, im) pair of
    tensors): a COMPOSITE length by its two factors, else directly,
    each output the left-to-right sum of its terms."""
    R = len(xs)
    if R in COMPOSITE:
        R1, R2 = COMPOSITE[R]
        z = [[None] * R1 for _ in range(R2)]
        for b in range(R2):
            ys = _dft([xs[R2 * a + b] for a in range(R1)], K, wtab)
            for k1 in range(R1):
                z[b][k1] = _tw(ys[k1], b * k1 * (K // R), K, wtab)
        out = [None] * R
        for k1 in range(R1):
            ys = _dft([z[b][k1] for b in range(R2)], K, wtab)
            for k2 in range(R2):
                out[k1 + R1 * k2] = ys[k2]
        return out
    out = []
    for k in range(R):
        ar, ai = xs[0]
        for m in range(1, R):
            pr, pi = _tw(xs[m], (m * k % R) * (K // R), K, wtab)
            ar, ai = ar + pr, ai + pi
        out.append((ar, ai))
    return out


def _transform(vr: torch.Tensor, vi: torch.Tensor, plan: Plan):
    """X[..., k] = sum_r e^{-j 2 pi k r / K} v[..., r] as the kernel
    computes it: r = 21 a + b, k = k1 + P k2; a P-point DFT over a for
    each b, the twiddle e^{-j 2 pi b k1 / K} from the table (a product
    even where it is 1), a 21-point DFT over b for each k1."""
    K, P = plan.K, plan.P
    shape = vr.shape[:-1]
    vr = vr.reshape(*shape, P, ODD)
    vi = vi.reshape(*shape, P, ODD)
    ys = _dft([(vr[..., a, :], vi[..., a, :]) for a in range(P)], K,
              plan.wtab)
    b = np.arange(ODD)
    zr, zi = [], []
    for k1, (yr, yi) in enumerate(ys):
        w = torch.as_tensor(plan.wtab[(b * k1) % K], device=vr.device)
        r, i = _cmul(yr, yi, w[:, 0], w[:, 1])
        zr.append(r)
        zi.append(i)
    zr = torch.stack(zr, -2)                  # (..., P [k1], 21 [b])
    zi = torch.stack(zi, -2)
    xs = _dft([(zr[..., j], zi[..., j]) for j in range(ODD)], K, plan.wtab)
    xr = torch.stack([x[0] for x in xs], -2)  # (..., 21 [k2], P [k1])
    xi = torch.stack([x[1] for x in xs], -2)
    return xr.reshape(*shape, K), xi.reshape(*shape, K)


def pfb_plain(iq: torch.Tensor, carry: torch.Tensor, plan: Plan,
              n0) -> torch.Tensor:
    """Plain PyTorch bank (the pipeline runs it on CPU tensors):
    (2, C, N // os) float32 from the (2, N) block after the (2, T - 1)
    raw carry."""
    os_, K, Q = plan.oversample, plan.K, plan.Q
    M = iq.shape[1] // os_
    T1 = carry.shape[1]
    left = max(0, Q * K - T1 - os_)
    xz = torch.nn.functional.pad(torch.cat([carry, iq], dim=1),
                                 (left, 0)).contiguous()
    zero = torch.zeros((2, M, K), dtype=torch.float32, device=iq.device)
    acc = [zero] * plan.orders
    for q in range(Q):
        # X[p, j, r] = x[G_j - r - q K]: a strided view read backwards
        off = left + os_ + T1 - K * (q + 1)
        X = xz.as_strided((2, M, K), (xz.stride(0), os_, 1), off).flip(2)
        for n in range(plan.orders):
            acc[n] = acc[n] + plan.proto[n, q * K:(q + 1) * K] * X
    v = torch.stack(acc, 1)                   # (2, orders, M, K)
    vr, vi = v[0], v[1]
    if plan.pre is not None:
        vr, vi = _cmul(vr, vi, plan.pre[:, 0], plan.pre[:, 1])
    xr, xi = _transform(vr, vi, plan)
    bins = plan.bins.long()
    wr = wi = None
    for n in range(plan.orders):
        a = plan.coef[:, n]
        pr, pi = _cmul(xr[n][:, bins], xi[n][:, bins], a[:, 0], a[:, 1])
        wr, wi = (pr, pi) if n == 0 else (wr + pr, wi + pi)
    from .frontend import residual_rotation
    return residual_rotation(wr.t(), wi.t(), plan.dphi24, n0, os_)


# ------------------------------------------------------------ the kernel
def _check(iq: torch.Tensor, carry: torch.Tensor, plan: Plan) -> None:
    if iq.device.type != "cuda" or carry.device != iq.device \
            or plan.proto.device != iq.device:
        raise ValueError("pfb_cuda needs CUDA tensors on one device")
    for name, t in (("iq", iq), ("carry", carry)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != 2 \
                or t.stride(1) != 1:
            raise ValueError(f"{name} must be (2, n) float32 with unit "
                             f"column stride, got {t.dtype} "
                             f"{tuple(t.shape)} {tuple(t.stride())}")
    if carry.shape[1] != plan.T - 1:
        raise ValueError(f"carry holds {carry.shape[1]} columns, the taps "
                         f"need {plan.T - 1}")


def pfb_cuda(iq: torch.Tensor, carry: torch.Tensor, plan: Plan,
             n0) -> torch.Tensor:
    """Launch kernel KP on the current stream (no fallback).  ``n0`` is
    an int or a 0-dim int64 tensor on the card (a graph's input)."""
    global launches
    _check(iq, carry, plan)
    N = iq.shape[1]
    M = N // plan.oversample
    C = plan.bins.shape[0]
    out = torch.empty((2, C, M), dtype=torch.float32, device=iq.device)
    if M == 0:
        return out
    n0_ptr, n0_val = 0, 0
    if isinstance(n0, torch.Tensor):
        if n0.device != iq.device or n0.dtype != torch.int64 or n0.dim():
            raise ValueError("a tensor n0 must be 0-dim int64 on the card")
        n0_ptr = n0.data_ptr()
    else:
        n0_val = int(n0)
    from .. import kernels
    fn = kernels.load("pfb").pfb_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(iq.device):
        stream = torch.cuda.current_stream(iq.device).cuda_stream
        rc = fn(iq.data_ptr(), iq[1].data_ptr(), N,
                carry.data_ptr(), carry[1].data_ptr(), carry.shape[1],
                plan.proto.data_ptr(), plan.Q, plan.oversample, M,
                0 if plan.pre is None else plan.pre.data_ptr(),
                plan.wtab.ctypes.data, plan.bins.data_ptr(),
                plan.dphi24.data_ptr(), plan.coef.data_ptr(), C, plan.P,
                plan.orders, n0_ptr, n0_val, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pfb kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def pfb(iq: torch.Tensor, carry: torch.Tensor, plan: Plan,
        n0) -> torch.Tensor:
    """The bank on the tensors' device: KP on CUDA, plain on CPU."""
    if iq.device.type == "cuda":
        return pfb_cuda(iq, carry, plan, n0)
    if iq.device.type == "cpu":
        return pfb_plain(iq, carry, plan, n0)
    raise ValueError(f"unsupported device {iq.device}")
