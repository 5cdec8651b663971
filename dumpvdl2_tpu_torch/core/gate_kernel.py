"""Gate kernels G1 and G2 and their plain twins.

The device gate (core/nf_gate.py) has two per-channel recurrences that
the JAX package runs as XLA stages: the gating decisions over the K
candidate slots of a block with the hold bookkeeping that follows them
(G1, ``nf_gate._gate`` = ``_slot_inputs`` + ``gate_scan``, then
``nf_gate._decisions``), and the noise-floor tracker over the block's
magnitude columns (G2, ``nf_gate._nf_track`` up to its ring update: the
window mask, the ring replay, the masked EMA, the per-1000-column floor
updates and the per-candidate readings).  PyTorch has no one-launch
form of either, and their plain versions issue thousands of small
launches or several GB of full-width passes a block, so each is a
hand-written CUDA kernel (``csrc/gate.cu``): G1 a warp a channel, G2 a
thread block a channel that reads the magnitudes once.

:func:`gate` and :func:`nf_track` are what the gate calls.  On a CUDA
tensor they launch the kernel or raise; on a CPU tensor they run the
plain version (:func:`gate_plain`, :func:`nf_track_plain`).  Only the
CUDA path counts in :data:`launches`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import MAG_LP, NF_LP, SPS, SYMBOL_RATE
from .gate_scan import V_ACCEPT, V_HDR_REJECT, ceil_syms, gate_scan

# f32 constants, rounded as the JAX package rounds them
PPM_SCALE = np.float32(SYMBOL_RATE * 1e6 / (2.0 * np.pi))
NF_A = np.float32(NF_LP)
NF_B = np.float32(1.0 - NF_LP)
NF_EPS = np.float32(1e-4)
NF_EVERY = 1000             # tracked columns between floor updates

# Kernel launches since start (or the last reset by the caller).
launches = {"gate": 0, "nf_track": 0}

# G1's hold decisions, in the kernel's output order: int32, then bool
DEC_INT = ("drop_end", "ring_filter", "hold", "low", "f_track")
DEC_BOOL = ("released", "persist", "hold_active")


def _f32(x: np.float32, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _check(name: str, x: torch.Tensor, dtype, dim: int,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype or x.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D {dtype}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _launcher(name: str, argtypes: list):
    from .. import kernels
    fn = getattr(kernels.load("gate"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------------- G1
def slot_inputs(dphi, l2_row, hdr_rows, bits_rows, freqs):
    """Per-slot gate inputs gathered from the compacted L2 results:
    ``(hdr_ok, bits, ppm)``, each (C, K)."""
    safe = l2_row.clamp(0, hdr_rows.shape[0] - 1).long()
    has = l2_row >= 0
    hdr_ok = has & hdr_rows[safe]
    bits = torch.where(has, bits_rows[safe], 0).to(torch.int32)
    ppm = _f32(PPM_SCALE, dphi) * dphi / freqs[:, None].to(torch.float32)
    return hdr_ok, bits, ppm


def gate_plain(count, det_idx, sync_idx, sym_valid, dphi, l2_row,
               hdr_rows, bits_rows, busy_until, next_det_min, hold,
               hold_active, freqs, max_ppm: float, eof: bool,
               end_rel: int):
    """Plain G1: ``(g, bits, dec)``.

    ``g`` is :func:`gate_scan`'s result (verdicts, busy_until,
    next_det_min, deferred_at), ``bits`` (C, K) i32 each slot's bit
    count, ``dec`` ``nf_gate._decisions``' hold decisions (released,
    persist, drop_end, ring_filter, hold, hold_active) and the
    tracker's column bounds: ``low`` (first position tracked) and
    ``f_track`` (first position not tracked; ``end_rel`` when no
    deferral or hold stops the channel).
    """
    from .nf_gate import _FLOOR, _decisions   # nf_gate imports this module
    hdr_ok, bits, ppm = slot_inputs(dphi, l2_row, hdr_rows, bits_rows,
                                    freqs)
    g = gate_scan(count, det_idx, sync_idx, sym_valid, hdr_ok, bits, ppm,
                  l2_row, busy_until, next_det_min, 0, max_ppm, eof=eof)
    deferred = g["deferred_at"]
    dec = _decisions(g["verdicts"], sync_idx, bits,
                     {"busy_until": busy_until, "hold": hold,
                      "hold_active": hold_active}, deferred)
    floor = torch.full_like(busy_until, _FLOOR)
    dec["low"] = torch.maximum(busy_until, dec["drop_end"])
    # while a hold persists, block columns are saved (ring), not tracked
    dec["f_track"] = torch.where(
        dec["persist"], floor,
        torch.where(deferred >= 0, deferred,
                    torch.full_like(busy_until, end_rel)))
    return g, bits, dec


_GATE_ARGS = (("count", torch.int32, 1), ("det_idx", torch.int32, 2),
              ("sync_idx", torch.int32, 2), ("sym_valid", torch.int32, 2),
              ("dphi", torch.float32, 2), ("l2_row", torch.int32, 2),
              ("hdr_rows", torch.bool, 1), ("bits_rows", torch.int32, 1),
              ("busy_until", torch.int32, 1),
              ("next_det_min", torch.int32, 1), ("hold", torch.int32, 1),
              ("hold_active", torch.bool, 1), ("freqs", torch.float32, 1))


def gate_cuda(count, det_idx, sync_idx, sym_valid, dphi, l2_row, hdr_rows,
              bits_rows, busy_until, next_det_min, hold, hold_active, freqs,
              max_ppm: float, eof: bool, end_rel: int):
    """Launch kernel G1 on the current stream (no fallback).  Arguments
    and results as :func:`gate_plain`."""
    args = (count, det_idx, sync_idx, sym_valid, dphi, l2_row, hdr_rows,
            bits_rows, busy_until, next_det_min, hold, hold_active, freqs)
    if count.device.type != "cuda":
        raise ValueError("gate_cuda needs CUDA tensors")
    for (name, dtype, dim), x in zip(_GATE_ARGS, args):
        _check(name, x, dtype, dim, count.device)
    C, K = det_idx.shape
    B = hdr_rows.shape[0]
    for x in (sync_idx, sym_valid, dphi, l2_row):
        if tuple(x.shape) != (C, K):
            raise ValueError(f"slot arrays must all be {(C, K)}")
    for x in (count, busy_until, next_det_min, hold, hold_active, freqs):
        if x.shape[0] != C:
            raise ValueError(f"per-channel arrays must have {C} rows")
    if bits_rows.shape[0] != B or B == 0 or C * K >= 2 ** 31:
        raise ValueError(f"unsupported L2 rows {B} or grid {(C, K)}")
    if not -2 ** 31 <= end_rel < 2 ** 31:
        raise ValueError(f"end_rel {end_rel} is not an int32")
    # one allocation: the int32 outputs, then the int8 and bool ones
    n_int = C * K + (3 + len(DEC_INT)) * C
    n_byte = C * K + len(DEC_BOOL) * C
    out = torch.empty(n_int + (n_byte + 3) // 4, dtype=torch.int32,
                      device=count.device)
    bits, busy1, next1, deferred, *dec_int = out[:n_int].split_with_sizes(
        [C * K] + [C] * (3 + len(DEC_INT)))
    bits = bits.view(C, K)
    verdicts, *dec_bool = out[n_int:].view(torch.int8)[:n_byte] \
        .split_with_sizes([C * K] + [C] * len(DEC_BOOL))
    verdicts = verdicts.view(C, K)
    dec_bool = [x.view(torch.bool) for x in dec_bool]
    fn = _launcher("gate_launch",
                   [ctypes.c_void_p] * 8 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 14)
    with torch.cuda.device(count.device):
        rc = fn(*(x.data_ptr() for x in args[:8]), B,
                *(x.data_ptr() for x in args[8:]),
                float(np.float32(max_ppm)), int(eof), int(end_rel), C, K,
                verdicts.data_ptr(), bits.data_ptr(), busy1.data_ptr(),
                next1.data_ptr(), deferred.data_ptr(),
                *(x.data_ptr() for x in dec_int),
                *(x.data_ptr() for x in dec_bool), _stream(count))
    _raise_on(rc, "gate")
    launches["gate"] += 1
    g = {"verdicts": verdicts, "busy_until": busy1, "next_det_min": next1,
         "deferred_at": deferred}
    dec = {**dict(zip(DEC_INT, dec_int)), **dict(zip(DEC_BOOL, dec_bool))}
    return g, bits, dec


def gate(*args, **kwargs):
    """G1 on the tensors' device: the kernel on CUDA, plain on CPU.
    Arguments as :func:`gate_plain`."""
    dev = args[0].device
    if dev.type == "cuda":
        return gate_cuda(*args, **kwargs)
    if dev.type == "cpu":
        return gate_plain(*args, **kwargs)
    raise ValueError(f"unsupported device {dev}")


# ------------------------------------------------------------------- G2
def affine_scan(scale: torch.Tensor, off: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the affine maps x -> scale*x + off
    (left to right): ``(S, O)`` with y_i = S_i * y_{-1} + O_i.  A
    doubling scan, ceil(log2 N) steps."""
    S, O = scale, off
    d = 1
    while d < S.shape[1]:
        O = torch.cat([O[:, :d], O[:, :-d] * S[:, d:] + O[:, d:]], dim=1)
        S = torch.cat([S[:, :d], S[:, :-d] * S[:, d:]], dim=1)
        d *= 2
    return S, O


def nf_floor_plain(y_cross, valid_c, jc, bound, mag_nf0):
    """The floor recurrence and the readings (the last stage of
    :func:`nf_track_plain`).

    ``y_cross`` (C, cap) f32 EMA values at the 1000th-column crossings,
    ``valid_c`` (C, cap) bool crossings that happened, ``jc`` (C, cap)
    i32 their stream columns, ``bound`` (C, K) i32 each candidate's
    first column not read, ``mag_nf0`` (C,) f32 the floor before the
    block.  Returns ``(mag_nf1 (C,), nf_read (C, K))``: the floor after
    the block's crossings, and the floor each candidate reads (after
    the valid crossings at columns < its bound).
    """
    cap = y_cross.shape[1]
    a, b, eps = (_f32(v, y_cross) for v in (NF_A, NF_B, NF_EPS))
    nf = mag_nf0
    seq = []
    for j in range(cap):
        upd = a * nf + b * torch.minimum(y_cross[:, j], nf) + eps
        nf = torch.where(valid_c[:, j], upd, nf)
        seq.append(nf)
    nf_seq = torch.stack(seq, dim=1)
    r = ((jc[:, None, :] < bound[:, :, None]) & valid_c[:, None, :]) \
        .sum(dim=2)
    took = torch.take_along_dim(nf_seq, (r - 1).clamp(0, cap - 1), dim=1)
    return nf, torch.where(r > 0, took, mag_nf0[:, None])


def nf_track_plain(mags, col_pos, verdicts, sync_idx, bits, low, f_track,
                   released, ring_filter, ring_pos, ring_val, ring_n,
                   mag_lp0, mag_nf0, nfcnt0):
    """Plain G2: the noise-floor tracker of one block.

    The processed column stream is [ring (hold-release replay)] ++
    [this block's columns]: ``mags`` (C, W) f32 the block's magnitudes,
    ``col_pos`` (W,) i32 their rebased positions, strictly increasing;
    ``verdicts`` (C, K) i8, ``sync_idx`` and ``bits`` (C, K) i32 the
    candidates (header rejects and accepts claim windows that are not
    tracked); ``low``, ``f_track`` (C,) i32 the tracked positions
    [low, f_track); ``released`` (C,) bool and ``ring_filter`` (C,) i32
    which ring slots replay (slots < ``ring_n`` at positions >= the
    filter, of ``ring_pos``/``ring_val`` (C, R)); ``mag_lp0``,
    ``mag_nf0`` (C,) f32 and ``nfcnt0`` (C,) i32 in [0, 1000) the
    tracker before the block.

    Returns ``(mag_lp1, mag_nf1, nfcnt1, nf_read, jc)``: the tracker
    after the block, each candidate's floor reading (C, K) f32, and the
    stream column of each floor update (C, cap) i32, -1 past the last;
    cap = (R + W) // 1000 + 1.
    """
    C, K = verdicts.shape
    W = mags.shape[1]
    dev = verdicts.device
    i32 = torch.int32
    R = ring_pos.shape[1]

    # --- block-column mask --------------------------------------------
    total_syms = ceil_syms(bits)
    is_rej = verdicts == V_HDR_REJECT
    win = is_rej | (verdicts == V_ACCEPT)
    we = sync_idx + torch.where(is_rej, 9 * SPS, total_syms * SPS).to(i32)
    a = torch.searchsorted(col_pos, sync_idx.reshape(-1).contiguous(),
                           out_int32=True).reshape(C, K)
    b = torch.searchsorted(col_pos, we.reshape(-1).contiguous(),
                           out_int32=True).reshape(C, K)
    rows = torch.arange(C, device=dev)[:, None].expand(C, K)
    dlt = torch.zeros((C, W + 1), dtype=i32, device=dev)
    dlt.index_put_((rows, a.long()), win.to(i32), accumulate=True)
    dlt.index_put_((rows, b.long()), -win.to(i32), accumulate=True)
    inwin = torch.cumsum(dlt, dim=1, dtype=i32)[:, :W] > 0
    track_blk = (col_pos[None, :] >= low[:, None]) \
        & (col_pos[None, :] < f_track[:, None]) & ~inwin

    # --- ring replay (prefix of the stream) ---------------------------
    slot = torch.arange(R, dtype=i32, device=dev)[None, :]
    track_ring = (slot < ring_n[:, None]) & released[:, None] \
        & (ring_pos >= ring_filter[:, None])

    mags_all = torch.cat([ring_val, mags], dim=1)
    track = torch.cat([track_ring, track_blk], dim=1)

    # --- EMA over tracked columns (affine doubling scan) --------------
    # float32 constants as exact Python floats: no host-to-device copy
    scale = torch.where(track, float(np.float32(MAG_LP)), 1.0)
    off = torch.where(track, mags_all * float(np.float32(1.0 - MAG_LP)), 0.0)
    S, O = affine_scan(scale, off)
    y = S * mag_lp0[:, None] + O
    del scale, off, S, O
    s_cnt = torch.cumsum(track, dim=1, dtype=i32)
    total_n = s_cnt[:, -1]

    # --- per-1000 noise-floor crossings -------------------------------
    cap = (R + W) // NF_EVERY + 1
    steps = torch.arange(1, cap + 1, dtype=i32, device=dev)[None, :]
    targets = (steps * NF_EVERY - nfcnt0[:, None]).contiguous()
    jc = torch.searchsorted(s_cnt, targets, out_int32=True)
    ncross = torch.div(nfcnt0 + total_n, NF_EVERY, rounding_mode="floor")
    valid_c = steps <= ncross[:, None]
    y_cross = torch.take_along_dim(y, jc.clamp(0, R + W - 1).long(), dim=1)
    bound = R + torch.searchsorted(col_pos,
                                   sync_idx.reshape(-1).contiguous(),
                                   out_int32=True).reshape(C, K)
    mag_nf1, nf_read = nf_floor_plain(y_cross, valid_c, jc, bound, mag_nf0)
    nfcnt1 = torch.remainder(nfcnt0 + total_n, NF_EVERY).to(i32)
    return (y[:, -1].contiguous(), mag_nf1, nfcnt1, nf_read,
            torch.where(valid_c, jc, -1))


_TRACK_ARGS = (("mags", torch.float32, 2), ("col_pos", torch.int32, 1),
               ("verdicts", torch.int8, 2), ("sync_idx", torch.int32, 2),
               ("bits", torch.int32, 2), ("low", torch.int32, 1),
               ("f_track", torch.int32, 1), ("released", torch.bool, 1),
               ("ring_filter", torch.int32, 1), ("ring_pos", torch.int32, 2),
               ("ring_val", torch.float32, 2), ("ring_n", torch.int32, 1),
               ("mag_lp0", torch.float32, 1), ("mag_nf0", torch.float32, 1),
               ("nfcnt0", torch.int32, 1))


def nf_track_cuda(mags, col_pos, verdicts, sync_idx, bits, low, f_track,
                  released, ring_filter, ring_pos, ring_val, ring_n,
                  mag_lp0, mag_nf0, nfcnt0):
    """Launch kernel G2 on the current stream (no fallback).  Arguments
    and results as :func:`nf_track_plain`."""
    args = (mags, col_pos, verdicts, sync_idx, bits, low, f_track,
            released, ring_filter, ring_pos, ring_val, ring_n, mag_lp0,
            mag_nf0, nfcnt0)
    dev = mags.device
    if dev.type != "cuda":
        raise ValueError("nf_track_cuda needs CUDA tensors")
    for (name, dtype, dim), x in zip(_TRACK_ARGS, args):
        _check(name, x, dtype, dim, dev)
    C, W = mags.shape
    K = verdicts.shape[1]
    R = ring_pos.shape[1]
    if col_pos.shape[0] != W or tuple(sync_idx.shape) != (C, K) \
            or tuple(bits.shape) != (C, K) \
            or tuple(ring_val.shape) != (C, R):
        raise ValueError(f"unsupported shapes: mags {(C, W)}, slots "
                         f"{tuple(verdicts.shape)}, ring {(C, R)}")
    for x in (low, f_track, released, ring_filter, ring_n, mag_lp0,
              mag_nf0, nfcnt0):
        if x.shape[0] != C:
            raise ValueError(f"per-channel arrays must have {C} rows")
    if R + W == 0 or R + W + NF_EVERY >= 2 ** 31:
        raise ValueError(f"unsupported stream of {R} + {W} columns")
    cap = (R + W) // NF_EVERY + 1
    # one allocation: the float outputs, then the int32 ones
    out = torch.empty(2 * C + C * K + C + C * cap, dtype=torch.float32,
                      device=dev)
    mag_lp1, mag_nf1, nf_read, ints = out.split_with_sizes(
        [C, C, C * K, C + C * cap])
    nf_read = nf_read.view(C, K)
    nfcnt1, jc = ints.view(torch.int32).split_with_sizes([C, C * cap])
    jc = jc.view(C, cap)
    fn = _launcher("nf_track_launch",
                   [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 6)
    with torch.cuda.device(dev):
        rc = fn(mags.data_ptr(), col_pos.data_ptr(), W,
                *(x.data_ptr() for x in args[2:5]), K,
                *(x.data_ptr() for x in args[5:12]), R,
                *(x.data_ptr() for x in args[12:]), C, cap,
                mag_lp1.data_ptr(), mag_nf1.data_ptr(), nfcnt1.data_ptr(),
                nf_read.data_ptr(), jc.data_ptr(), _stream(mags))
    _raise_on(rc, "nf_track")
    launches["nf_track"] += 1
    return mag_lp1, mag_nf1, nfcnt1, nf_read, jc


def nf_track(*args):
    """G2 on the tensors' device: the kernel on CUDA, plain on CPU.
    Arguments as :func:`nf_track_plain`."""
    dev = args[0].device
    if dev.type == "cuda":
        return nf_track_cuda(*args)
    if dev.type == "cpu":
        return nf_track_plain(*args)
    raise ValueError(f"unsupported device {dev}")
