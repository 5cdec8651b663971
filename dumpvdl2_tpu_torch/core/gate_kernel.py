"""Gate kernels G1 and G2 and their plain twins.

The device gate (core/nf_gate.py) has two per-channel recurrences that
the JAX package runs as ``lax.scan``s: the gating decisions over the K
candidate slots of a block (G1, ``nf_gate._gate``: ``_slot_inputs`` +
``gate_scan``) and the per-1000-column noise-floor updates with the
per-candidate readings (G2, ``nf_gate._nf_track`` lines 264-286).
PyTorch has no one-launch form of either, and their plain versions
issue thousands of small launches a block, so each is a hand-written
CUDA kernel (``csrc/gate.cu``), one thread per channel.

:func:`gate` and :func:`nf_floor` are what the gate calls.  On a CUDA
tensor they launch the kernel or raise; on a CPU tensor they run the
plain version (:func:`gate_plain`, :func:`nf_floor_plain`).  Only the
CUDA path counts in :data:`launches`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import NF_LP, SYMBOL_RATE
from .gate_scan import gate_scan

# f32 constants, rounded as the JAX package rounds them
PPM_SCALE = np.float32(SYMBOL_RATE * 1e6 / (2.0 * np.pi))
NF_A = np.float32(NF_LP)
NF_B = np.float32(1.0 - NF_LP)
NF_EPS = np.float32(1e-4)

# Kernel launches since start (or the last reset by the caller).
launches = {"gate": 0, "nf_floor": 0}


def _f32(x: np.float32, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


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
               hdr_rows, bits_rows, busy_until, next_det_min, freqs,
               max_ppm: float, eof: bool):
    """Plain G1: ``(gate_scan result dict, bits (C, K) i32)``."""
    hdr_ok, bits, ppm = slot_inputs(dphi, l2_row, hdr_rows, bits_rows,
                                    freqs)
    g = gate_scan(count, det_idx, sync_idx, sym_valid, hdr_ok, bits, ppm,
                  l2_row, busy_until, next_det_min, 0, max_ppm, eof=eof)
    return g, bits


_GATE_ARGS = (("count", torch.int32, 1), ("det_idx", torch.int32, 2),
              ("sync_idx", torch.int32, 2), ("sym_valid", torch.int32, 2),
              ("dphi", torch.float32, 2), ("l2_row", torch.int32, 2),
              ("hdr_rows", torch.bool, 1), ("bits_rows", torch.int32, 1),
              ("busy_until", torch.int32, 1),
              ("next_det_min", torch.int32, 1), ("freqs", torch.float32, 1))


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


def gate_cuda(count, det_idx, sync_idx, sym_valid, dphi, l2_row, hdr_rows,
              bits_rows, busy_until, next_det_min, freqs, max_ppm: float,
              eof: bool):
    """Launch kernel G1 on the current stream (no fallback)."""
    args = (count, det_idx, sync_idx, sym_valid, dphi, l2_row, hdr_rows,
            bits_rows, busy_until, next_det_min, freqs)
    if count.device.type != "cuda":
        raise ValueError("gate_cuda needs CUDA tensors")
    for (name, dtype, dim), x in zip(_GATE_ARGS, args):
        _check(name, x, dtype, dim, count.device)
    C, K = det_idx.shape
    B = hdr_rows.shape[0]
    for x in (sync_idx, sym_valid, dphi, l2_row):
        if tuple(x.shape) != (C, K):
            raise ValueError(f"slot arrays must all be {(C, K)}")
    for x in (count, busy_until, next_det_min, freqs):
        if x.shape[0] != C:
            raise ValueError(f"per-channel arrays must have {C} rows")
    if bits_rows.shape[0] != B or B == 0 or C * K >= 2 ** 31:
        raise ValueError(f"unsupported L2 rows {B} or grid {(C, K)}")
    dev = count.device
    verdicts = torch.empty((C, K), dtype=torch.int8, device=dev)
    bits = torch.empty((C, K), dtype=torch.int32, device=dev)
    busy1, next1, deferred = (torch.empty((C,), dtype=torch.int32,
                                          device=dev) for _ in range(3))
    from .. import kernels
    fn = kernels.load("gate").gate_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int] + \
            [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(count.data_ptr(), det_idx.data_ptr(), sync_idx.data_ptr(),
                sym_valid.data_ptr(), l2_row.data_ptr(), dphi.data_ptr(),
                hdr_rows.data_ptr(), bits_rows.data_ptr(), B,
                busy_until.data_ptr(), next_det_min.data_ptr(),
                freqs.data_ptr(), float(np.float32(max_ppm)), int(eof), C,
                K, verdicts.data_ptr(), busy1.data_ptr(), next1.data_ptr(),
                deferred.data_ptr(), bits.data_ptr(), _stream(count))
    _raise_on(rc, "gate")
    launches["gate"] += 1
    return {"verdicts": verdicts, "busy_until": busy1, "next_det_min": next1,
            "deferred_at": deferred}, bits


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
def nf_floor_plain(y_cross, valid_c, jc, bound, mag_nf0):
    """Plain G2.

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


def nf_floor_cuda(y_cross, valid_c, jc, bound, mag_nf0):
    """Launch kernel G2 on the current stream (no fallback)."""
    dev = y_cross.device
    if dev.type != "cuda":
        raise ValueError("nf_floor_cuda needs CUDA tensors")
    for name, x, dtype, dim in (("y_cross", y_cross, torch.float32, 2),
                                ("valid_c", valid_c, torch.bool, 2),
                                ("jc", jc, torch.int32, 2),
                                ("bound", bound, torch.int32, 2),
                                ("mag_nf0", mag_nf0, torch.float32, 1)):
        _check(name, x, dtype, dim, dev)
    C, cap = y_cross.shape
    K = bound.shape[1]
    if tuple(valid_c.shape) != (C, cap) or tuple(jc.shape) != (C, cap) \
            or bound.shape[0] != C or mag_nf0.shape[0] != C or cap == 0 \
            or C * max(cap, K) >= 2 ** 31:
        raise ValueError(f"unsupported shapes: crossings {(C, cap)}, "
                         f"bound {tuple(bound.shape)}")
    mag_nf1 = torch.empty((C,), dtype=torch.float32, device=dev)
    nf_read = torch.empty((C, K), dtype=torch.float32, device=dev)
    nf_seq = torch.empty((C, cap), dtype=torch.float32, device=dev)
    from .. import kernels
    fn = kernels.load("gate").nf_floor_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                               ctypes.c_void_p,
                                               ctypes.c_int,
                                               ctypes.c_void_p,
                                               ctypes.c_int] + \
            [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(y_cross.data_ptr(), valid_c.data_ptr(), jc.data_ptr(), cap,
                bound.data_ptr(), K, mag_nf0.data_ptr(), C,
                mag_nf1.data_ptr(), nf_seq.data_ptr(), nf_read.data_ptr(),
                _stream(y_cross))
    _raise_on(rc, "nf_floor")
    launches["nf_floor"] += 1
    return mag_nf1, nf_read


def nf_floor(y_cross, valid_c, jc, bound, mag_nf0):
    """G2 on the tensors' device: the kernel on CUDA, plain on CPU."""
    dev = y_cross.device
    if dev.type == "cuda":
        return nf_floor_cuda(y_cross, valid_c, jc, bound, mag_nf0)
    if dev.type == "cpu":
        return nf_floor_plain(y_cross, valid_c, jc, bound, mag_nf0)
    raise ValueError(f"unsupported device {dev}")
