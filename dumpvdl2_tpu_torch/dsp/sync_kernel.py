"""D8PSK preamble sync error metric: CUDA kernel K1 and its plain twin.

:func:`sync_error_metric` is what the detector calls.  On a CUDA
tensor it launches the hand-written kernel ``csrc/sync_metric.cu``
(the port of the TPU kernel ``dumpvdl2_tpu/dsp/sync_pallas.py``) or
raises; on a CPU tensor it runs :func:`sync_error_metric_plain`, the
port of the XLA twin ``dumpvdl2_tpu/dsp/demod.py:sync_error_metric``.

Contract (both paths): ``phases`` is (C, M) float32; returns
``(err, freq)``, each (C, M) float32.  ``err[:, n]`` is the residual
sum of squares of the 16-symbol preamble fit ending at sample n and
``freq[:, n]`` the fitted per-symbol frequency offset; for n < 150
(``LOOKBACK``) err is +inf and freq 0.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import PREAMBLE_PHASE_UNITS, PREAMBLE_SYMS, SPS

PR_PHASE = np.array(PREAMBLE_PHASE_UNITS, np.float32) * np.float32(np.pi / 4)
LR_X = np.arange(PREAMBLE_SYMS, dtype=np.float32) - (PREAMBLE_SYMS - 1) / 2.0
LR_DENOM = float((LR_X ** 2).sum())               # 340
LOOKBACK = (PREAMBLE_SYMS - 1) * SPS              # 150 decimated samples
_PI = float(np.float32(np.pi))
_TWO_PI = float(np.float32(2 * np.pi))

# Kernel launches since start (or the last reset by the caller); only
# the CUDA path counts.
launches = 0


def sync_error_metric_plain(phases: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch metric (port of demod.sync_error_metric)."""
    C, M = phases.shape
    dev = phases.device
    L = M - LOOKBACK
    if L <= 0:
        return (torch.full((C, M), float("inf"), dtype=torch.float32,
                           device=dev),
                torch.zeros((C, M), dtype=torch.float32, device=dev))
    # sym[i, :, n] = phase at sample (n + 150) - (15-i)*10
    sym = torch.stack([phases[:, i * SPS: L + i * SPS]
                       for i in range(PREAMBLE_SYMS)])        # (16, C, L)
    err = sym - torch.as_tensor(PR_PHASE, device=dev)[:, None, None]
    d = torch.diff(err, dim=0)
    adj = torch.where(d > _PI, -_TWO_PI, 0.0) + \
        torch.where(d < -_PI, _TWO_PI, 0.0)
    unwrap = torch.cat([torch.zeros_like(adj[:1]),
                        torch.cumsum(adj, dim=0)], dim=0)
    errvec = err + unwrap
    errvec = errvec - errvec.mean(dim=0, keepdim=True)
    lr_x = torch.as_tensor(LR_X, device=dev)[:, None, None]
    freq = (lr_x * errvec).sum(dim=0) / torch.full(
        (1,), LR_DENOM, dtype=torch.float32, device=dev)       # (C, L)
    resid = errvec - freq * lr_x
    e = (resid * resid).sum(dim=0)
    pad = torch.full((C, LOOKBACK), float("inf"), dtype=e.dtype, device=dev)
    return (torch.cat([pad, e], dim=1),
            torch.cat([torch.zeros((C, LOOKBACK), dtype=freq.dtype,
                                   device=dev), freq], dim=1))


def _launch_fn():
    from .. import kernels
    lib = kernels.load("sync_metric")
    fn = lib.sync_metric_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sync_error_metric_cuda(phases: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel K1 on the current stream (no fallback)."""
    global launches
    if phases.device.type != "cuda":
        raise ValueError("sync_error_metric_cuda needs a CUDA tensor")
    if phases.dtype != torch.float32 or phases.dim() != 2:
        raise ValueError(f"phases must be 2-D float32, got "
                         f"{phases.dtype} {tuple(phases.shape)}")
    if not phases.is_contiguous():
        raise ValueError("phases must be contiguous")
    C, M = phases.shape
    if C > 65535 or M >= 2 ** 31:      # grid.y limit; M is a C int
        raise ValueError(f"unsupported shape {(C, M)}")
    err = torch.empty_like(phases)
    freq = torch.empty_like(phases)
    if C == 0 or M == 0:
        return err, freq
    fn = _launch_fn()
    with torch.cuda.device(phases.device):
        stream = torch.cuda.current_stream(phases.device).cuda_stream
        rc = fn(phases.data_ptr(), err.data_ptr(), freq.data_ptr(),
                C, M, stream)
    if rc != 0:
        raise RuntimeError(f"sync_metric kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return err, freq


def sync_error_metric(phases: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sync metric on the tensor's device: K1 on CUDA, plain on CPU."""
    if phases.device.type == "cuda":
        return sync_error_metric_cuda(phases)
    if phases.device.type == "cpu":
        return sync_error_metric_plain(phases)
    raise ValueError(f"unsupported device {phases.device}")
