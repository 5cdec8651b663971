"""Raw-sample ingest: CUDA kernel KI and its plain twin.

:func:`ingest` is what ``VDL2Pipeline.feed_raw`` calls.  On a CUDA
tensor it launches the hand-written kernel ``csrc/ingest.cu`` or
raises; on a CPU tensor it runs :func:`ingest_plain`.

Contract (both paths): ``raw`` is a flat uint8 tensor of interleaved
I/Q samples in ``sample_format`` (``U8`` or ``S16_LE``), read after the
``pend`` bytes (fewer than a sample pair) that the previous buffer ended
in; ``residual`` is the (2, R) float32 planar samples carried from the
previous call.  Each value converts as ``io/iqfile.py::dequantize_block``
converts it in float32 (U8 ``(x - 127.5) / 127.5``, S16_LE
``x / 32768``), bit for bit.  Returns ``(block, residual)``: the first
``n_out`` columns of [residual, fresh samples], ``n_out`` the largest
multiple of ``oversample`` that fits, and the columns after them.  The
bytes of a trailing partial pair are the caller's to carry
(:func:`pend_after`).
"""
from __future__ import annotations

import ctypes

import torch

FORMATS = {"U8": 0, "S16_LE": 1}

# Kernel launches since start (or the last reset by the caller); only
# the CUDA path counts.
launches = 0


def pair_bytes(sample_format: str) -> int:
    """Bytes of one I/Q sample pair."""
    if sample_format not in FORMATS:
        raise ValueError(f"unknown sample format {sample_format!r}")
    return 4 if sample_format == "S16_LE" else 2


def pend_after(pend: bytes, tail: bytes, nbytes: int,
               sample_format: str) -> bytes:
    """The bytes of the partial sample pair that ``pend`` followed by
    ``nbytes`` fresh bytes end in; ``tail`` is the fresh bytes' last 3
    (all of them if fewer)."""
    left = (len(pend) + nbytes) % pair_bytes(sample_format)
    both = pend + tail
    return both[len(both) - left:] if left else b""


def _out_columns(R: int, pairs: int, oversample: int) -> tuple[int, int]:
    n_total = R + pairs
    return n_total, (n_total // oversample) * oversample


def ingest_plain(raw: torch.Tensor, pend: bytes, sample_format: str,
                 residual: torch.Tensor, oversample: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ingest (the pipeline runs it on CPU tensors)."""
    w = pair_bytes(sample_format)
    pairs = (len(pend) + raw.numel()) // w
    v = torch.cat([torch.tensor(list(pend), dtype=torch.uint8,
                                device=raw.device),
                   raw.reshape(-1)])[:pairs * w]
    if sample_format == "U8":
        flat = (v.to(torch.float32) - 127.5) / 127.5
    else:
        flat = v.view(torch.int16).to(torch.float32) / 32768.0
    fresh = flat.reshape(pairs, 2).t()
    both = torch.cat([residual, fresh], dim=1)
    _, n_out = _out_columns(residual.shape[1], pairs, oversample)
    return both[:, :n_out].contiguous(), both[:, n_out:].contiguous()


def _check(raw: torch.Tensor, residual: torch.Tensor) -> None:
    if raw.device.type != "cuda" or residual.device != raw.device:
        raise ValueError("ingest_cuda needs CUDA tensors on one device")
    if raw.dtype != torch.uint8 or raw.dim() != 1 or not raw.is_contiguous():
        raise ValueError(f"raw must be flat contiguous uint8, got "
                         f"{raw.dtype} {tuple(raw.shape)}")
    if residual.dtype != torch.float32 or residual.dim() != 2 \
            or residual.shape[0] != 2 or not residual.is_contiguous():
        raise ValueError(f"residual must be (2, R) contiguous float32, got "
                         f"{residual.dtype} {tuple(residual.shape)}")


def ingest_cuda(raw: torch.Tensor, pend: bytes, sample_format: str,
                residual: torch.Tensor, oversample: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel KI on the current stream (no fallback)."""
    global launches
    _check(raw, residual)
    w = pair_bytes(sample_format)
    if len(pend) >= w:
        raise ValueError("pend must hold less than a sample pair")
    R = residual.shape[1]
    pairs = (len(pend) + raw.numel()) // w
    n_total, n_out = _out_columns(R, pairs, oversample)
    out = torch.empty((2, n_out), dtype=torch.float32, device=raw.device)
    res = torch.empty((2, n_total - n_out), dtype=torch.float32,
                      device=raw.device)
    if n_total == 0:
        return out, res
    from .. import kernels
    fn = kernels.load("ingest").ingest_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        rc = fn(raw.data_ptr(), int.from_bytes(pend, "little"), len(pend),
                FORMATS[sample_format], residual.data_ptr(), R,
                out.data_ptr(), n_out, res.data_ptr(), n_total, stream)
    if rc != 0:
        raise RuntimeError(f"ingest kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, res


def ingest(raw: torch.Tensor, pend: bytes, sample_format: str,
           residual: torch.Tensor, oversample: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ingest on the tensors' device: KI on CUDA, plain on CPU."""
    if raw.device.type == "cuda":
        return ingest_cuda(raw, pend, sample_format, residual, oversample)
    if raw.device.type == "cpu":
        return ingest_plain(raw, pend, sample_format, residual, oversample)
    raise ValueError(f"unsupported device {raw.device}")
