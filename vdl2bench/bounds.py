"""The least time of the port's kernels that the benchmark's roofline
readers need besides K1's (trace.k1_bound), counted from what each
kernel computes, whatever computes it.

``ingest_bound``: kernel KI (dumpvdl2_tpu_torch/csrc/ingest.cu) turns a
block of ``samples`` raw I/Q pairs in ``sample_format`` into planar
float32: it must read each raw byte once and write each float once, at
the card's published device memory rate (trace.HBM_BYTES_PER_S, H100
SXM HBM3).  It computes a conversion a value, far under the card's
issue rate, so the bytes bound it.
"""
from __future__ import annotations

from .trace import HBM_BYTES_PER_S

PAIR_BYTES = {"U8": 2, "S16_LE": 4}


def ingest_bytes(samples: int, sample_format: str) -> int:
    """Bytes KI must move for ``samples`` I/Q pairs: the raw pairs read,
    two float32 planes written."""
    return samples * (PAIR_BYTES[sample_format] + 2 * 4)


def ingest_bound(samples: int, sample_format: str) -> dict:
    b = ingest_bytes(samples, sample_format)
    return {"bytes": b, "bound_ms": b / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
