"""GF(2^8) arithmetic tables for the VDL2 Reed-Solomon code.

Field generator polynomial 0x187 (x^8+x^7+x^2+x+1), as required by the
VDL2 air interface (reference rs.c:28 passes the same parameters to its
codec).  All arithmetic is table-driven so that a batched TPU kernel can
reuse the same tables as int32 gathers.
"""
from __future__ import annotations

import numpy as np

FIELD_POLY = 0x187
GF_SIZE = 255  # number of non-zero field elements
A0 = GF_SIZE   # sentinel log value for zero


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    alpha_to = np.zeros(GF_SIZE + 1, dtype=np.int32)  # log -> element
    index_of = np.zeros(GF_SIZE + 1, dtype=np.int32)  # element -> log
    x = 1
    for i in range(GF_SIZE):
        alpha_to[i] = x
        index_of[x] = i
        x <<= 1
        if x & 0x100:
            x ^= FIELD_POLY
    if x != 1:
        raise AssertionError("0x187 is not primitive over GF(2^8)")
    alpha_to[GF_SIZE] = 0          # alpha^A0 treated as 0
    index_of[0] = A0
    return alpha_to, index_of


ALPHA_TO, INDEX_OF = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(ALPHA_TO[(int(INDEX_OF[a]) + int(INDEX_OF[b])) % GF_SIZE])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(256) division by zero")
    if a == 0:
        return 0
    return int(ALPHA_TO[(int(INDEX_OF[a]) - int(INDEX_OF[b])) % GF_SIZE])


def gf_pow(base_log: int, exp: int) -> int:
    """alpha^(base_log * exp) as a field element."""
    return int(ALPHA_TO[(base_log * exp) % GF_SIZE])


def poly_eval(poly: np.ndarray, x: int) -> int:
    """Evaluate polynomial (poly[0] = constant term) at field element x."""
    acc = 0
    for c in poly[::-1]:
        acc = gf_mul(acc, x) ^ int(c)
    return acc


def poly_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + len(b) - 1, dtype=np.int32)
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            out[i + j] ^= gf_mul(int(ai), int(bj))
    return out
