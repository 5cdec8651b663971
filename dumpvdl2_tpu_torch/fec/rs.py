"""Reed-Solomon RS(255,249) errors-and-erasures decoder.

VDL2 protects each 249-octet block with 6 parity octets; shortened final
blocks carry 0/2/4 parity octets, with the absent parity positions
declared as erasures (reference rs.c:32-49).  Code parameters: GF(2^8)
with field polynomial 0x187, generator roots alpha^120..alpha^125
(fcr=120, prim=1).

Convention: ``codeword[0]`` is the coefficient of x^254, i.e. byte index
k corresponds to polynomial position 254-k.  Erasure positions are byte
indices.  ``decode`` returns the number of corrected symbols (counting
erasure fills), or -1 if the block is uncorrectable -- the same contract
as the reference's codec, so callers can share accounting logic.

This is the scalar reference implementation; the batched PyTorch version
in ``fec/rs_batch.py`` is validated against it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .gf256 import A0, ALPHA_TO, GF_SIZE, INDEX_OF, gf_mul, poly_mul

NROOTS = 6
FCR = 120
NN = 255
KK = NN - NROOTS


def _generator_poly() -> np.ndarray:
    g = np.array([1], dtype=np.int32)
    for i in range(NROOTS):
        root = int(ALPHA_TO[(FCR + i) % GF_SIZE])
        g = poly_mul(g, np.array([root, 1], dtype=np.int32))
    return g  # g[0] = constant term, degree NROOTS


GENPOLY = _generator_poly()


def encode(data: np.ndarray) -> np.ndarray:
    """Systematic encode: append NROOTS parity octets to 249 data octets.

    Used by tests to build known-good codewords; the receive pipeline
    only decodes.
    """
    data = np.asarray(data, dtype=np.int32)
    if data.size != KK:
        raise ValueError("encode expects exactly 249 data octets")
    # Long division of data(x) * x^NROOTS by g(x)
    rem = np.zeros(NROOTS, dtype=np.int32)
    for d in data:
        feedback = int(d) ^ int(rem[0])
        rem[:-1] = rem[1:]
        rem[-1] = 0
        if feedback:
            flog = int(INDEX_OF[feedback])
            for i in range(NROOTS):
                # g is monic of degree NROOTS; coefficient for x^(NROOTS-1-i)
                gcoef = int(GENPOLY[NROOTS - 1 - i])
                if gcoef:
                    rem[i] ^= int(ALPHA_TO[(flog + int(INDEX_OF[gcoef])) % GF_SIZE])
    return np.concatenate([data, rem]).astype(np.uint8)


def encode_batch(data: np.ndarray) -> np.ndarray:
    """:func:`encode` of each row of ``data`` (n, 249): (n, 255) uint8
    codewords, by the same long division, vectorized over the rows."""
    data = np.asarray(data, dtype=np.int32)
    if data.ndim != 2 or data.shape[1] != KK:
        raise ValueError("encode_batch expects (n, 249) data octets")
    rem = np.zeros((data.shape[0], NROOTS), dtype=np.int32)
    glog = [int(INDEX_OF[int(GENPOLY[NROOTS - 1 - i])]) for i in range(NROOTS)]
    for col in range(KK):
        feedback = data[:, col] ^ rem[:, 0]
        rem = np.concatenate([rem[:, 1:], np.zeros_like(rem[:, :1])], axis=1)
        flog = INDEX_OF[feedback]
        for i in range(NROOTS):
            if glog[i] != A0:
                rem[:, i] ^= np.where(feedback != 0,
                                      ALPHA_TO[(flog + glog[i]) % GF_SIZE], 0)
    return np.concatenate([data, rem], axis=1).astype(np.uint8)


def _syndromes(cw: np.ndarray) -> np.ndarray:
    s = np.zeros(NROOTS, dtype=np.int32)
    for i in range(NROOTS):
        acc = 0
        mult = int(ALPHA_TO[(FCR + i) % GF_SIZE])
        for byte in cw:
            acc = gf_mul(acc, mult) ^ int(byte)
        s[i] = acc
    return s


def decode(codeword: np.ndarray,
           erasures: Sequence[int] = ()) -> tuple[np.ndarray, int]:
    """Correct ``codeword`` (length 255) in place-equivalent fashion.

    Returns ``(corrected_codeword, count)`` where count is the number of
    corrected positions or -1 on decode failure.
    """
    cw = np.array(codeword, dtype=np.int32, copy=True)
    if cw.size != NN:
        raise ValueError("codeword must be 255 octets")
    no_eras = len(erasures)
    if no_eras > NROOTS:
        return cw.astype(np.uint8), -1

    s = _syndromes(cw)
    if not s.any():
        return cw.astype(np.uint8), 0
    s_log = np.array([int(INDEX_OF[v]) for v in s], dtype=np.int32)

    # Erasure locator polynomial: prod (1 - x * alpha^(254-pos))
    lam = np.zeros(NROOTS + 1, dtype=np.int32)
    lam[0] = 1
    for pos in erasures:
        u = (NN - 1 - int(pos)) % GF_SIZE
        # lam *= (1 + alpha^u x)
        prev = lam.copy()
        for j in range(NROOTS, 0, -1):
            if prev[j - 1]:
                lam[j] ^= int(ALPHA_TO[(u + int(INDEX_OF[prev[j - 1]])) % GF_SIZE])

    b = np.array([int(INDEX_OF[v]) for v in lam], dtype=np.int32)

    # Berlekamp-Massey over the remaining steps
    el = no_eras
    for r in range(no_eras + 1, NROOTS + 1):
        discr = 0
        for i in range(r):
            if lam[i] and s_log[r - i - 1] != A0:
                discr ^= int(ALPHA_TO[(int(INDEX_OF[lam[i]]) + int(s_log[r - i - 1])) % GF_SIZE])
        if discr == 0:
            b[1:] = b[:-1].copy()
            b[0] = A0
        else:
            dlog = int(INDEX_OF[discr])
            t = np.zeros(NROOTS + 1, dtype=np.int32)
            t[0] = lam[0]
            for i in range(NROOTS):
                t[i + 1] = lam[i + 1]
                if b[i] != A0:
                    t[i + 1] ^= int(ALPHA_TO[(dlog + int(b[i])) % GF_SIZE])
            if 2 * el <= r + no_eras - 1:
                el = r + no_eras - el
                b = np.array(
                    [A0 if lam[i] == 0 else (int(INDEX_OF[lam[i]]) - dlog + GF_SIZE) % GF_SIZE
                     for i in range(NROOTS + 1)], dtype=np.int32)
            else:
                b[1:] = b[:-1].copy()
                b[0] = A0
            lam = t

    lam_log = np.array([int(INDEX_OF[v]) for v in lam], dtype=np.int32)
    deg_lambda = max((i for i in range(NROOTS + 1) if lam_log[i] != A0), default=0)

    # Chien search: roots of lambda among alpha^-k for byte positions k
    roots: list[int] = []
    locs: list[int] = []
    reg = lam_log.copy()
    for i in range(1, NN + 1):
        q = 1
        for j in range(deg_lambda, 0, -1):
            if reg[j] != A0:
                reg[j] = (int(reg[j]) + j) % GF_SIZE
                q ^= int(ALPHA_TO[reg[j]])
        if q != 0:
            continue
        roots.append(i)
        locs.append(i - 1)  # with prim=1, location number k = i-1
        if len(roots) == deg_lambda:
            break
    if len(roots) != deg_lambda:
        return cw.astype(np.uint8), -1

    # Error evaluator omega(x) = S(x) * lambda(x) mod x^NROOTS
    deg_omega = deg_lambda - 1
    omega_log = np.full(NROOTS + 1, A0, dtype=np.int32)
    for i in range(deg_omega + 1):
        tmp = 0
        for j in range(i, -1, -1):
            if s_log[i - j] != A0 and lam_log[j] != A0:
                tmp ^= int(ALPHA_TO[(int(s_log[i - j]) + int(lam_log[j])) % GF_SIZE])
        omega_log[i] = int(INDEX_OF[tmp])

    # Forney: error magnitude at each located position
    for j in range(len(roots) - 1, -1, -1):
        root = roots[j]
        num1 = 0
        for i in range(deg_omega, -1, -1):
            if omega_log[i] != A0:
                num1 ^= int(ALPHA_TO[(int(omega_log[i]) + i * root) % GF_SIZE])
        num2 = int(ALPHA_TO[(root * (FCR - 1) + GF_SIZE) % GF_SIZE])
        den = 0
        i = min(deg_lambda, NROOTS - 1) & ~1
        while i >= 0:
            if lam_log[i + 1] != A0:
                den ^= int(ALPHA_TO[(int(lam_log[i + 1]) + i * root) % GF_SIZE])
            i -= 2
        if den == 0:
            return cw.astype(np.uint8), -1
        if num1 != 0:
            mag = int(ALPHA_TO[(int(INDEX_OF[num1]) + int(INDEX_OF[num2])
                                + GF_SIZE - int(INDEX_OF[den])) % GF_SIZE])
            # The locator was built from alpha^(NN-1-pos), so the Chien
            # location number k is already the byte index.
            cw[locs[j]] ^= mag
    return cw.astype(np.uint8), len(roots)


def rs_verify(block: np.ndarray, fec_octets: int) -> tuple[np.ndarray, int]:
    """Decode one deinterleaved 255-octet block.

    ``fec_octets`` is the number of real parity octets present (6 for a
    full block, 0/2/4 for a shortened final block).  Missing parity
    positions are declared as erasures.  Returns (corrected_block, ret)
    with ret as in :func:`decode`; fec_octets == 0 skips FEC entirely.
    """
    if fec_octets == 0:
        return np.asarray(block, dtype=np.uint8), 0
    erasure_cnt = NROOTS - fec_octets
    erasures = [KK + fec_octets + i for i in range(erasure_cnt)]
    return decode(block, erasures)
