"""Batched RS(255,249) errors-and-erasures decoder in PyTorch.

Port of ``dumpvdl2_tpu/fec/rs_tpu.py``; vectorizes the scalar decoder
in :mod:`.rs` over a batch of codewords:

* syndromes: GF(2)-linear in the codeword bits, ONE (B, 2040) x
  (2040, 48) float32 0/1 matmul followed by a parity reduction (exact:
  the sums are small integers),
* Chien search / Forney at all 255 positions: 8-step carry-less
  multiplies against constant power matrices,
* Berlekamp-Massey: a fixed NROOTS iterations with per-row masks on
  small (B, 7) tensors,
* failures (root count != degree, zero denominator) give count = -1,
  matching the scalar contract.

JAX clamps out-of-range gathers; PyTorch raises (CPU) or asserts
(CUDA).  The two places where the JAX code relies on the clamp -- the
log-table multiply at LOG[0] + LOG[0] = 510 and the BM update at
dlog + b with b = A0 -- mask the index before the gather and keep the
later select.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .gf256 import A0, ALPHA_TO, GF_SIZE, INDEX_OF, gf_mul
from .rs import FCR, NN, NROOTS

_SPOW = np.zeros((NROOTS, NN), dtype=np.int32)
for _i in range(NROOTS):
    for _k in range(NN):
        _SPOW[_i, _k] = ALPHA_TO[((FCR + _i) * (NN - 1 - _k)) % GF_SIZE]

_CHIEN_POW_NP = np.array([[ALPHA_TO[(j * i) % GF_SIZE]
                           for i in range(1, NN + 1)]
                          for j in range(NROOTS + 1)], dtype=np.int32)
_NUM2_NP = np.array([ALPHA_TO[(i * (FCR - 1)) % GF_SIZE]
                     for i in range(1, NN + 1)], dtype=np.int32)


def _build_synd_matrix() -> np.ndarray:
    """Input bit (k, bi) -> output bit (i, bo) of S_i = XOR_k cw[k]*P[i,k]."""
    M = np.zeros((NN * 8, NROOTS * 8), dtype=np.float32)
    for k in range(NN):
        for bi in range(8):
            for i in range(NROOTS):
                prod = gf_mul(1 << bi, int(_SPOW[i, k]))
                for bo in range(8):
                    if (prod >> bo) & 1:
                        M[k * 8 + bi, i * 8 + bo] = 1.0
    return M


_SYND_M_NP = _build_synd_matrix()


@functools.lru_cache(maxsize=4)
def _tables(device: torch.device) -> dict[str, torch.Tensor]:
    """Constant tables, uploaded once per device."""
    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    chien = t(_CHIEN_POW_NP, torch.uint8)
    return {
        "exp": t(np.concatenate([ALPHA_TO[:GF_SIZE], ALPHA_TO[:GF_SIZE]])),
        "exp0": t(ALPHA_TO),                       # exp0[A0] == 0
        "log": t(INDEX_OF),
        "synd": t(_SYND_M_NP, torch.float32),
        "chien": chien,
        "omega": chien[:NROOTS],
        "den": chien[0:NROOTS:2],                  # exponents 0, 2, 4
        "num2": t(_NUM2_NP, torch.uint8),
    }


def _gmul(a: torch.Tensor, b: torch.Tensor, tb: dict) -> torch.Tensor:
    """GF(256) multiply, log-table form (small tensors only)."""
    zero = (a == 0) | (b == 0)
    idx = torch.where(zero, 0, tb["log"][a.long()] + tb["log"][b.long()])
    return torch.where(zero, 0, tb["exp"][idx.long()])


def _gmul_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Carry-less GF(2^8) multiply mod 0x187: 8 shift/xor/select steps
    on uint8 field elements (the left shift drops x^8 by itself)."""
    a, b = torch.broadcast_tensors(a.to(torch.uint8), b.to(torch.uint8))
    res = torch.zeros_like(a)
    zero = torch.zeros((), dtype=torch.uint8, device=a.device)
    red = torch.full((), 0x87, dtype=torch.uint8, device=a.device)
    for _ in range(8):
        res = res ^ torch.where((b & 1) != 0, a, zero)
        b = b >> 1
        a = (a << 1) ^ torch.where(a >= 0x80, red, zero)
    return res


def _ginv_bits(x: torch.Tensor) -> torch.Tensor:
    """GF(2^8) inverse by Fermat (x^254); 0 for x == 0."""
    sq = _gmul_bits(x, x)
    acc = sq
    for _ in range(6):
        sq = _gmul_bits(sq, sq)
        acc = _gmul_bits(acc, sq)
    return acc


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    return functools.reduce(torch.bitwise_xor, x.unbind(dim))


def rs_decode_batch(codewords: torch.Tensor, erase_pos: torch.Tensor,
                    n_erase: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a batch of RS(255,249) codewords.

    Args:
      codewords: (B, 255) uint8/int32.
      erase_pos: (B, NROOTS) int32 erasure byte positions (entries
        beyond ``n_erase[b]`` ignored).
      n_erase: (B,) int32 erasure counts (<= NROOTS).
    Returns:
      (corrected (B, 255) uint8, count (B,) int32; -1 = failure).
    """
    dev = codewords.device
    tb = _tables(dev)
    cw = codewords.to(torch.int32)
    erase_pos = erase_pos.to(torch.int32)
    n_erase = n_erase.to(torch.int32)
    B = cw.shape[0]
    T = NROOTS
    idx = torch.arange(T + 1, device=dev)

    # ---- syndromes (bit matmul) -------------------------------------
    shifts = torch.arange(8, dtype=torch.int32, device=dev)
    bits = (cw[:, :, None] >> shifts) & 1                  # (B, 255, 8)
    acc = bits.reshape(B, NN * 8).to(torch.float32) @ tb["synd"]  # (B, 48)
    sbits = acc.to(torch.int32) & 1
    s = (sbits.reshape(B, T, 8) << shifts).sum(dim=2, dtype=torch.int32)
    syn_zero = (s == 0).all(dim=1)

    # ---- erasure locator --------------------------------------------
    lam = torch.zeros((B, T + 1), dtype=torch.int32, device=dev)
    lam[:, 0] = 1
    zcol = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    for j in range(T):
        active = j < n_erase
        u = torch.remainder(NN - 1 - erase_pos[:, j], GF_SIZE)
        au = tb["exp0"][u.long()]
        shifted = torch.cat([zcol, _gmul(lam[:, :-1], au[:, None], tb)],
                            dim=1)
        lam = torch.where(active[:, None], lam ^ shifted, lam)
    b = tb["log"][lam.long()]
    el = n_erase.clone()

    # ---- Berlekamp-Massey -------------------------------------------
    a0col = torch.full((B, 1), A0, dtype=torch.int32, device=dev)
    for r in range(1, T + 1):
        active = r > n_erase
        si = torch.clamp(r - 1 - idx, 0, T - 1)
        terms = _gmul(lam, s[:, si], tb)
        terms = torch.where((idx < r)[None, :], terms, 0)
        discr = _xor_reduce(terms, 1)
        dlog = tb["log"][discr.long()]

        # t = lam + x * discr * b  (b in the log domain; b == A0 is a
        # zero coefficient, masked before the gather)
        b_nz = b[:, :-1] != A0
        tidx = torch.where(b_nz, dlog[:, None] + b[:, :-1], 0)
        tshift = torch.where(b_nz, tb["exp"][tidx.long()], 0)
        t = lam ^ torch.cat([zcol, tshift], dim=1)

        update = 2 * el <= r + n_erase - 1
        new_el = torch.where(update, r + n_erase - el, el)
        b_from_lam = torch.where(
            lam == 0, A0,
            torch.remainder(tb["log"][lam.long()] - dlog[:, None] + GF_SIZE,
                            GF_SIZE))
        b_shift = torch.cat([a0col, b[:, :-1]], dim=1)
        nz = discr != 0
        new_b = torch.where((nz & update)[:, None], b_from_lam, b_shift)
        new_lam = torch.where(nz[:, None], t, lam)

        lam = torch.where(active[:, None], new_lam, lam)
        b = torch.where(active[:, None], new_b, b)
        el = torch.where(active & nz, new_el, el)

    nz_mask = lam != 0
    deg_lambda = torch.where(nz_mask, idx[None, :], 0).amax(dim=1)

    # ---- Chien search over all positions ----------------------------
    q = _xor_reduce(_gmul_bits(lam[:, :, None], tb["chien"][None]), 1)
    is_root = q == 0                                       # (B, 255)
    root_count = is_root.sum(dim=1)
    fail_roots = root_count != deg_lambda

    # ---- omega = S(x) * lambda(x) mod x^T ---------------------------
    oi = torch.arange(T, device=dev)
    sidx = torch.clamp(oi[:, None] - idx[None, :], 0, T - 1)   # (T, T+1)
    valid = (idx[None, :] <= oi[:, None]).to(torch.int32)
    ow = _gmul(s[:, sidx], lam[:, None, :] * valid[None], tb)
    omega = _xor_reduce(ow, 2)                             # (B, T)
    deg_omega = deg_lambda - 1
    omega = torch.where(oi[None, :] <= deg_omega[:, None], omega, 0)

    # ---- Forney at every position -----------------------------------
    num1 = _xor_reduce(_gmul_bits(omega[:, :, None], tb["omega"][None]), 1)
    even_i = torch.arange(0, T, 2, device=dev)
    lim = torch.clamp(deg_lambda, max=T - 1) & ~1
    odd = lam[:, even_i + 1]
    dmask = (even_i[None, :] <= lim[:, None]) & (odd != 0)
    den = _xor_reduce(_gmul_bits(torch.where(dmask, odd, 0)[:, :, None],
                                 tb["den"][None]), 1)    # (B, 255)

    fail_den = (is_root & (den == 0)).any(dim=1)
    mag = _gmul_bits(_gmul_bits(num1, tb["num2"][None, :]), _ginv_bits(den))
    mag = torch.where((num1 != 0) & is_root & (den != 0), mag, 0)

    corrected = cw ^ mag.to(torch.int32)                   # loc k = i-1
    fail = fail_roots | fail_den | (n_erase > T)
    corrected = torch.where((syn_zero | fail)[:, None], cw, corrected)
    count = torch.where(syn_zero, 0,
                        torch.where(fail, -1, root_count.to(torch.int32)))
    return corrected.to(torch.uint8), count.to(torch.int32)


def rs_verify_batch(blocks: torch.Tensor, fec_octets: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched rs_verify (reference rs.c:32-49): shortened final blocks
    declare their absent parity positions as erasures; fec_octets == 0
    skips FEC entirely.  Kernel RS on CUDA, its plain twin on the CPU
    (fec/l2_kernel.py)."""
    from .l2_kernel import rs_verify      # l2_kernel imports this module
    if blocks.device.type == "cuda":
        blocks = blocks.to(torch.uint8).contiguous()
        fec_octets = fec_octets.to(torch.int32).contiguous()
    return rs_verify(blocks, fec_octets)
