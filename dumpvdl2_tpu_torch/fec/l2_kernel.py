"""L2 kernels (the front L2H, L2P, L2D and RS) and their plain twins.

The JAX package compiles its whole L2 step (``core/pipeline.py``'s
``_l2_sliced_impl``, ``fec/l2_tpu.py``, ``fec/rs_tpu.py``) into one XLA
executable.  Run eagerly, the same step in PyTorch issues ~2 400 small
launches a block, most of them the Reed-Solomon decoder's 6-step
recurrences and bit-serial field multiplies.  So the step is two
hand-written CUDA kernels (``csrc/l2.cu``):

* L2H ``l2_front``: the sliced step's front -- the slot compaction
  (valid slots first, capped at :func:`slot_cap` rows), each row's
  window at the symbol clock from the block's phase and power planes,
  the D8PSK decisions, the header (symbols -> bits, PRBS descramble of
  the 25 header bits, the (25,20) header FEC, the bit-reversed
  transmission length and the RS geometry) and the frame power, a
  thread block a row.  ``l2_header`` is the header alone on pre-sliced
  symbols, a thread a burst (the mesh, ``l2_decode_batch``);
* L2P ``l2_payload``: octet packing, the deinterleave of each
  (compacted) burst's 9 x 255 RS table straight from its symbols, each
  row's parity count, and the RS(255,249) errors-and-erasures decode of
  every row (the absent parity of a shortened block as erasures), a
  thread block a burst and a warp a row, the table in shared memory
  throughout.  ``l2_payload_capped`` is L2P behind the hdr-ok
  compaction: each block finds its row by a scan of ``hdr_ok``.

Two more kernels are built on L2P's device functions and keep their
stages' entry points: L2D ``l2_deinterleave`` (the table and parity
counts, no decode) and RS ``rs_verify`` (the decode of given rows, a
warp a row; ``fec/rs_batch.py::rs_verify_batch``).

``fec/l2.py`` calls :func:`l2_header`, :func:`l2_payload` and
:func:`l2_payload_capped`, ``fec/rs_batch.py`` :func:`rs_verify`;
:func:`l2_deinterleave` is L2D's.  On a CUDA tensor they launch the
kernel or raise; on a CPU tensor they run the plain version
(``*_plain``).  The front's wrapper and plain version, which compose
the DSP stage's window slicing and decisions with L2H's header, are
``core/pipeline.py``'s ``l2_front`` and ``l2_front_plain``;
:func:`l2_front_cuda` launches its kernel.  Only the CUDA path counts
in :data:`launches` (L2P behind its compaction counts as
``l2_payload``).  The kernels read
their constant tables (the GF(256) exp/log tables, the header syndrome
table, its weights and parity rows, the PRBS and its octets, the Gray
code) from this package's Python tables, uploaded once a device.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..constants import (GRAYCODE, HDRFECLEN, HEADER_LEN, MAX_FRAME_LENGTH,
                         MAX_FRAME_LENGTH_CORRECTED, RS_K, RS_N, TRLEN)
from .gf256 import ALPHA_TO, INDEX_OF
from .header import H_ROWS, SYND_WEIGHT, SYNDTABLE
from .rs import KK, NN, NROOTS
from .rs_batch import rs_decode_batch
from .scramble import PRBS

# Worst-case burst geometry (decode.c:45-48): datalen <= 0x3FFF bits
# -> 2048 data octets -> 9 RS blocks -> 8*6+4 = 52 FEC octets.
MAX_DATA_OCT = (MAX_FRAME_LENGTH + 7) // 8              # 2048
MAX_BLOCKS = -(-MAX_DATA_OCT // RS_K)                   # 9
MAX_TOTAL_OCT = MAX_DATA_OCT + (MAX_BLOCKS - 1) * (RS_N - RS_K) + 4  # 2100
# symbol columns the payload's bit window needs (16 825 bits)
MIN_SYMBOLS = -(-(HEADER_LEN + 8 * MAX_TOTAL_OCT) // 3)  # 5609

# Kernel launches since start (or the last reset by the caller).
launches = {"l2_front": 0, "l2_header": 0, "l2_payload": 0,
            "l2_deinterleave": 0, "rs_verify": 0}

# L2H's per-burst results, in the kernel's output order: int32, then bool
HDR_INT = ("syndrome", "synd_weight", "datalen", "datalen_octets",
           "num_blocks", "last_len", "bits_consumed", "lf")
HDR_BOOL = ("reserved_bad", "too_long", "no_fec", "hdr_ok")


# The front's largest window (csrc/l2.cu kFrontWin): S + 1 samples.
FRONT_WIN = 8192

# The constant bytes of L2P, L2D and RS (csrc/l2.cu kExpOff, kLogOff,
# kPrbsOff, kConstBytes): GF(256) exp over two periods, log, and the
# PRBS packed a payload octet, each padded to 16-byte chunks.
CONST_LAYOUT = {"exp": 0, "log": 512, "prbs_octets": 768, "bytes": 2880}


def prbs_octets() -> np.ndarray:
    """(MAX_TOTAL_OCT,) uint8: octet o is PRBS bits HEADER_LEN + 8 o + t,
    t = 0..7, LSB first -- what descrambles payload octet o."""
    bits = PRBS[HEADER_LEN:HEADER_LEN + 8 * MAX_TOTAL_OCT].reshape(
        MAX_TOTAL_OCT, 8).astype(np.int64)
    return (bits << np.arange(8)).sum(axis=1).astype(np.uint8)


def const_bytes() -> np.ndarray:
    """The kernels' constant bytes, laid out as :data:`CONST_LAYOUT`."""
    out = np.zeros(CONST_LAYOUT["bytes"], np.uint8)
    out[:2 * 255] = np.tile(ALPHA_TO[:255], 2)
    out[CONST_LAYOUT["log"]:CONST_LAYOUT["log"] + 256] = INDEX_OF
    o = CONST_LAYOUT["prbs_octets"]
    out[o:o + MAX_TOTAL_OCT] = prbs_octets()
    return out


@functools.lru_cache(maxsize=4)
def _tables(device: torch.device) -> dict[str, torch.Tensor]:
    """Constant tables, uploaded once per device."""
    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return {"synd": t(SYNDTABLE), "weight": t(SYND_WEIGHT),
            "h_rows": t(H_ROWS), "prbs": t(PRBS, torch.uint8),
            "gray": t(GRAYCODE, torch.uint8),
            "consts": t(const_bytes(), torch.uint8)}


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def _parity32(v: torch.Tensor) -> torch.Tensor:
    """Bitwise parity of each int32 element (shift/xor fold)."""
    v = v ^ (v >> 16)
    v = v ^ (v >> 8)
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    return v & 1


def _fec_octetcount(last_len: torch.Tensor) -> torch.Tensor:
    """get_fec_octetcount (decode.c:124-133) as nested selects."""
    return torch.where(last_len < 3, 0,
                       torch.where(last_len < 31, 2,
                                   torch.where(last_len < 68, 4, 6)))


def _clear_bits(symbols: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Descrambled bits [lo, hi) of each row: symbols -> bits (MSB of
    each 3-bit symbol first, demod.c:274), XOR the PRBS."""
    B, S = symbols.shape
    dev = symbols.device
    shifts = torch.tensor([2, 1, 0], dtype=torch.int32, device=dev)
    bits = ((_i32(symbols)[:, :, None] >> shifts) & 1).reshape(B, 3 * S)
    return bits[:, lo:hi] ^ _i32(_tables(dev)["prbs"][lo:hi])[None, :]


def _check(name: str, x: torch.Tensor, dtype, dim: int,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype or x.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D {dtype}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_symbols(symbols: torch.Tensor) -> None:
    _check("symbols", symbols, torch.uint8, 2, symbols.device)
    S = symbols.shape[1]
    if not MIN_SYMBOLS <= S <= PRBS.size // 3:
        raise ValueError(f"symbols have {S} columns, need "
                         f"{MIN_SYMBOLS}..{PRBS.size // 3}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _launcher(name: str, argtypes: list):
    from .. import kernels
    fn = getattr(kernels.load("l2"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


# ------------------------------------------------------------------ L2H
def l2_header_plain(symbols: torch.Tensor) -> dict:
    """Plain L2H: the header and geometry of each burst.

    ``symbols`` (B, S) uint8 gray-decoded 3-bit symbols.  Returns a dict
    of (B,) tensors: ``syndrome``, ``synd_weight``, ``datalen``,
    ``datalen_octets``, ``num_blocks``, ``last_len``,
    ``bits_consumed`` and ``lf`` (the last RS row's parity count; 6 for
    a full final block) int32; ``reserved_bad``, ``too_long``,
    ``no_fec``, ``hdr_ok`` bool.  Arithmetic is int32, as in the JAX
    code.
    """
    dev = symbols.device
    tb = _tables(dev)
    clear = _clear_bits(symbols, 0, HEADER_LEN)

    # ---- (25,20) header FEC (decode.c:111-122) ----------------------
    w_hdr = 1 << torch.arange(HEADER_LEN - 1, -1, -1, dtype=torch.int32,
                              device=dev)
    word = (clear * w_hdr[None, :]).sum(dim=1, dtype=torch.int32)
    word = word & ((1 << (TRLEN + HDRFECLEN)) - 1)      # zero reserved bits
    synd = torch.zeros_like(word)
    for i, row in enumerate(H_ROWS):
        synd = synd | (_parity32(word & row) << (HDRFECLEN - 1 - i))
    corrected = word ^ tb["synd"][synd.long()]
    weight = tb["weight"][synd.long()]
    reserved_bad = (corrected >> (TRLEN + HDRFECLEN)) != 0

    trfield = (corrected >> HDRFECLEN) & ((1 << TRLEN) - 1)
    datalen = torch.zeros_like(trfield)
    for i in range(TRLEN):                              # bit-reverse TRLEN
        datalen = datalen | (((trfield >> i) & 1) << (TRLEN - 1 - i))
    too_long = ((synd != 0) & (datalen > MAX_FRAME_LENGTH_CORRECTED)) \
        | (datalen > MAX_FRAME_LENGTH)

    # ---- geometry (burst_geometry / decode.c:222-258) ----------------
    doct = torch.div(datalen + 7, 8, rounding_mode="floor")
    q = torch.div(doct, RS_K, rounding_mode="floor")
    r = doct - q * RS_K
    num_blocks = _i32(q + (r != 0).to(torch.int32))
    last_len = _i32(torch.where(r == 0, RS_K, r))
    fec_last = _i32(torch.where(r == 0, 0, _fec_octetcount(r)))
    fec_total = _i32(q * (RS_N - RS_K) + fec_last)
    no_fec = fec_total == 0
    hdr_ok = ~reserved_bad & ~too_long & ~no_fec
    # last row's parity count (r == 0 -> full 6-octet final block)
    lf = _i32(torch.where(r == 0, RS_N - RS_K, fec_last))
    bits_consumed = _i32(HEADER_LEN + 8 * (doct + fec_total))
    return {"syndrome": synd, "synd_weight": weight,
            "reserved_bad": reserved_bad, "too_long": too_long,
            "no_fec": no_fec, "hdr_ok": hdr_ok, "datalen": datalen,
            "datalen_octets": _i32(doct), "num_blocks": num_blocks,
            "last_len": last_len, "bits_consumed": bits_consumed,
            "lf": lf}


def l2_header_cuda(symbols: torch.Tensor) -> dict:
    """Launch kernel L2H on the current stream (no fallback).  Argument
    and results as :func:`l2_header_plain`."""
    dev = symbols.device
    if dev.type != "cuda":
        raise ValueError("l2_header_cuda needs CUDA tensors")
    _check_symbols(symbols)
    B, S = symbols.shape
    tb = _tables(dev)
    # one allocation: the int32 results, then the bool ones
    n_int = len(HDR_INT) * B
    out = torch.empty(n_int + (len(HDR_BOOL) * B + 3) // 4,
                      dtype=torch.int32, device=dev)
    ints = out[:n_int].split(B)
    bools = [x.view(torch.bool) for x in
             out[n_int:].view(torch.uint8)[:len(HDR_BOOL) * B].split(B)]
    fn = _launcher("l2_header_launch",
                   [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 7)
    with torch.cuda.device(dev):
        rc = fn(symbols.data_ptr(), B, S, tb["synd"].data_ptr(),
                tb["weight"].data_ptr(), tb["h_rows"].data_ptr(),
                tb["prbs"].data_ptr(), out.data_ptr(),
                out[n_int:].data_ptr(), _stream(symbols))
    _raise_on(rc, "l2_header")
    launches["l2_header"] += 1
    return {**dict(zip(HDR_INT, ints)), **dict(zip(HDR_BOOL, bools))}


def l2_header(symbols: torch.Tensor) -> dict:
    """L2H on the tensor's device: the kernel on CUDA, plain on CPU."""
    if _device_of(symbols) == "cuda":
        return l2_header_cuda(symbols)
    return l2_header_plain(symbols)


# ------------------------------------------------------------------ L2D
def l2_deinterleave_plain(symbols, sel, hdr_ok, num_blocks, last_len, lf,
                          doct) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain L2D: the deinterleaved RS table of each selected burst.

    ``symbols`` (B, S) uint8; ``sel`` (Bp,) int64 the rows to decode,
    or None for all B; ``hdr_ok`` (B,) bool and ``num_blocks``,
    ``last_len``, ``lf``, ``doct`` (B,) int32 L2H's results.  Returns
    ``(tab (Bp, 9, 255) uint8, fec_row (Bp, 9) int32)``: cell (row, col)
    of a burst's table holds the descrambled octet at transmission index
    col*(nb-1) + min(col, last_len) + row (data) or the FEC region's
    counterpart, 0 in pad cells and for rejected bursts; ``fec_row`` the
    parity octets present in each row (0 = skip RS).
    """
    dev = symbols.device
    nb = _i32(torch.where(hdr_ok, num_blocks, 0))
    if sel is not None:
        symbols, nb, hdr_ok = symbols[sel], nb[sel], hdr_ok[sel]
        last_len, lf, doct = last_len[sel], lf[sel], doct[sel]
    Bp = symbols.shape[0]

    # ---- octet packing (LSB-first, bitstream_read_lsbfirst order) ----
    w_oct = 1 << torch.arange(8, dtype=torch.int32, device=dev)
    po = _clear_bits(symbols, HEADER_LEN, HEADER_LEN + 8 * MAX_TOTAL_OCT)
    octets = (po.reshape(Bp, MAX_TOTAL_OCT, 8) * w_oct).sum(
        dim=2, dtype=torch.int32)                       # (Bp, 2100)

    # ---- deinterleave as a gather (fec/interleave.py mapping) --------
    # Destination cell (row, col) of the (nb, 255) table takes
    # transmission index  col*(nb-1) + min(col, cpr) + row.
    rows = torch.arange(MAX_BLOCKS, dtype=torch.int32, device=dev)[None, :, None]
    cols = torch.arange(RS_N, dtype=torch.int32, device=dev)[None, None, :]
    nb_ = nb[:, None, None]
    ll_ = torch.where(hdr_ok, last_len, 0)[:, None, None]
    lf_ = torch.where(hdr_ok, lf, 0)[:, None, None]
    doct_ = torch.where(hdr_ok, doct, 0)[:, None, None]

    is_data = cols < RS_K
    cf = cols - RS_K                                    # FEC-region column
    src_data = cols * (nb_ - 1) + torch.minimum(cols, ll_) + rows
    src_fec = doct_ + cf * (nb_ - 1) + torch.minimum(cf, lf_) + rows
    src = torch.where(is_data, src_data, src_fec)
    cpr = torch.where(is_data,
                      torch.where(rows < nb_ - 1, RS_K, ll_),
                      torch.where(rows < nb_ - 1, RS_N - RS_K, lf_))
    valid = (rows < nb_) & (torch.where(is_data, cols, cf) < cpr)
    src = torch.clamp(torch.where(valid, src, 0), 0, MAX_TOTAL_OCT - 1)
    tab = torch.gather(octets, 1, src.reshape(Bp, -1).long())
    tab = tab.reshape(Bp, MAX_BLOCKS, RS_N) * valid     # pad cells zero

    rows1 = rows[0, :, 0]
    row_is_last = rows1 == (nb[:, None] - 1)            # (Bp, MAX_BLOCKS)
    fec_row = torch.where(rows1 < nb[:, None] - 1, RS_N - RS_K,
                          torch.where(row_is_last, lf[:, None], 0))
    fec_row = _i32(torch.where(hdr_ok[:, None], fec_row, 0))
    return tab.to(torch.uint8), fec_row


def _payload_geometry(symbols, hdr_ok, num_blocks, last_len, lf,
                      doct) -> int:
    """Check L2P's and L2D's burst arguments on the card; returns B."""
    dev = symbols.device
    _check_symbols(symbols)
    B = symbols.shape[0]
    _check("hdr_ok", hdr_ok, torch.bool, 1, dev)
    geom = (num_blocks, last_len, lf, doct)
    for name, x in zip(("num_blocks", "last_len", "lf", "doct"), geom):
        _check(name, x, torch.int32, 1, dev)
    if any(x.shape[0] != B for x in (hdr_ok, *geom)):
        raise ValueError(f"per-burst arrays must have {B} rows")
    return B


# The row arguments of L2P (B, Bp) and L2D (its row index, Bp).
_PAYLOAD_ROWS = {"l2_payload": [ctypes.c_int, ctypes.c_int],
                 "l2_deinterleave": [ctypes.c_void_p, ctypes.c_int]}


def _launch_payload(name: str, symbols, rows: tuple, geom: tuple,
                    outs: tuple) -> None:
    """Launch ``name`` (L2P or L2D) on the current stream: the symbols,
    ``rows`` (L2P's B and Bp; L2D's row index and Bp), the burst
    arguments ``geom`` (hdr_ok, num_blocks, last_len, lf, doct), the
    constant bytes, then the outputs ``outs`` (None is a null pointer)."""
    fn = _launcher(f"{name}_launch",
                   [ctypes.c_void_p, ctypes.c_int] + _PAYLOAD_ROWS[name]
                   + [ctypes.c_void_p] * (len(geom) + len(outs) + 2))

    def ptr(x):
        return None if x is None else x.data_ptr()
    with torch.cuda.device(symbols.device):
        rc = fn(symbols.data_ptr(), symbols.shape[1], *rows,
                *map(ptr, geom), _tables(symbols.device)["consts"].data_ptr(),
                *map(ptr, outs), _stream(symbols))
    _raise_on(rc, name)
    launches[name] += 1


def l2_deinterleave_cuda(symbols, sel, hdr_ok, num_blocks, last_len, lf,
                         doct) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel L2D on the current stream (no fallback).  Arguments
    and results as :func:`l2_deinterleave_plain`."""
    dev = symbols.device
    if dev.type != "cuda":
        raise ValueError("l2_deinterleave_cuda needs CUDA tensors")
    geom = (hdr_ok, num_blocks, last_len, lf, doct)
    Bp = _payload_geometry(symbols, *geom)
    if sel is not None:
        _check("sel", sel, torch.int64, 1, dev)
        Bp = sel.shape[0]
    tab = torch.empty((Bp, MAX_BLOCKS, RS_N), dtype=torch.uint8, device=dev)
    fec_row = torch.empty((Bp, MAX_BLOCKS), dtype=torch.int32, device=dev)
    _launch_payload("l2_deinterleave", symbols,
                    (None if sel is None else sel.data_ptr(), Bp), geom,
                    (tab, fec_row))
    return tab, fec_row


def l2_deinterleave(symbols, sel, hdr_ok, num_blocks, last_len, lf, doct
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """L2D on the tensors' device: the kernel on CUDA, plain on CPU.
    Arguments as :func:`l2_deinterleave_plain`."""
    if _device_of(symbols) == "cuda":
        return l2_deinterleave_cuda(symbols, sel, hdr_ok, num_blocks,
                                    last_len, lf, doct)
    return l2_deinterleave_plain(symbols, sel, hdr_ok, num_blocks,
                                 last_len, lf, doct)


# ------------------------------------------------------------------- RS
def rs_verify_plain(blocks: torch.Tensor, fec_octets: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain RS: batched rs_verify (reference rs.c:32-49).

    ``blocks`` (N, 255) uint8 (or int32 octets), ``fec_octets`` (N,)
    int32 the parity octets present.  Shortened final blocks declare
    their absent parity positions as erasures; fec_octets == 0 skips
    FEC entirely.  Returns ``(corrected (N, 255) uint8, count (N,)
    int32)``: count is the corrected positions, 0 for a skipped row or a
    zero syndrome, -1 for a failure (the row then passes through)."""
    dev = blocks.device
    fec_octets = fec_octets.to(torch.int32)
    cnt = NROOTS - fec_octets                              # erasures
    pos = KK + fec_octets[:, None] + torch.arange(
        NROOTS, dtype=torch.int32, device=dev)[None, :]
    pos = torch.clamp(pos, 0, NN - 1)
    corrected, count = rs_decode_batch(blocks, pos, cnt)
    skip = fec_octets == 0
    corrected = torch.where(skip[:, None], blocks.to(torch.uint8), corrected)
    count = torch.where(skip, 0, count)
    return corrected, count.to(torch.int32)


def rs_verify_cuda(blocks: torch.Tensor, fec_octets: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel RS on the current stream (no fallback).  ``blocks``
    (N, 255) uint8; arguments and results otherwise as
    :func:`rs_verify_plain`."""
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError("rs_verify_cuda needs CUDA tensors")
    _check("blocks", blocks, torch.uint8, 2, dev)
    _check("fec_octets", fec_octets, torch.int32, 1, dev)
    N = blocks.shape[0]
    if blocks.shape[1] != RS_N or fec_octets.shape[0] != N:
        raise ValueError(f"blocks must be (N, {RS_N}) with N fec_octets, "
                         f"got {tuple(blocks.shape)}, "
                         f"{tuple(fec_octets.shape)}")
    out = torch.empty_like(blocks)
    count = torch.empty(N, dtype=torch.int32, device=dev)
    fn = _launcher("rs_verify_launch",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 4)
    with torch.cuda.device(dev):
        rc = fn(blocks.data_ptr(), fec_octets.data_ptr(), N,
                _tables(dev)["consts"].data_ptr(), out.data_ptr(),
                count.data_ptr(), _stream(blocks))
    _raise_on(rc, "rs_verify")
    launches["rs_verify"] += 1
    return out, count


def rs_verify(blocks: torch.Tensor, fec_octets: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """RS on the tensors' device: the kernel on CUDA, plain on CPU.
    Arguments as :func:`rs_verify_plain`."""
    if _device_of(blocks) == "cuda":
        return rs_verify_cuda(blocks, fec_octets)
    return rs_verify_plain(blocks, fec_octets)


# ------------------------------------------------------------------ L2P
def l2_payload_plain(symbols, hdr_ok, num_blocks, last_len, lf, doct
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain L2P: :func:`l2_deinterleave_plain` of every burst, then
    :func:`rs_verify_plain` on every row of the tables.  Arguments as
    :func:`l2_deinterleave_plain` without ``sel``.  Returns
    ``(corrected (B, 9, 255) uint8, counts (B, 9) int32, fec_row (B, 9)
    int32)``."""
    tab, fec_row = l2_deinterleave_plain(symbols, None, hdr_ok, num_blocks,
                                         last_len, lf, doct)
    B = tab.shape[0]
    corr, counts = rs_verify_plain(tab.reshape(B * MAX_BLOCKS, RS_N),
                                   fec_row.reshape(B * MAX_BLOCKS))
    return (corr.reshape(B, MAX_BLOCKS, RS_N),
            counts.reshape(B, MAX_BLOCKS), fec_row)


def l2_payload_cuda(symbols, hdr_ok, num_blocks, last_len, lf, doct
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel L2P on the current stream (no fallback), a CTA a
    burst.  Arguments and results as :func:`l2_payload_plain`; the
    counts and parity counts share one allocation."""
    dev = symbols.device
    if dev.type != "cuda":
        raise ValueError("l2_payload_cuda needs CUDA tensors")
    geom = (hdr_ok, num_blocks, last_len, lf, doct)
    B = _payload_geometry(symbols, *geom)
    tab = torch.empty((B, MAX_BLOCKS, RS_N), dtype=torch.uint8, device=dev)
    counts, fec_row = torch.empty((2, B, MAX_BLOCKS), dtype=torch.int32,
                                  device=dev).unbind()
    _launch_payload("l2_payload", symbols, (B, B), geom,
                    (tab, counts, fec_row, None))
    return tab, counts, fec_row


def l2_payload(symbols, hdr_ok, num_blocks, last_len, lf, doct
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """L2P on the tensors' device: the kernel on CUDA, plain on CPU.
    Arguments as :func:`l2_payload_plain`."""
    if _device_of(symbols) == "cuda":
        return l2_payload_cuda(symbols, hdr_ok, num_blocks, last_len, lf,
                               doct)
    return l2_payload_plain(symbols, hdr_ok, num_blocks, last_len, lf, doct)


def compact_rows(keep: torch.Tensor, cap: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable compaction: the first ``cap`` indices with ``keep`` set
    (then the others, in index order), and the inverse map index ->
    compacted row (-1 = not taken)."""
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    take = order[:cap]
    inv = torch.full(keep.shape, -1, dtype=torch.int32, device=keep.device)
    inv[take] = torch.arange(cap, dtype=torch.int32, device=keep.device)
    return take, inv


def l2_payload_capped_plain(symbols, cap: int, hdr_ok, num_blocks, last_len,
                            lf, doct) -> tuple[torch.Tensor, ...]:
    """Plain L2P behind the hdr-ok compaction: :func:`l2_payload_plain`
    on the first ``cap`` rows of the stable order (accepted bursts
    first).  Arguments as it takes them, after ``cap``.  Returns its
    three results (``cap`` rows) and ``blocks_row`` (B,) int32: burst ->
    compacted row, -1 past ``cap``."""
    sel, blocks_row = compact_rows(hdr_ok, cap)
    rows = (x[sel] for x in (symbols, hdr_ok, num_blocks, last_len, lf,
                             doct))
    return (*l2_payload_plain(*rows), blocks_row)


def l2_payload_capped_cuda(symbols, cap: int, hdr_ok, num_blocks, last_len,
                           lf, doct) -> tuple[torch.Tensor, ...]:
    """Launch kernel L2P with its compaction prologue (no fallback):
    each CTA finds its row by a block scan of ``hdr_ok`` and writes its
    share of ``blocks_row``.  Arguments and results as
    :func:`l2_payload_capped_plain`."""
    dev = symbols.device
    if dev.type != "cuda":
        raise ValueError("l2_payload_capped_cuda needs CUDA tensors")
    geom = (hdr_ok, num_blocks, last_len, lf, doct)
    B = _payload_geometry(symbols, *geom)
    if not 0 < cap <= B:
        raise ValueError(f"cap {cap} outside 1..{B}")
    tab = torch.empty((cap, MAX_BLOCKS, RS_N), dtype=torch.uint8, device=dev)
    ints = torch.empty(2 * cap * MAX_BLOCKS + B, dtype=torch.int32,
                       device=dev)
    counts, fec_row = ints[:2 * cap * MAX_BLOCKS].view(
        2, cap, MAX_BLOCKS).unbind()
    blocks_row = ints[2 * cap * MAX_BLOCKS:]
    _launch_payload("l2_payload", symbols, (B, cap), geom,
                    (tab, counts, fec_row, blocks_row))
    return tab, counts, fec_row, blocks_row


def l2_payload_capped(symbols, cap: int, hdr_ok, num_blocks, last_len, lf,
                      doct) -> tuple[torch.Tensor, ...]:
    """L2P behind the hdr-ok compaction on the tensors' device: the
    kernel on CUDA, plain on CPU.  See :func:`l2_payload_capped_plain`."""
    if _device_of(symbols) == "cuda":
        return l2_payload_capped_cuda(symbols, cap, hdr_ok, num_blocks,
                                      last_len, lf, doct)
    return l2_payload_capped_plain(symbols, cap, hdr_ok, num_blocks,
                                   last_len, lf, doct)


# ------------------------------------------------------- L2H: the front
def slot_cap(C: int, K: int) -> int:
    """Rows of the L2 batch for a (C, K) slot grid: max(256, 4 C), at
    most every slot."""
    return min(C * K, max(256, 4 * C))


def _check_front(phases, pwr, count, sync_idx, dphi, K: int, S: int
                 ) -> None:
    dev = phases.device
    C = count.shape[0]
    _check("phases", phases, torch.float32, 2, dev)
    _check("pwr", pwr, torch.float32, 2, dev)
    _check("count", count, torch.int32, 1, dev)
    _check("sync_idx", sync_idx, torch.int32, 2, dev)
    _check("dphi", dphi, torch.float32, 2, dev)
    M = phases.shape[1]
    if phases.shape != (C, M) or pwr.shape != (C, M) \
            or sync_idx.shape != (C, K) or dphi.shape != (C, K):
        raise ValueError(f"front arguments disagree: phases "
                         f"{tuple(phases.shape)}, pwr {tuple(pwr.shape)}, "
                         f"count {C}, sync_idx {tuple(sync_idx.shape)}, "
                         f"dphi {tuple(dphi.shape)}, K={K}")
    if not MIN_SYMBOLS <= S <= min(PRBS.size // 3, FRONT_WIN - 1):
        raise ValueError(f"S={S} outside {MIN_SYMBOLS}.."
                         f"{min(PRBS.size // 3, FRONT_WIN - 1)}")
    if not 0 < M < 2 ** 31 or C * K >= 2 ** 31:     # C ints in the kernel
        raise ValueError(f"unsupported shape ({C}, {M}) with K={K}")


def l2_front_cuda(phases: torch.Tensor, pwr: torch.Tensor,
                  count: torch.Tensor, sync_idx: torch.Tensor,
                  dphi: torch.Tensor, K: int, S: int) -> dict:
    """Launch kernel L2H's front on the current stream (no fallback): a
    CTA a compacted row.  Arguments and results as
    ``core/pipeline.py``'s ``l2_front_plain``."""
    dev = phases.device
    if dev.type != "cuda":
        raise ValueError("l2_front_cuda needs CUDA tensors")
    _check_front(phases, pwr, count, sync_idx, dphi, K, S)
    C, M = phases.shape
    total = C * K
    cap = slot_cap(C, K)
    compact = cap < total
    tb = _tables(dev)
    take = torch.empty(cap, dtype=torch.int64, device=dev)
    inv = torch.empty(total, dtype=torch.int32, device=dev) \
        if compact else None
    symbols = torch.empty((cap, S), dtype=torch.uint8, device=dev)
    # one allocation: the header's int32 results, frame_pwr, the flags
    n_int = len(HDR_INT) * cap
    out = torch.empty(n_int + cap + (len(HDR_BOOL) * cap + 3) // 4,
                      dtype=torch.int32, device=dev)
    ints = out[:n_int].split(cap) if cap else [out[:0]] * len(HDR_INT)
    frame_pwr = out[n_int:n_int + cap].view(torch.float32)
    flag_bytes = out[n_int + cap:].view(torch.uint8)
    bools = [flag_bytes[i * cap:(i + 1) * cap].view(torch.bool)
             for i in range(len(HDR_BOOL))]
    if cap:
        fn = _launcher("l2_front_launch",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 12)
        with torch.cuda.device(dev):
            rc = fn(phases.data_ptr(), pwr.data_ptr(), C, M,
                    count.data_ptr(), sync_idx.data_ptr(), dphi.data_ptr(),
                    K, S, cap, int(compact), tb["gray"].data_ptr(),
                    tb["synd"].data_ptr(), tb["weight"].data_ptr(),
                    tb["h_rows"].data_ptr(), tb["prbs"].data_ptr(),
                    take.data_ptr(), None if inv is None else inv.data_ptr(),
                    symbols.data_ptr(), out.data_ptr(),
                    flag_bytes.data_ptr(), frame_pwr.data_ptr(),
                    _stream(phases))
        _raise_on(rc, "l2_front")
        launches["l2_front"] += 1
    return {"take": take, "inv": inv, "symbols": symbols,
            **dict(zip(HDR_INT, ints)), **dict(zip(HDR_BOOL, bools)),
            "frame_pwr": frame_pwr}

