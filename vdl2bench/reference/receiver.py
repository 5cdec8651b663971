"""The benchmark's plain reference: a VDL2 receiver in float64 PyTorch.

It works out from the raw samples (and the scene's transmitted bursts)
what a receiver with the port's semantics emits, over one continuous
span with no blocks, no halo, no slot caps and no kernels:

1. the channelizer: the 2-pole Chebyshev low-pass (its design copied
   from ``dumpvdl2_tpu_torch/dsp/chebyshev.py`` at commit 3d62869,
   taps kept in float64) applied to the input mixed by each channel's
   24-bit NCO (demod.c:312-317,385), decimated by the oversample factor.
   The mix is folded into modulated taps (an exact identity, since the
   NCO phase is linear in the sample index modulo 2**24), so the filter
   is one float64 matrix product a chunk; ``tests`` hold it to the
   direct mix, filter and decimate;
2. the phase and power planes, the 16-symbol preamble fit (sync metric)
   at every sample, the detections (below-threshold local minima that
   lead their cluster, parabola-vertex symbol clock) -- the definitions
   of ``dsp/sync_kernel.py::sync_error_metric_plain`` and
   ``dsp/candidates_kernel.py::candidates_plain``, in float64;
3. the header of every detection (D8PSK decisions, descrambling, the
   (25,20) header code, the length checks of ``burst.header_info``) and
   the per-channel busy rule of ``_process_candidates``: a detection
   inside a claimed window is skipped, a rejected header claims 9
   symbols, an accepted burst its length;
4. for each accepted burst that is a transmitted one (its channel's or a
   neighbour's, by length and time), its symbol decisions against the
   transmitted bits: the frame is emitted when every RS row is within
   the code's reach (2 errors + erasures <= 6; no error in a row without
   parity);
5. the noise-floor tracker (demod.c:238-243): magnitudes of every third
   fresh sample of each fed block, an EMA over those outside claimed
   windows, a floor update at every 1000th, read at each burst's sync
   point.

It imports nothing of the program and takes nothing the program made.
"""
from __future__ import annotations

import math
from functools import lru_cache
from itertools import combinations

import numpy as np
import torch

from ..traffic import synth

SPS = 10
SYMBOL_RATE = 10500
SYNC_THRESHOLD = 4.0
HEADER_LEN = 25
TRLEN, HDRFECLEN = 17, 5
MAX_FRAME_LENGTH = 0x3FFF
MAX_FRAME_LENGTH_CORRECTED = 0x1FFF
PREAMBLE_SYMS = 16
LOOKBACK = (PREAMBLE_SYMS - 1) * SPS
NMS_WIN = 2 * SPS
MAG_LP = 0.9
NF_LP = 0.85
MASK24 = 0xFFFFFF
PR_PHASE = np.array(synth.PREAMBLE_PHASE_UNITS, np.float64) * (np.pi / 4)
LR_X = np.arange(PREAMBLE_SYMS, dtype=np.float64) - (PREAMBLE_SYMS - 1) / 2.0
LR_DENOM = float((LR_X ** 2).sum())
GRAY = np.array(synth.GRAYCODE, np.int64)


# ------------------------------------------------------------------ taps
def _pole_biquad(p: int, cutoff: float, ripple: float, npoles: int):
    angle = math.pi / (2 * npoles) + (p - 1) * math.pi / npoles
    rp, ip = -math.cos(angle), math.sin(angle)
    es = math.sqrt((100.0 / (100.0 - ripple)) ** 2 - 1.0)
    vx = (1.0 / npoles) * math.log(1.0 / es + math.sqrt(1.0 / es ** 2 + 1.0))
    kx = (1.0 / npoles) * math.log(1.0 / es + math.sqrt(1.0 / es ** 2 - 1.0))
    kx = math.cosh(kx)
    rp *= math.sinh(vx) / kx
    ip *= math.cosh(vx) / kx
    t = 2.0 * math.tan(0.5)
    w = 2.0 * math.pi * cutoff
    m = rp * rp + ip * ip
    d = 4.0 - 4.0 * rp * t + m * t * t
    x0 = t * t / d
    x1, x2 = 2.0 * x0, x0
    y1 = (8.0 - 2.0 * m * t * t) / d
    y2 = (-4.0 - 4.0 * rp * t - m * t * t) / d
    k = math.sin(0.5 - w / 2.0) / math.sin(0.5 + w / 2.0)
    d = 1.0 + y1 * k - y2 * k * k
    a = np.array([(x0 - x1 * k + x2 * k * k) / d,
                  (-2.0 * x0 * k + x1 + x1 * k * k - 2.0 * x2 * k) / d,
                  (x0 * k * k - x1 * k + x2) / d])
    b = np.array([(2.0 * k + y1 + y1 * k * k - 2.0 * y2 * k) / d,
                  (-(k * k) - y1 * k + y2) / d])
    return a, b


@lru_cache(maxsize=8)
def lpf_taps(sample_rate: int, oversample: int, cutoff_hz: int = 8000,
             ripple_percent: float = 0.5, npoles: int = 2,
             tol: float = 1e-9) -> np.ndarray:
    """The Chebyshev low-pass's truncated impulse response, float64,
    zero-padded to a multiple of ``oversample``."""
    num, den = np.array([1.0]), np.array([1.0])
    for p in range(1, npoles // 2 + 1):
        a, b = _pole_biquad(p, cutoff_hz / sample_rate, ripple_percent,
                            npoles)
        num = np.convolve(num, a)
        den = np.convolve(den, np.concatenate([[1.0], -b]))
    a_out, b_out = np.zeros(npoles + 1), np.zeros(npoles + 1)
    a_out[:num.size] = num
    b_out[1:den.size] = -den[1:]
    a_out /= a_out.sum() / (1.0 - b_out[1:].sum())
    max_taps = 1 << 16
    h = np.zeros(max_taps)
    x, y = np.zeros(npoles + 1), np.zeros(npoles + 1)
    for n in range(max_taps):
        x[1:] = x[:-1]
        x[0] = 1.0 if n == 0 else 0.0
        val = float((a_out * x).sum() + (b_out[1:] * y[:npoles]).sum())
        y[1:] = y[:-1]
        y[0] = val
        h[n] = val
    nz = np.nonzero(np.abs(h) > tol * np.abs(h).max())[0]
    ntaps = -(-(int(nz[-1]) + 1) // 16) * 16
    h = h[:ntaps]
    return np.concatenate([h, np.zeros((-ntaps) % oversample)])


def nco_dphi(center: float, freq: float, fs: float) -> int:
    """24-bit fixed-point NCO increment (demod.c:385), as a uint32."""
    return int(np.uint32(np.int64(int((float(center) - float(freq))
                                      / float(fs) * 256.0 * 65536.0))))


def nco_angle(idx: torch.Tensor, dphi: torch.Tensor) -> torch.Tensor:
    """(C, len(idx)) float64 angle ((idx * dphi) mod 2**24) * 2 pi/2**24."""
    phi = ((idx & MASK24)[None, :] * dphi[:, None]) & MASK24
    return phi.to(torch.float64) * (2.0 * np.pi / float(1 << 24))


# ------------------------------------------------------------ channelizer
class Channelizer:
    """Decimated channel samples of a raw stream whose sample 0 is the
    stream's first.  Decimated sample d is the filter output at raw
    sample ``os * (d + 1) - 1``: sum over t of h[t] x[G - t] e^{j
    phi(G - t)}, x zero before the stream.  ``precision`` "float64" is
    the reference; "tf32" computes the same in float32 with the matrix
    product's operands rounded to TF32's 10-bit mantissa, as the tensor
    cores take them (the control; the rounding is explicit, so it reads
    the same on any device)."""

    def __init__(self, freqs, center, fs, oversample, device,
                 precision: str = "float64"):
        self.os = int(oversample)
        self.device = torch.device(device)
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" \
            else torch.float32
        h = torch.as_tensor(lpf_taps(int(fs), self.os), dtype=torch.float64,
                            device=self.device)
        self.T = h.shape[0]
        self.dphi = torch.as_tensor([nco_dphi(center, f, fs) for f in freqs],
                                    dtype=torch.int64, device=self.device)
        C = len(freqs)
        # window element u holds x[G - (T-1-u)]: the tap it meets is
        # t = T-1-u, its conjugate NCO phase -phi(t)
        t = torch.arange(self.T - 1, -1, -1, device=self.device)
        ang = nco_angle(t, self.dphi).T                   # (T, C)
        kr = h.flip(0)[:, None] * torch.cos(ang)
        ki = -h.flip(0)[:, None] * torch.sin(ang)
        self.kernel = self._operand(torch.cat([torch.cat([kr, ki], 1),
                                               torch.cat([-ki, kr], 1)], 0)
                                    .to(self.dtype))      # (2T, 2C)
        self.C = C

    def _operand(self, x: torch.Tensor) -> torch.Tensor:
        """A matrix product operand at the working precision: for "tf32"
        float32 rounded to nearest at 10 mantissa bits."""
        if self.precision != "tf32":
            return x
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    def decimate(self, raw: torch.Tensor, raw0: int, d0: int, d1: int,
                 rows: int = 8192) -> torch.Tensor:
        """Complex (C, d1 - d0) channel samples (complex128, or complex64
        for the control) for decimated indices [d0, d1), from ``raw``
        (2, L) holding raw samples raw0 .. raw0 + L - 1."""
        os_, T = self.os, self.T
        out = []
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for a in range(d0, d1, rows):
                b = min(a + rows, d1)
                g_first = os_ * (a + 1) - 1
                lo = g_first - (T - 1)                      # first raw index
                hi = os_ * b                                # one past G_{b-1}
                seg = torch.zeros((2, hi - lo), dtype=self.dtype,
                                  device=self.device)
                s, e = max(lo, raw0), min(hi, raw0 + raw.shape[1])
                if e > s:
                    seg[:, s - lo:e - lo] = raw[:, s - raw0:e - raw0] \
                        .to(self.dtype)
                win = seg.unfold(1, T, os_)                 # (2, n, T)
                w = self._operand(torch.cat([win[0], win[1]], 1)) \
                    @ self.kernel
                yr, yi = w[:, :self.C].T, w[:, self.C:].T   # (C, n)
                g = os_ * (torch.arange(a, b, device=self.device) + 1) - 1
                ang = nco_angle(g, self.dphi)
                cg, sg = torch.cos(ang), torch.sin(ang)
                if self.dtype != torch.float64:
                    cg, sg = cg.to(self.dtype), sg.to(self.dtype)
                out.append(torch.complex(yr * cg - yi * sg,
                                         yi * cg + yr * sg))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return torch.cat(out, 1)


# ------------------------------------------------------------- detection
def sync_metric(phases: torch.Tensor):
    """(err, freq) of the preamble fit ending at each sample, float64
    (err +inf, freq 0 for n < LOOKBACK); ``phases`` (C, D) float64,
    taken in chunks of columns (wider on the card, where a chunk's
    temporaries of a few hundred MB fit)."""
    C, D = phases.shape
    cols = max(16384, (1 << 21) // max(C, 1)) if phases.is_cuda else 16384
    err = torch.full((C, D), float("inf"), dtype=torch.float64,
                     device=phases.device)
    freq = torch.zeros((C, D), dtype=torch.float64, device=phases.device)
    pr = torch.as_tensor(PR_PHASE, device=phases.device)[:, None, None]
    lr = torch.as_tensor(LR_X, device=phases.device)[:, None, None]
    for n0 in range(LOOKBACK, D, cols):
        n1 = min(n0 + cols, D)
        sym = torch.stack([phases[:, n0 - LOOKBACK + i * SPS:
                                  n1 - LOOKBACK + i * SPS]
                           for i in range(PREAMBLE_SYMS)]) - pr
        d = torch.diff(sym, dim=0)
        adj = torch.where(d > np.pi, -2 * np.pi, 0.0) + \
            torch.where(d < -np.pi, 2 * np.pi, 0.0)
        ev = sym + torch.cat([torch.zeros_like(adj[:1]),
                              torch.cumsum(adj, 0)], 0)
        ev = ev - ev.mean(0, keepdim=True)
        f = (lr * ev).sum(0) / LR_DENOM
        r = ev - f * lr
        err[:, n0:n1] = (r * r).sum(0)
        freq[:, n0:n1] = f
    return err, freq


def fit_at(phases: torch.Tensor) -> torch.Tensor:
    """The fitted frequency (sync_metric's ``freq``) of rows of 16
    preamble-spaced phases, (N, 16) float64 -> (N,)."""
    ev = phases - torch.as_tensor(PR_PHASE, device=phases.device)
    d = torch.diff(ev, dim=1)
    adj = torch.where(d > np.pi, -2 * np.pi, 0.0) + \
        torch.where(d < -np.pi, 2 * np.pi, 0.0)
    ev = ev + torch.cat([torch.zeros_like(adj[:, :1]),
                         torch.cumsum(adj, 1)], 1)
    ev = ev - ev.mean(1, keepdim=True)
    return (torch.as_tensor(LR_X, device=phases.device) * ev).sum(1) \
        / LR_DENOM


def detections(err: torch.Tensor, freq: torch.Tensor,
               threshold: float = SYNC_THRESHOLD) -> dict:
    """Every cluster leader of the span, as numpy arrays sorted by
    (channel, det): ``channel``, ``det``, ``sync``, ``dphi``, ``pherr``."""
    C, D = err.shape
    e1 = torch.roll(err, 1, 1)
    mask = (e1 < threshold) & (err > e1)
    mask[:, :LOOKBACK + 2] = False
    cs = torch.cumsum(mask.to(torch.int64), 1)
    prev = torch.roll(cs, 1, 1)
    prev[:, 0] = 0
    back = torch.roll(cs, NMS_WIN + 1, 1)
    back[:, :NMS_WIN + 1] = 0
    mask &= (prev - back) == 0
    ch, det = torch.nonzero(mask, as_tuple=True)
    y1, y2, y3 = err[ch, det - 2], err[ch, det - 1], err[ch, det]
    a = (y1 - 2.0 * y2 + y3) / 2.0
    b = (3.0 * y3 - 4.0 * y2 + y1) / 2.0
    safe = torch.abs(a) > 1e-12
    vertex = torch.where(safe, -b / (2.0 * torch.where(safe, a, 1.0)), -1.0)
    sync = det - torch.round(-vertex).to(torch.int64)
    return {"channel": ch.cpu().numpy(), "det": det.cpu().numpy(),
            "sync": sync.cpu().numpy(),
            "dphi": freq[ch, det - 1].cpu().numpy(),
            "pherr": y2.cpu().numpy()}


def demod(phases: torch.Tensor, ch: np.ndarray, sync: np.ndarray,
          dphi: np.ndarray, n: int) -> np.ndarray:
    """(len(ch), n) D8PSK symbol values (Gray-decoded 3-bit) of the
    windows read at sync + SPS*s, zero past the span's end."""
    dev = phases.device
    D = phases.shape[1]
    idx = torch.as_tensor(sync, device=dev)[:, None] + \
        SPS * torch.arange(n + 1, device=dev)[None, :]
    inside = idx < D
    rows = torch.as_tensor(ch, device=dev)[:, None].expand_as(idx)
    ph = torch.where(inside, phases[rows, idx.clamp(max=D - 1)], 0.0)
    dp = ph[:, 1:] - ph[:, :-1] - torch.as_tensor(dphi, device=dev)[:, None]
    dp = torch.remainder(dp, 2 * np.pi)
    q = torch.remainder(torch.round(dp / (np.pi / 4)).to(torch.int64), 8)
    return GRAY[q.cpu().numpy()]


def symbols_to_bits(sym: np.ndarray) -> np.ndarray:
    """(..., n) 3-bit symbols -> (..., 3n) bits, MSB first."""
    return ((sym[..., None] >> np.array([2, 1, 0])) & 1).reshape(
        *sym.shape[:-1], -1).astype(np.uint8)


# ------------------------------------------------------------- header
def _synd_tables():
    patterns, weights, seen = [0] * 32, [0] * 32, {0}
    for k in range(HEADER_LEN):
        s = synth.header_syndrome(1 << k)
        patterns[s], weights[s] = 1 << k, 1
        seen.add(s)
    for s in range(32):
        if s in seen:
            continue
        best = None
        for i, j in combinations(range(HEADER_LEN), 2):
            if synth.header_syndrome((1 << i) | (1 << j)) == s:
                pair = (max(i, j), min(i, j))
                best = pair if best is None or pair > best else best
        patterns[s], weights[s] = (1 << best[0]) | (1 << best[1]), 2
    return patterns, weights


SYNDTABLE, SYND_WEIGHT = _synd_tables()


def headers(bits25: np.ndarray) -> tuple:
    """:func:`header` of each row of (n, 25) scrambled header bits, as
    arrays (ok, datalen, bits_consumed)."""
    b = (bits25 ^ synth.PRBS[:HEADER_LEN]).astype(np.int64)
    word = b @ (1 << np.arange(HEADER_LEN - 1, -1, -1, dtype=np.int64))
    word &= (1 << (TRLEN + HDRFECLEN)) - 1
    synd = np.zeros_like(word)
    for i, row in enumerate(synth.HEADER_H_ROWS):
        par = np.zeros_like(word)
        v = word & row
        while v.any():
            par ^= v & 1
            v >>= 1
        synd |= par << (HDRFECLEN - 1 - i)
    corrected = word ^ np.asarray(SYNDTABLE, np.int64)[synd]
    reserved = (corrected >> (TRLEN + HDRFECLEN)) != 0
    tr = (corrected >> HDRFECLEN) & ((1 << TRLEN) - 1)
    datalen = np.zeros_like(tr)
    for i in range(TRLEN):
        datalen |= ((tr >> i) & 1) << (TRLEN - 1 - i)
    too_long = ((synd != 0) & (datalen > MAX_FRAME_LENGTH_CORRECTED)) \
        | (datalen > MAX_FRAME_LENGTH)
    doct = (datalen + 7) // 8
    nb, last = np.divmod(doct, synth.RS_K)
    last_fec = np.select([last < 3, last < 31, last < 68], [0, 2, 4], 6)
    fec = nb * (synth.RS_N - synth.RS_K) + last_fec
    ok = ~reserved & ~too_long & (fec > 0)
    consumed = np.where(ok, HEADER_LEN + 8 * (doct + fec), HEADER_LEN)
    return ok, np.where(reserved, 0, datalen), consumed


def header(bits25: np.ndarray) -> tuple[bool, int, int]:
    """burst.header_info on 25 scrambled header bits: (ok, datalen bits,
    bits_consumed)."""
    b = bits25 ^ synth.PRBS[:HEADER_LEN]
    word = 0
    for x in b.tolist():
        word = (word << 1) | int(x)
    word &= (1 << (TRLEN + HDRFECLEN)) - 1
    s = synth.header_syndrome(word)
    corrected = word ^ SYNDTABLE[s]
    if corrected >> (TRLEN + HDRFECLEN):
        return False, 0, HEADER_LEN
    tr = (corrected >> HDRFECLEN) & ((1 << TRLEN) - 1)
    datalen = int(f"{tr:017b}"[::-1], 2)
    if (s != 0 and datalen > MAX_FRAME_LENGTH_CORRECTED) \
            or datalen > MAX_FRAME_LENGTH:
        return False, datalen, HEADER_LEN
    doct = (datalen + 7) // 8
    _, _, fec = synth.burst_geometry(doct)
    if fec == 0:
        return False, datalen, HEADER_LEN
    return True, datalen, HEADER_LEN + 8 * (doct + fec)


# --------------------------------------------------------- the receiver
def rs_reach(rx_bits: np.ndarray, burst: synth.BurstBits) -> bool:
    """Whether the RS decode and the FCS give back ``burst``'s frame from
    the received on-air bits: every row with parity within the code's
    reach (2 errors + erasures <= 6, the absent parity octets of a
    shortened row being erasures), every row without parity free of
    errors.  A row beyond reach fails the burst (burst.py: fec_bad) or is
    miscorrected, and its frame fails its FCS."""
    err = (rx_bits[:burst.bits.size] != burst.bits)[HEADER_LEN:]
    doct = (burst.datalen + 7) // 8
    nb, last_len, _ = synth.burst_geometry(doct)
    octet_err = np.packbits(err.astype(np.uint8), bitorder="little") != 0
    cells = np.zeros(nb * synth.RS_N, bool)
    data_cols = np.full(nb, synth.RS_K, np.int64)
    data_cols[-1] = last_len
    data_order = synth._fill_order(nb, data_cols, 0)
    cells[data_order] = octet_err[:data_order.size]
    last_fec = synth.fec_octetcount(last_len)
    fec_rows = nb if last_fec > 0 else nb - 1
    if fec_rows > 0:
        fec_cols = np.full(fec_rows, synth.RS_N - synth.RS_K, np.int64)
        if fec_rows == nb:
            fec_cols[-1] = last_fec
        fec_order = synth._fill_order(fec_rows, fec_cols, synth.RS_K)
        cells[fec_order] = octet_err[data_order.size:
                                     data_order.size + fec_order.size]
    errors = cells.reshape(nb, synth.RS_N).sum(1)
    for r in range(nb):
        nfec = synth.RS_N - synth.RS_K if r < nb - 1 else last_fec
        limit = (nfec // 2) if nfec > 0 else 0      # 2e + (6 - nfec) <= 6
        if errors[r] > limit:
            return False
    return True


def receive(phases: torch.Tensor, pwr: torch.Tensor, scene, span_end: int,
            burst_rows: np.ndarray, burst_sync: np.ndarray,
            block_ends: np.ndarray, offset: int = 0) -> dict:
    """Run detection, headers and the busy rule over the span (decimated
    indices 0 .. span_end - 1 of the planes, a stream's decimated
    samples ``offset`` on) and return the detections, their decisions
    and the emitted frames, at stream indices.  Past ``span_end`` no
    symbol is known, as at a stream's end.

    ``burst_rows``/``burst_sync``: the scene's bursts that may be
    received here and the decimated index at which each one's symbol
    clock is expected (see expected_sync).  ``block_ends``: the
    decimated index one past each fed block, ascending; a claim whose
    burst did not fit the block its detection fell in was deferred
    there (``deferred``), which the noise-floor tracker sees."""
    burst_sync = np.asarray(burst_sync) - offset
    block_ends = np.asarray(block_ends) - offset
    err, freq = sync_metric(phases)
    det = detections(err, freq)
    del err, freq
    n = det["det"].size
    hdr_sym = demod(phases, det["channel"], det["sync"], det["dphi"], 9)
    hdr_bits = symbols_to_bits(hdr_sym)[:, :HEADER_LEN]
    hdr = list(zip(*(x.tolist() for x in headers(hdr_bits))))
    verdict = np.zeros(n, np.int8)        # 0 skipped, 1 reject, 2 accept,
    claim_end = np.zeros(n, np.int64)     # 3 eof
    deferred = np.zeros(n, bool)
    det_end = block_ends[np.minimum(np.searchsorted(block_ends, det["det"],
                                                    "right"),
                                    block_ends.size - 1)]
    order = np.lexsort((det["det"], det["channel"]))
    busy, next_det = {}, {}
    for i in order:
        c, d, sp = int(det["channel"][i]), int(det["det"][i]), \
            int(det["sync"][i])
        if d < next_det.get(c, 0) or d < busy.get(c, 0):
            continue
        avail = min(max((span_end - 1 - sp) // SPS, 0), 5616)
        next_det[c] = d + 1
        ok, datalen, consumed = hdr[i]
        if avail < (HEADER_LEN + 2) // 3 + 1:
            verdict[i] = 3
            continue
        in_block = min(max((int(det_end[i]) - 1 - sp) // SPS, 0), 5616)
        deferred[i] = in_block < (HEADER_LEN + 2) // 3 + 1 or (
            ok and in_block < -(-consumed // 3))
        if not ok:
            verdict[i], claim_end[i] = 1, sp + 9 * SPS
            busy[c] = claim_end[i]
            continue
        total = -(-consumed // 3)
        if avail < total:
            verdict[i] = 3
            continue
        verdict[i], claim_end[i] = 2, sp + total * SPS
        busy[c] = claim_end[i]
    frames = []
    cand = []
    for i in np.nonzero(verdict == 2)[0]:
        ok, datalen, consumed = hdr[i]
        sp = int(det["sync"][i])
        near = np.nonzero(np.abs(burst_sync - sp) <= 2 * SPS)[0]
        match = [k for k in near
                 if scene.bursts[burst_rows[k]].datalen == datalen]
        if len(match) == 1:
            cand.append((i, match[0], -(-consumed // 3)))
    if cand:
        rows = np.array([i for i, _, _ in cand])
        longest = max(t for _, _, t in cand)
        sym = demod(phases, det["channel"][rows], det["sync"][rows],
                    det["dphi"][rows], longest)
        idx = torch.as_tensor(det["sync"][rows], device=pwr.device)[:, None] \
            + SPS * (torch.arange(longest, device=pwr.device) + 1)[None, :]
        total = torch.as_tensor([t for _, _, t in cand], device=pwr.device)
        use = (idx < pwr.shape[1]) & (torch.arange(
            longest, device=pwr.device)[None, :] < total[:, None])
        ch_rows = torch.as_tensor(det["channel"][rows], device=pwr.device)
        p = torch.where(use, pwr[ch_rows[:, None],
                                 idx.clamp(max=pwr.shape[1] - 1)], 0.0)
        fpwr = (p.sum(1) / total).cpu().numpy()
    for n_c, (i, k, total) in enumerate(cand):
        j = int(burst_rows[k])
        if not rs_reach(symbols_to_bits(sym[n_c, :total]), scene.bursts[j]):
            continue
        frames.append({"burst": j, "channel": int(det["channel"][i]),
                       "sync": int(det["sync"][i]), "total": int(total),
                       "det": int(det["det"][i]),
                       "frame_pwr": float(fpwr[n_c]),
                       "dphi": float(det["dphi"][i])})
    for key in ("det", "sync"):
        det[key] = det[key] + offset
    for f in frames:
        f["sync"] += offset
        f["det"] += offset
    return {"det": det, "verdict": verdict,
            "claim_end": np.where(verdict > 0, claim_end + offset, 0),
            "deferred": deferred, "hdr": hdr, "frames": frames}


def claims(out: dict, channel: int) -> list:
    """(start, end, det, deferred) of each window ``channel`` claimed."""
    det, v = out["det"], out["verdict"]
    rows = np.nonzero((det["channel"] == channel) & ((v == 1) | (v == 2)))[0]
    return [(int(det["sync"][i]), int(out["claim_end"][i]),
             int(det["det"][i]), bool(out["deferred"][i])) for i in rows]


def expected_sync(scene, delay: int) -> np.ndarray:
    """Decimated index at which each burst's symbol clock origin (its
    last preamble symbol) is expected: the raw start plus 15 symbols and
    the channel filter's delay ``delay`` (raw samples)."""
    os_ = scene.oversample
    return (scene.start + 15 * SPS * os_ + delay) // os_


EMA_TAPS = 400              # 0.9 ** 400 < 1e-18: the EMA's whole memory


def track_noise_floor(pos: torch.Tensor, mags, claimed: list, reads: list,
                      block_starts: np.ndarray) -> list:
    """The noise-floor tracker of one channel over its magnitude columns
    at positions ``pos`` (an int64 tensor: every third fresh sample of
    each fed block, in order; ``mags(positions)`` gives their magnitudes
    as a float64 tensor); returns the floor as of each sync point in
    ``reads``.

    A column is skipped where a claimed window (start, end, det,
    deferred) covers it and the claim was known when the tracker reached
    it: a receiver that works in blocks tracks a block's columns when it
    decides the block, so the columns of the blocks before the one in
    which the claim's detection ``det`` falls (``block_starts``: each
    fed block's first fresh decimated index) were already tracked, and
    a deferred claim holds the tracker at its detection, not its
    start.  The EMA (y = 0.9 y + 0.1 x from 0) is needed only at each
    1000th tracked column, where it is summed over its last EMA_TAPS
    columns."""
    dev = pos.device
    cover = torch.zeros(pos.numel() + 1, dtype=torch.int64, device=dev)
    if claimed:
        s, e, det, deferred = (np.array(x) for x in zip(*claimed))
        first = np.asarray(block_starts)[
            np.searchsorted(block_starts, det, "right") - 1]
        lo = np.maximum(np.where(deferred, det, s), first)
        use = e > lo
        for edge, sign in ((lo[use], 1), (e[use], -1)):
            at = torch.searchsorted(pos, torch.as_tensor(edge, device=dev))
            cover.index_add_(0, at, torch.full_like(at, sign))
    tracked = pos[torch.cumsum(cover[:-1], 0) == 0]
    upd = torch.arange(999, tracked.numel(), 1000, device=dev)
    back = torch.arange(EMA_TAPS, device=dev)
    idx = upd[:, None] - back[None, :]
    ok = idx >= 0
    x = torch.zeros(idx.shape, dtype=torch.float64, device=dev)
    x[ok] = mags(tracked[idx[ok]])
    y = (x * ((1.0 - MAG_LP) * MAG_LP ** back.to(torch.float64))[None, :]) \
        .sum(1).cpu().numpy()
    nf = 2.0
    floors = np.empty(y.size)
    for u in range(y.size):
        nf = NF_LP * nf + (1.0 - NF_LP) * min(y[u], nf) + 0.0001
        floors[u] = nf
    before = (torch.searchsorted(tracked, torch.as_tensor(
        np.asarray(reads, np.int64), device=dev)) // 1000).cpu().numpy()
    return [2.0 if m == 0 else float(floors[m - 1]) for m in before]
