"""Streaming receive pipeline: raw IQ blocks in, decoded frames out.

Port of ``dumpvdl2_tpu/core/pipeline.py`` in its device-L2, host-gated
mode (the JAX package's ``DUMPVDL2_TPU_L2=1 DUMPVDL2_TPU_GATE=0``):

* each ``feed()`` channelizes one wideband block for all channels,
  detects preamble candidates (kernel K1 on CUDA), compacts the
  candidate slots, slices their symbol windows and runs the batched L2
  decode, all on the device (``process_block_detect`` + ``l2_sliced``),
* a decimated-sample halo is carried between blocks so bursts that
  straddle a block boundary are re-detected and decoded once fully
  contained,
* the results come back in ONE device->host copy per block, in a
  background thread, and the host runs the candidate loop, the noise
  floor tracker and HDLC unstuff/CRC two blocks behind the device.
"""
from __future__ import annotations

import math
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import scipy.signal
import torch

from ..burst import BurstResult, _result_from_batch
from ..constants import (HEADER_LEN, MAG_LP, NF_LP, SPS, SYMBOL_RATE,
                         SYNC_THRESHOLD)
from ..dsp.chebyshev import fir_taps
from ..dsp.demod import demod_window, find_and_slice, slice_windows
from ..dsp.frontend import nco_dphi, prepare_taps, to_planar
from ..fec.l2 import l2_decode_batch
from ..utils.debug import (D_BURST, D_BURST_DETAIL, D_DEMOD, debug_print,
                           debug_print_buf_hex)
from ..utils.devices import resolve_device
from ..utils.fetch import coalesced_get
from .device import process_block_detect
from .metadata import DecodedFrame, MsgMetadata

# Longest possible burst in decimated samples (header + max payload):
# 16825 bits -> 5609 symbols.
MAX_BURST_SYMS = 5616
DEFAULT_HALO = MAX_BURST_SYMS * SPS + 256

# Burst-header failure reasons (decided by header FEC alone).
_HEADER_REASONS = frozenset({"hdr_reserved_bits", "too_long", "no_fec"})


def _error_counter(reason: str) -> str:
    """Map a BurstResult failure reason to the reference's counter name
    (decode.c:215-217, statsd.c:48-58)."""
    if reason == "hdr_reserved_bits":
        return "decoder.crc.bad"
    return "decoder.errors." + reason


def _compact_rows(keep: torch.Tensor, cap: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable compaction: the first ``cap`` indices with ``keep`` set
    (then the others, in index order), and the inverse map index ->
    compacted row (-1 = not taken)."""
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    take = order[:cap]
    inv = torch.full(keep.shape, -1, dtype=torch.int32, device=keep.device)
    inv[take] = torch.arange(cap, dtype=torch.int32, device=keep.device)
    return take, inv


def _compact_blocks(l2: dict, cap: int) -> dict:
    """Second-stage compaction of the (cap, MAX_BLOCKS, 255) corrected
    codewords to the hdr-ok rows; ``blocks_row`` maps row -> compacted
    row (-1 = overflow, reported as decoder.errors.l2_overflow)."""
    cap2 = min(cap, max(128, cap // 4))
    if cap2 >= cap:
        return l2
    take, inv = _compact_rows(l2["hdr_ok"], cap2)
    l2 = dict(l2)
    l2["blocks"] = l2["blocks"][take]
    l2["blocks_row"] = inv
    return l2


def _slot_compaction(count: torch.Tensor, K: int):
    """``(take, inv)`` for the slots ``k < count[c]`` of a (C, K) slot
    grid, capped at max(256, 4C) rows; ``inv`` is None when every slot
    fits."""
    C = count.shape[0]
    total = C * K
    cap = min(total, max(256, 4 * C))
    if cap >= total:
        return torch.arange(total, device=count.device), None
    k_idx = torch.arange(K, dtype=torch.int32, device=count.device)
    valid = (k_idx[None, :] < count[:, None]).reshape(total)
    return _compact_rows(valid, cap)


def launch_compacted_l2(symbols: torch.Tensor, power: torch.Tensor,
                        count: torch.Tensor, K: int):
    """Compact (C, K, S) candidate slots and run the batched L2 decode
    (the EOF path, on fully sliced candidates).  Returns ``(l2, inv)``
    with ``inv`` mapping flat slot -> L2 row (-1 = overflowed the cap,
    counted by the host as demod.sync.overflow), or None when no
    compaction was needed."""
    total = count.shape[0] * K
    syms = symbols.reshape(total, MAX_BURST_SYMS)
    pwr = power.reshape(total, MAX_BURST_SYMS)
    take, inv = _slot_compaction(count, K)
    if inv is None:
        return l2_decode_batch(syms, MAX_BURST_SYMS, pwr), None
    l2 = l2_decode_batch(syms[take], MAX_BURST_SYMS, pwr[take])
    return _compact_blocks(l2, take.shape[0]), inv


def l2_sliced(phases: torch.Tensor, pwr: torch.Tensor, count: torch.Tensor,
              sync_idx: torch.Tensor, dphi: torch.Tensor, K: int, S: int):
    """Compact candidate slots, slice their symbol windows from the
    block's phase/power planes and run the batched L2 decode.

    Same compaction order, cap and ``inv`` semantics as
    launch_compacted_l2, but windows exist only for the compacted rows,
    gathered at the symbol rate (indices sp + SPS*s, zero past the
    block end) -- element-identical to find_and_slice's windows.
    """
    C = count.shape[0]
    take, inv = _slot_compaction(count, K)
    c_row = torch.div(take, K, rounding_mode="floor")
    sp_row = sync_idx.reshape(C * K)[take]
    dphi_row = dphi.reshape(C * K)[take]
    sym_phase = slice_windows(phases, c_row, sp_row, S + 1)
    power_all = slice_windows(pwr, c_row, sp_row, S + 1)
    symbols, power = demod_window(sym_phase, power_all, dphi_row)
    cap = take.shape[0]
    l2 = l2_decode_batch(symbols, S, power,
                         rs_burst_cap=min(cap, max(128, cap // 4)))
    return l2, inv


def mag16(pwr3: torch.Tensor) -> torch.Tensor:
    """Noise-tracker magnitudes as float16: sqrt in float32 on the
    device, then the cast (half the bytes of the power array)."""
    return torch.sqrt(pwr3).to(torch.float16)


@dataclass
class ChannelState:
    freq: int
    busy_until: int = 0         # global decimated index; no sync search before
    next_det_min: int = 0       # first unprocessed detection index
    mag_lp: float = 0.0
    mag_nf: float = 2.0
    nfcnt: int = 0
    deferred_at: int | None = None   # deferred burst position this block
    # Noise-tracker hold: while a deferred burst awaits decision, later
    # magnitude columns are saved here and replayed once it resolves.
    nf_hold: int | None = None
    nf_saved: list = field(default_factory=list)
    stats: dict = field(default_factory=dict)

    def bump(self, counter: str, n: int = 1) -> None:
        """Count with the reference's per-channel metric names
        (statsd.c:34-63)."""
        self.stats[counter] = self.stats.get(counter, 0) + n


class VDL2Pipeline:
    """Device-L2, host-gated receiver for ``freqs`` inside one wideband
    stream at ``sample_rate`` (an ``oversample`` multiple of 105 kHz).

    Runs on ``device`` ("cuda" by default); raises when no GPU is
    present unless the caller asks for the CPU.  ``step_ms``, when set
    to a dict, makes each block synchronize after its detect and L2
    steps and accumulate their wall milliseconds (plus the host's
    fetch-and-decode time) there: a breakdown for measurement, at the
    cost of the overlap.
    """

    def __init__(self, freqs: list[int], centerfreq: int, sample_rate: int,
                 oversample: int, max_ppm: float = 0.0,
                 station_id: str | None = None,
                 max_candidates: int = 64,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.freqs = list(freqs)
        self.centerfreq = int(centerfreq)
        self.sample_rate = int(sample_rate)
        self.oversample = int(oversample)
        self.max_ppm = float(max_ppm)
        self.station_id = station_id
        self.max_candidates = int(max_candidates)

        taps = prepare_taps(fir_taps(sample_rate), oversample)
        dphi = np.array([nco_dphi(centerfreq, f, sample_rate)
                         for f in freqs], dtype=np.uint32)
        C, T = len(freqs), taps.size
        self.taps = torch.as_tensor(taps, device=self.device)
        self.dphi = torch.as_tensor(dphi.astype(np.int64), device=self.device)
        self.carry = torch.zeros((2, T - 1), dtype=torch.float32,
                                 device=self.device)
        self.n0 = 0                                   # raw-sample NCO index
        self.hist = torch.zeros((2, C, 0), dtype=torch.float32,
                                device=self.device)
        self.hist_base = 0        # global decimated index of hist[:, 0]
        self.channels = [ChannelState(freq=f) for f in freqs]
        self._residual = np.zeros(0, dtype=np.complex64)
        # Two-deep host pipeline: block N's device work is launched
        # before older blocks' results are consumed; transfers run in a
        # background thread.
        self._pending_q = deque()
        self._fetch_pool = None
        self._last_proc_base = None
        self._nf_mags = None
        self.last_deferred_min: int | None = None
        self.step_ms: dict | None = None

    # ----------------------------------------------------------- noise floor
    # The reference updates its magnitude EMA + noise floor only in
    # DM_INIT (every 3rd sample) and PAUSES while receiving a burst
    # (demod.c:229-250).  Block form: each drained block stashes its
    # every-3rd-sample magnitudes; _process_candidates advances the
    # tracker up to each burst's sync point before emitting (so header
    # fields see the pre-burst floor), skipping busy windows.

    def _stash_noise_block(self, mags: np.ndarray, base: int) -> None:
        """``mags`` columns are magnitudes of fresh decimated samples
        base, base+3, base+6, ... (global indices)."""
        self._nf_mags = np.asarray(mags, np.float64)
        self._nf_base = base
        self._nf_col = np.zeros(len(self.channels), np.int64)

    def _advance_noise_floor(self, c: int, upto: int) -> None:
        """Track magnitudes for channel ``c`` up to global dec index
        ``upto``, skipping samples inside busy (burst) windows."""
        mags = self._nf_mags
        if mags is None:
            return
        ch = self.channels[c]
        ncols = mags.shape[1]
        while self._nf_col[c] < ncols:
            j = int(self._nf_col[c])
            idx = self._nf_base + 3 * j
            if idx >= upto:
                break
            # skip the busy window in one step
            if idx < ch.busy_until:
                skip_to = min(ch.busy_until, upto)
                self._nf_col[c] = min(
                    ncols, (skip_to - self._nf_base + 2) // 3)
                continue
            # a deferred burst is still undecided: save, don't track
            if ch.nf_hold is not None and idx >= ch.nf_hold:
                run_end = min(ncols, (upto - self._nf_base + 2) // 3)
                jj = np.arange(j, run_end)
                ch.nf_saved.append((self._nf_base + 3 * jj,
                                    mags[c, j:run_end].copy()))
                self._nf_col[c] = run_end
                continue
            # contiguous trackable run: up to busy/hold/upto boundary
            end_idx = upto
            if ch.nf_hold is not None:
                end_idx = min(end_idx, ch.nf_hold)
            run_end = min(ncols, (end_idx - self._nf_base + 2) // 3)
            seg = mags[c, j:run_end]
            self._nf_col[c] = run_end
            self._track_channel(ch, seg)

    def _release_nf_hold(self, ch: ChannelState) -> None:
        """A deferred burst was decided: replay held magnitude columns
        through the tracker, skipping the (now known) busy window."""
        saved, ch.nf_saved, ch.nf_hold = ch.nf_saved, [], None
        for idxs, mags in saved:
            self._track_channel(ch, mags[idxs >= ch.busy_until])

    def _track_channel(self, ch: ChannelState, seg: np.ndarray) -> None:
        """EMA + per-1000 noise-floor update (demod.c:238-243)."""
        if seg.size == 0:
            return
        alpha = 1.0 - MAG_LP
        y, _zi = scipy.signal.lfilter(
            [alpha], [1.0, -MAG_LP], seg,
            zi=np.array([MAG_LP * ch.mag_lp]))
        ch.mag_lp = float(y[-1])
        n = seg.size
        first = 1000 - ch.nfcnt
        k = ch.nfcnt + n
        while first <= n:
            v = float(y[first - 1])
            ch.mag_nf = NF_LP * ch.mag_nf + \
                (1.0 - NF_LP) * min(v, ch.mag_nf) + 0.0001
            first += 1000
        ch.nfcnt = k % 1000

    def _finish_noise_block(self) -> None:
        """Advance every channel to the block end, but not past a
        deferred burst's sync point."""
        mags = self._nf_mags
        if mags is None:
            return
        end = self._nf_base + 3 * mags.shape[1]
        for c, ch in enumerate(self.channels):
            upto = end if ch.deferred_at is None \
                else min(end, ch.deferred_at)
            self._advance_noise_floor(c, upto)
            if ch.deferred_at is not None:
                # burst pending across blocks: pause the tracker here
                ch.nf_hold = ch.deferred_at if ch.nf_hold is None \
                    else min(ch.nf_hold, ch.deferred_at)
            elif (ch.nf_hold is not None
                  and self._last_proc_base is not None
                  and self._last_proc_base <= ch.nf_hold):
                # the held candidate neither resolved nor re-deferred:
                # it vanished -- release the held columns
                self._release_nf_hold(ch)
            ch.deferred_at = None
        self._nf_mags = None

    # ------------------------------------------------------------- candidates
    @staticmethod
    def _candidate_fields(cands):
        """Small candidate tensors the host needs (symbols and power
        stay on the device: the L2 decode consumed them there)."""
        return (cands.count, cands.det_idx, cands.sync_idx,
                cands.dphi, cands.pherr, cands.sym_valid)

    def _process_candidates(self, base: int, eof: bool, fetched,
                            l2_np: dict, l2_map) -> list[DecodedFrame]:
        out: list[DecodedFrame] = []
        self.last_deferred_min = None

        def l2_index(c: int, k: int) -> int:
            return int(l2_map[c, k]) if l2_map is not None \
                else c * self.max_candidates + k

        self._last_proc_base = base

        def defer(det_g: int, ch: ChannelState) -> None:
            if self.last_deferred_min is None \
                    or det_g < self.last_deferred_min:
                self.last_deferred_min = det_g
            if ch.deferred_at is None or det_g < ch.deferred_at:
                ch.deferred_at = det_g

        def decided(ch: ChannelState, det_g: int) -> None:
            # A candidate at/after a tracker hold point was decided:
            # replay held magnitude columns (busy window now known).
            if ch.nf_hold is not None and det_g >= ch.nf_hold:
                self._release_nf_hold(ch)

        count, det_idx, sync_idx, dphi, pherr, sym_valid = fetched
        for c, ch in enumerate(self.channels):
            for k in range(int(count[c])):
                if k >= det_idx.shape[1]:
                    ch.bump("demod.sync.overflow")
                    break
                det_g = base + int(det_idx[c, k])
                sp_g = base + int(sync_idx[c, k])
                if det_g < ch.next_det_min or det_g < ch.busy_until:
                    continue
                if l2_map is not None and int(l2_map[c, k]) < 0:
                    # candidate overflowed the compacted L2 batch cap
                    ch.bump("demod.sync.overflow")
                    ch.next_det_min = det_g + 1
                    decided(ch, det_g)
                    continue
                nsyms_avail = int(sym_valid[c, k])
                if nsyms_avail < (HEADER_LEN + 2) // 3 + 1:
                    if eof:
                        ch.next_det_min = det_g + 1
                        decided(ch, det_g)
                        continue
                    ch.next_det_min = det_g   # retry next block
                    defer(det_g, ch)
                    break
                ch.bump("demod.sync.good")
                debug_print(D_DEMOD,
                            "ch %d (%d Hz): sync at %d err=%.3f dphi=%.5f",
                            c, ch.freq, sp_g, float(pherr[c, k]),
                            float(dphi[c, k]))
                res = _result_from_batch(l2_np, l2_index(c, k))
                hdr_ok = res.ok or res.reason not in _HEADER_REASONS
                if not hdr_ok:
                    debug_print(D_BURST, "ch %d: header rejected (%s)",
                                c, res.reason)
                    ch.bump(_error_counter(res.reason))
                    self._advance_noise_floor(c, sp_g)
                    ch.busy_until = sp_g + 9 * SPS
                    ch.next_det_min = det_g + 1
                    decided(ch, det_g)
                    continue
                total_syms = -(-res.bits_consumed // 3)
                if nsyms_avail < total_syms:
                    if not eof:
                        ch.next_det_min = det_g
                        defer(det_g, ch)
                        break
                    ch.next_det_min = det_g + 1   # truncated at EOF: lost
                    ch.bump("decoder.errors.eof_truncated")
                    decided(ch, det_g)
                    continue
                ppm = SYMBOL_RATE * float(dphi[c, k]) \
                    / (2.0 * math.pi * ch.freq) * 1e6
                if self.max_ppm and abs(ppm) > self.max_ppm:
                    ch.next_det_min = det_g + 1
                    decided(ch, det_g)
                    continue
                self._advance_noise_floor(c, sp_g)
                ch.busy_until = sp_g + total_syms * SPS
                ch.next_det_min = det_g + 1
                decided(ch, det_g)
                debug_print(D_BURST,
                            "ch %d: burst ok=%s reason=%s datalen=%d "
                            "blocks=%d fec_corr=%d frames=%d",
                            c, res.ok, res.reason or "-", res.datalen,
                            res.blocks_processed, res.num_fec_corrections,
                            len(res.frames))
                for fr in res.frames:
                    debug_print_buf_hex(D_BURST_DETAIL, fr,
                                        "unstuffed frame:")
                frame_pwr = float(l2_np["frame_pwr"][l2_index(c, k)])
                self._count_burst(ch, res, frame_pwr)
                for i, frame in enumerate(res.frames):
                    md = MsgMetadata(
                        station_id=self.station_id, freq=ch.freq,
                        frame_pwr_dbfs=10.0 * math.log10(max(frame_pwr, 1e-30)),
                        nf_pwr_dbfs=20.0 * math.log10(ch.mag_nf + 0.001),
                        ppm_error=ppm,
                        burst_timestamp=time.time(),
                        datalen_octets=res.datalen_octets,
                        synd_weight=res.synd_weight,
                        num_fec_corrections=res.num_fec_corrections,
                        idx=i)
                    out.append(DecodedFrame(metadata=md, frame=frame))
        return out

    def _count_burst(self, ch: ChannelState, res: BurstResult,
                     frame_pwr: float = 0.0) -> None:
        """Reference decode-funnel counters (decode.c:210-380)."""
        if res.synd_weight == 0:
            ch.bump("decoder.crc.good")
        if res.blocks_processed:
            ch.bump("decoder.blocks.processed", res.blocks_processed)
        if res.blocks_fec_ok:
            ch.bump("decoder.blocks.fec_ok", res.blocks_fec_ok)
        if res.ok:
            ch.bump("decoder.msg.good", max(len(res.frames), 1))
            if frame_pwr > 1.0:          # > 0 dBFS (decode.c:372)
                ch.bump("decoder.msg.good_loud")
        elif res.reason:
            ch.bump(_error_counter(res.reason))

    # ------------------------------------------------------------------ feed
    def _sync_time(self, key: str, t0: float) -> float:
        """With step_ms set: wait for the device, add the step's wall
        milliseconds since ``t0`` under ``key``; returns the new t0."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.step_ms[key] = self.step_ms.get(key, 0.0) + (t1 - t0) * 1e3
        return t1

    def feed(self, iq: np.ndarray, eof: bool = False) -> list[DecodedFrame]:
        """Process one wideband complex64 block; returns decoded frames.

        ``iq`` is the dequantized complex baseband at the ingest rate.
        Length need not be aligned; a residual is carried internally.
        """
        iq = np.ascontiguousarray(iq, dtype=np.complex64)
        if self._residual.size:
            iq = np.concatenate([self._residual, iq])
        usable = (iq.size // self.oversample) * self.oversample
        self._residual = iq[usable:]
        planar = torch.as_tensor(to_planar(iq[:usable]), device=self.device)
        return self.feed_planar(planar, eof=eof)

    def feed_planar(self, iq, eof: bool = False) -> list[DecodedFrame]:
        """feed() for planar (2, N) float32 blocks, N a multiple of the
        oversample factor.  ``iq`` may be a tensor already on the
        pipeline's device (no host->device copy) or a numpy array."""
        iq = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
        if iq.shape[1] % self.oversample:
            raise ValueError(f"block length {iq.shape[1]} is not a multiple "
                             f"of the oversample factor {self.oversample}")
        if iq.shape[1] == 0:
            return self.finish() if eof else []

        t0 = time.perf_counter() if self.step_ms is not None else 0.0
        H = self.hist.shape[2]
        dets, phases, pwr, new_hist, new_carry, pwr3 = process_block_detect(
            iq, self.taps, self.dphi, self.n0 & 0xFFFFFF, self.carry,
            self.hist, self.oversample, DEFAULT_HALO, SYNC_THRESHOLD,
            self.max_candidates, MAX_BURST_SYMS)
        if self.step_ms is not None:
            t0 = self._sync_time("detect", t0)
        l2, l2_map = l2_sliced(phases, pwr, dets.count, dets.sync_idx,
                               dets.dphi, self.max_candidates, MAX_BURST_SYMS)
        if l2_map is not None:
            l2_map = l2_map.reshape(len(self.channels), self.max_candidates)
        del phases, pwr
        if self.step_ms is not None:
            t0 = self._sync_time("l2", t0)
        self.carry = new_carry
        self.n0 = (self.n0 + iq.shape[1]) & 0xFFFFFF

        base = self.hist_base
        M_total = H + iq.shape[1] // self.oversample
        keep = min(DEFAULT_HALO, M_total)
        self.hist = new_hist
        self.hist_base = base + M_total - keep

        # The queue holds no device tensors: the fetch future owns the
        # only references, so each block's buffers are freed as soon as
        # its transfer completes.  The fetch thread issues its copies
        # on the same (default) stream, after this block's work.
        fut = self._submit_fetch(
            (mag16(pwr3), self._candidate_fields(dets), l2, l2_map))
        self._pending_q.append((fut, base, base + H))
        frames = []
        while len(self._pending_q) > 2 \
                or (self._pending_q and self._pending_q[0][0].done()):
            frames.extend(self._drain_oldest())
        if self.step_ms is not None:
            frames.extend(self._drain_pending())
            self._sync_time("fetch_host", t0)
        if eof:
            frames.extend(self.finish())
        return frames

    def _submit_fetch(self, tree):
        if self._fetch_pool is None:
            self._fetch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="vdl2-fetch")
        return self._fetch_pool.submit(coalesced_get, tree)

    def _drain_oldest(self) -> list[DecodedFrame]:
        """Host-process the oldest in-flight block, if any."""
        if not self._pending_q:
            return []
        fut, base, nf_base = self._pending_q.popleft()
        mags_np, fetched, l2_np, l2_map_np = fut.result()
        self._stash_noise_block(mags_np, nf_base)
        frames = self._process_candidates(base, False, fetched, l2_np,
                                          l2_map_np)
        self._finish_noise_block()
        return frames

    def _drain_pending(self) -> list[DecodedFrame]:
        """Drain every in-flight block in order."""
        frames = []
        while self._pending_q:
            frames.extend(self._drain_oldest())
        return frames

    def finish(self) -> list[DecodedFrame]:
        """Flush: resolve deferred candidates with the data we have."""
        frames = self._drain_pending()
        if self._fetch_pool is not None:
            # EOF: release the background fetch thread (recreated
            # lazily if the pipeline is fed again)
            self._fetch_pool.shutdown(wait=False)
            self._fetch_pool = None
        if self.hist.shape[2] == 0:
            return frames
        cands = find_and_slice(self.hist, SYNC_THRESHOLD,
                               self.max_candidates, MAX_BURST_SYMS)
        l2, l2_map = launch_compacted_l2(cands.symbols, cands.power,
                                         cands.count, self.max_candidates)
        if l2_map is not None:
            l2_map = l2_map.reshape(len(self.channels), self.max_candidates)
        fetched, l2_np, l2_map_np = coalesced_get(
            (self._candidate_fields(cands), l2, l2_map))
        frames.extend(self._process_candidates(
            self.hist_base, True, fetched, l2_np, l2_map_np))
        return frames


def load_state(pipe: VDL2Pipeline, state: dict) -> None:
    """Carry a receiver's stream state into ``pipe``.

    ``state`` holds numpy arrays and ints: ``taps``, ``dphi`` (uint32
    NCO increments), ``carry`` (2, T-1), ``n0``, ``hist`` (2, C, H),
    ``hist_base``, optionally ``residual`` (complex64 samples not yet
    fed), and ``channels``: one dict per channel with ``busy_until``,
    ``next_det_min``, ``mag_lp``, ``mag_nf``, ``nfcnt``, ``nf_hold``
    (int or None) and ``nf_saved`` (list of (indices, magnitudes)).
    The pipeline must have no block in flight.
    """
    if pipe._pending_q:
        raise RuntimeError("load_state needs a drained pipeline")
    if len(state["channels"]) != len(pipe.channels):
        raise ValueError("state has a different channel count")

    def tensor(x, dtype):
        return torch.as_tensor(np.array(x, dtype), device=pipe.device)

    pipe.taps = tensor(state["taps"], np.float32)
    pipe.dphi = tensor(np.asarray(state["dphi"], np.uint32), np.int64)
    pipe.carry = tensor(state["carry"], np.float32)
    pipe.n0 = int(state["n0"])
    pipe.hist = tensor(state["hist"], np.float32)
    pipe.hist_base = int(state["hist_base"])
    pipe._residual = np.asarray(state.get("residual", np.zeros(0)),
                                np.complex64)
    for ch, st in zip(pipe.channels, state["channels"]):
        ch.busy_until = int(st["busy_until"])
        ch.next_det_min = int(st["next_det_min"])
        ch.mag_lp = float(st["mag_lp"])
        ch.mag_nf = float(st["mag_nf"])
        ch.nfcnt = int(st["nfcnt"])
        ch.nf_hold = None if st["nf_hold"] is None else int(st["nf_hold"])
        ch.nf_saved = [(np.asarray(i), np.asarray(m, np.float64))
                       for i, m in st["nf_saved"]]
        ch.deferred_at = None
