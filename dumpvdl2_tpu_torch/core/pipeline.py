"""Streaming receive pipeline: raw IQ blocks in, decoded frames out.

Port of ``dumpvdl2_tpu/core/pipeline.py``.  Device L2 (the JAX
package's ``DUMPVDL2_TPU_L2=1``, the default here) runs in both of its
gating modes:

* each ``feed()`` channelizes one wideband block for all channels,
  detects preamble candidates (kernel K1 on CUDA), compacts the
  candidate slots, slices their symbol windows and runs the batched L2
  decode, all on the device (``process_block_detect`` + ``l2_sliced``),
* device gating (the default, as in the JAX package): the gate step
  (core/nf_gate.py, kernels G1 and G2 on CUDA) decides every candidate
  and tracks the noise floor on the device; the host only builds the
  frames of the accepted bursts (``_process_verdicts``).  With
  ``device_gate=False`` (``DUMPVDL2_TPU_GATE=0``) the block's
  every-3rd-sample magnitudes come to the host instead, and the host
  runs the candidate loop and the noise-floor tracker
  (``_process_candidates``),
* host L2 (``device_l2=False``, ``DUMPVDL2_TPU_L2=0``): the device
  slices every candidate's symbol window (``process_block``), the
  symbols and powers come to the host, and the host decodes each burst
  (``burst.header_info`` / ``burst.decode_burst``) and gates it;
* a decimated-sample halo is carried between blocks so bursts that
  straddle a block boundary are re-detected and decoded once fully
  contained,
* the results come back in ONE device->host copy per block, in a
  background thread, and the host works two blocks behind the device,
* on CUDA, device L2 and gate, each steady block (full halo) replays
  the three steps as CUDA graphs captured on the first block of its
  shape (core/graphs.py, :func:`graph_key`): three graph launches and
  a few copies in place of ~115 launches.
"""
from __future__ import annotations

import math
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import scipy.signal
import torch

from ..app.stats import stats as _stats
from ..burst import BurstResult, _result_from_batch, decode_burst, header_info
from ..constants import (HEADER_LEN, MAG_LP, NF_LP, SPS, SYMBOL_RATE,
                         SYNC_THRESHOLD)
from ..dsp.chebyshev import fir_taps
from ..dsp.demod import demod_window, find_and_slice, slice_windows
from ..dsp.frontend import nco_dphi, prepare_taps, to_planar
from ..fec import l2_kernel
from ..fec.l2 import decode_payload, frame_power, l2_decode_batch
from ..fec.scramble import descramble
from ..utils.bits import symbols_to_bits_msb
from ..utils.debug import (D_BURST, D_BURST_DETAIL, D_DEMOD, debug_print,
                           debug_print_buf_hex)
from ..utils.devices import resolve_device
from ..utils import fetch
from ..utils.fetch import coalesced_get
from . import device as _device
from . import nf_gate
from .device import detect_planes, process_block, process_block_detect
from .graphs import Snapshot, StepGraph
from .gate_scan import (V_DEFER_DATA, V_EMPTY, V_EOF_TRUNC, V_HDR_REJECT,
                        V_L2_OVERFLOW, V_PPM_REJECT, V_SKIP, V_UNPROCESSED)
from .metadata import DecodedFrame, MsgMetadata
from .spans import SpanLog

# Longest possible burst in decimated samples (header + max payload):
# 16825 bits -> 5609 symbols.
MAX_BURST_SYMS = 5616
DEFAULT_HALO = MAX_BURST_SYMS * SPS + 256
# Steady block shapes whose steps a pipeline keeps as CUDA graphs at
# most: each key holds a memory pool as large as an eager block's peak
# (~3.5 GB for 256 channels at oversample 80).
GRAPH_KEYS = 4

# Burst-header failure reasons (decided by header FEC alone).
_HEADER_REASONS = frozenset({"hdr_reserved_bits", "too_long", "no_fec"})


def _error_counter(reason: str) -> str:
    """Map a BurstResult failure reason to the reference's counter name
    (decode.c:215-217, statsd.c:48-58)."""
    if reason == "hdr_reserved_bits":
        return "decoder.crc.bad"
    return "decoder.errors." + reason


def _rs_cap(cap: int) -> int:
    """Rows of L2P behind the hdr-ok compaction for a batch of ``cap``
    rows."""
    return min(cap, max(128, cap // 4))


def _slot_compaction(count: torch.Tensor, K: int):
    """``(take, inv)`` for the slots ``k < count[c]`` of a (C, K) slot
    grid, capped at l2_kernel.slot_cap rows; ``inv`` is None when every
    slot fits."""
    C = count.shape[0]
    total = C * K
    cap = l2_kernel.slot_cap(C, K)
    if cap >= total:
        return torch.arange(total, device=count.device), None
    k_idx = torch.arange(K, dtype=torch.int32, device=count.device)
    valid = (k_idx[None, :] < count[:, None]).reshape(total)
    return l2_kernel.compact_rows(valid, cap)


def launch_compacted_l2(symbols: torch.Tensor, power: torch.Tensor,
                        count: torch.Tensor, K: int):
    """Compact (C, K, S) candidate slots and run the batched L2 decode
    (the mesh, on fully sliced candidates), its payload stage behind the
    hdr-ok compaction at _rs_cap rows.  Returns ``(l2, inv)`` with
    ``inv`` mapping flat slot -> L2 row (-1 = overflowed the cap,
    counted by the host as demod.sync.overflow), or None when no
    compaction was needed."""
    total = count.shape[0] * K
    syms = symbols.reshape(total, MAX_BURST_SYMS)
    pwr = power.reshape(total, MAX_BURST_SYMS)
    take, inv = _slot_compaction(count, K)
    if inv is None:
        return l2_decode_batch(syms, MAX_BURST_SYMS, pwr), None
    return l2_decode_batch(syms[take], MAX_BURST_SYMS, pwr[take],
                           rs_burst_cap=_rs_cap(take.shape[0])), inv


def l2_front_plain(phases: torch.Tensor, pwr: torch.Tensor,
                   count: torch.Tensor, sync_idx: torch.Tensor,
                   dphi: torch.Tensor, K: int, S: int) -> dict:
    """Plain front of the sliced L2 step: compact the candidate slots,
    slice their symbol windows from the block's phase and power planes
    and demodulate them, then L2H's header and the frame power.

    ``phases``/``pwr`` (C, M) float32, ``count`` (C,) int32,
    ``sync_idx`` (C, K) int32 and ``dphi`` (C, K) float32 (the block's
    detections).  Returns a dict: ``take`` (cap,) int64 the slot of each
    row (_slot_compaction), ``inv`` (C K,) int32 slot -> row (-1 =
    overflowed the cap) or None, ``symbols`` (cap, S) uint8, L2H's
    fields (l2_kernel.l2_header_plain) and ``frame_pwr`` (cap,) float32.
    Windows are read at ``sp + SPS*s``, zero past the block end,
    element-identical to find_and_slice's.
    """
    C = count.shape[0]
    take, inv = _slot_compaction(count, K)
    c_row = torch.div(take, K, rounding_mode="floor")
    sp_row = sync_idx.reshape(C * K)[take]
    dphi_row = dphi.reshape(C * K)[take]
    sym_phase = slice_windows(phases, c_row, sp_row, S + 1)
    power_all = slice_windows(pwr, c_row, sp_row, S + 1)
    symbols, power = demod_window(sym_phase, power_all, dphi_row)
    hdr = l2_kernel.l2_header_plain(symbols)
    return {"take": take, "inv": inv, "symbols": symbols, **hdr,
            "frame_pwr": frame_power(power, hdr["hdr_ok"],
                                     hdr["bits_consumed"])}


def l2_front(phases: torch.Tensor, pwr: torch.Tensor, count: torch.Tensor,
             sync_idx: torch.Tensor, dphi: torch.Tensor, K: int, S: int
             ) -> dict:
    """The sliced L2 step's front on the tensors' device: kernel L2H's
    front (l2_kernel.l2_front_cuda) on CUDA, l2_front_plain on CPU."""
    if phases.device.type == "cuda":
        return l2_kernel.l2_front_cuda(phases, pwr, count, sync_idx, dphi,
                                       K, S)
    if phases.device.type != "cpu":
        raise ValueError(f"unsupported device {phases.device}")
    return l2_front_plain(phases, pwr, count, sync_idx, dphi, K, S)


def l2_sliced(phases: torch.Tensor, pwr: torch.Tensor, count: torch.Tensor,
              sync_idx: torch.Tensor, dphi: torch.Tensor, K: int, S: int,
              flush: bool = False, graph: StepGraph | None = None):
    """Compact candidate slots, slice their symbol windows from the
    block's phase/power planes and run the batched L2 decode: on CUDA
    two kernels, the front (l2_front) and L2P behind the hdr-ok
    compaction at _rs_cap rows.

    Same compaction order, cap and ``inv`` semantics as
    launch_compacted_l2, but windows exist only for the compacted rows,
    gathered at the symbol rate (indices sp + SPS*s, zero past the
    block end) -- element-identical to find_and_slice's windows.  With
    ``flush`` (the EOF batch) every row is decoded when every slot fits,
    so the result equals launch_compacted_l2's on the fully sliced
    candidates.  Returns ``(l2, inv)``: the batch's result dict (with
    ``frame_pwr``) and the map slot -> row, or None when every slot
    fits.  ``graph``, where given, is this step captured on these very
    tensors (core/graphs.py): the call replays it and returns copies of
    its results.
    """
    if graph is not None:
        return graph.replay()
    return _l2_sliced(phases, pwr, count, sync_idx, dphi, K, S, flush)


def _l2_sliced(phases, pwr, count, sync_idx, dphi, K: int, S: int,
               flush: bool):
    """:func:`l2_sliced`'s eager step, which a graph captures."""
    front = l2_front(phases, pwr, count, sync_idx, dphi, K, S)
    take, inv = front.pop("take"), front.pop("inv")
    symbols, frame_pwr = front.pop("symbols"), front.pop("frame_pwr")
    rs_cap = None if flush and inv is None else _rs_cap(take.shape[0])
    return decode_payload(symbols, front, frame_pwr, rs_cap), inv


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
        """Count locally AND export to the global sink with the
        reference's per-channel metric names (statsd.c:34-63), so
        --statsd emits the demod/decoder funnel."""
        self.stats[counter] = self.stats.get(counter, 0) + n
        _stats.increment_per_channel(self.freq, counter, n)


def graph_key(device: torch.device, device_l2: bool, device_gate: bool,
              H: int, N: int, C: int, T: int, K: int, S: int):
    """The key under which a block's three device steps replay as CUDA
    graphs, or None where they run eagerly: on another device than
    CUDA, in host-L2 or host-gated mode, while the halo ``H`` grows, and
    for a block with no fresh samples (the EOF flush).  A block of
    ``N`` samples on ``C`` channels, ``T`` taps, ``K`` slots and ``S``
    symbols has the key (N, C, T, H, K, S)."""
    if device.type != "cuda" or not (device_l2 and device_gate) \
            or H != DEFAULT_HALO or N <= 0:
        return None
    return (N, C, T, H, K, S)


class _BlockGraphs(NamedTuple):
    """One steady block shape's captured steps: the detect graph's
    input ``iq`` and the ``detect``, ``l2`` and ``gate`` graphs."""
    iq: torch.Tensor
    detect: StepGraph
    l2: StepGraph
    gate: StepGraph


def resolve_device_l2(device_l2: bool | None = None) -> bool:
    """Whether bursts are decoded batched on the device: ``device_l2``
    if given, else on unless DUMPVDL2_TPU_L2 is "0".  (The JAX
    package's "auto" picks host L2 on its CPU backend only because its
    CPU device path is slow; here "auto" is device L2 everywhere.)"""
    if device_l2 is not None:
        return bool(device_l2)
    return os.environ.get("DUMPVDL2_TPU_L2", "auto") != "0"


def resolve_device_gate(device_gate: bool | None = None) -> bool:
    """Whether candidate gating and the noise floor run on the device:
    ``device_gate`` if given, else on unless DUMPVDL2_TPU_GATE is "0"
    (the JAX package's rule)."""
    if device_gate is not None:
        return bool(device_gate)
    return os.environ.get("DUMPVDL2_TPU_GATE", "auto") != "0"


class VDL2Pipeline:
    """Device-L2 receiver for ``freqs`` inside one wideband stream at
    ``sample_rate`` (an ``oversample`` multiple of 105 kHz).

    Runs on ``device`` ("cuda" by default); raises when no GPU is
    present unless the caller asks for the CPU.  ``device_l2`` selects
    device or host burst decoding (see :func:`resolve_device_l2`),
    ``device_gate`` the gating mode (see :func:`resolve_device_gate`);
    host L2 implies host gating, as in the JAX package.
    ``span_log`` (core/spans.py) records each block's host spans, its
    device time by step and its frames.  On CUDA, with device L2 and
    gate, steady blocks replay their steps as CUDA graphs
    (:func:`graph_key`); ``graph_captures`` counts the captures, one a
    key.  ``step_ms``, when set to a
    dict, makes each block synchronize after its detect, L2 and
    (device-gated) gate steps and after draining, and adds those spans'
    milliseconds there under ``detect``, ``l2``, ``gate`` and
    ``fetch_host`` (the fetch and the host's decode): a breakdown for
    measurement, at the cost of the overlap.
    """

    def __init__(self, freqs: list[int], centerfreq: int, sample_rate: int,
                 oversample: int, max_ppm: float = 0.0,
                 station_id: str | None = None,
                 max_candidates: int = 64,
                 device: str | torch.device | None = None,
                 device_gate: bool | None = None,
                 device_l2: bool | None = None):
        self.device = resolve_device(device)
        self.use_device_l2 = resolve_device_l2(device_l2)
        # the device gate consumes the device L2 results
        self.use_device_gate = self.use_device_l2 \
            and resolve_device_gate(device_gate)
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
        # device gate: carried state (core/nf_gate.py), the block base
        # it is relative to, and the (C, K) identity slot -> L2 row map
        self._gate_state: dict | None = None
        self._gate_base = 0
        self._gate_rows_cache = None
        self._freqs_f32 = torch.as_tensor(np.asarray(self.freqs, np.float32),
                                          device=self.device)
        # Two-deep host pipeline: block N's device work is launched
        # before older blocks' results are consumed; transfers run in a
        # background thread.
        self._pending_q = deque()
        self._fetch_pool = None
        self._last_proc_base = None
        self._nf_mags = None
        self.last_deferred_min: int | None = None
        self.step_ms: dict | None = None
        self.span_log = SpanLog(self.device)
        # CUDA graphs by graph_key, the carried state they read and
        # write in place (made at the first capture), and their stream
        self._graphs: dict = {}
        self._static: dict | None = None
        self._capture_stream = None
        self.graph_captures = 0

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
    def _candidate_fields(cands, host_l2: bool = False):
        """Candidate tensors the host needs.  With device L2 the
        symbols and power stay on the device (the L2 decode consumed
        them there); with host L2 (``host_l2``) they come too."""
        small = (cands.count, cands.det_idx, cands.sync_idx,
                 cands.dphi, cands.pherr, cands.sym_valid)
        if host_l2:
            return small + (cands.symbols, cands.power)
        return small

    def _process_candidates(self, base: int, eof: bool, fetched,
                            l2_np: dict | None, l2_map
                            ) -> list[DecodedFrame]:
        """The host candidate loop and noise-floor tracker.  ``l2_np``
        is the fetched device L2 result, or None in host-L2 mode, where
        ``fetched`` also carries the symbols and power and the host
        decodes each burst."""
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

        count, det_idx, sync_idx, dphi, pherr, sym_valid = fetched[:6]
        symbols, power = fetched[6:] if l2_np is None else (None, None)
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
                if l2_np is not None:
                    res = _result_from_batch(l2_np, l2_index(c, k))
                    hdr_ok = res.ok or res.reason not in _HEADER_REASONS
                else:
                    res = header_info(descramble(symbols_to_bits_msb(
                        symbols[c, k][:9])[:HEADER_LEN]))
                    hdr_ok = res.ok
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
                if l2_np is not None:
                    frame_pwr = float(l2_np["frame_pwr"][l2_index(c, k)])
                else:
                    res = decode_burst(symbols_to_bits_msb(
                        symbols[c, k][:total_syms])[:res.bits_consumed])
                    frame_pwr = float(power[c, k, :total_syms].mean())
                self._advance_noise_floor(c, sp_g)
                ch.busy_until = sp_g + total_syms * SPS
                ch.next_det_min = det_g + 1
                decided(ch, det_g)
                self._emit(out, ch, c, res, frame_pwr, ch.mag_nf, ppm)
        return out

    def _emit(self, out: list, ch: ChannelState, c: int, res: BurstResult,
              frame_pwr: float, nf: float, ppm: float) -> None:
        """Count an accepted burst and append its frames to ``out``,
        with the noise floor ``nf`` it read."""
        debug_print(D_BURST,
                    "ch %d: burst ok=%s reason=%s datalen=%d "
                    "blocks=%d fec_corr=%d frames=%d",
                    c, res.ok, res.reason or "-", res.datalen,
                    res.blocks_processed, res.num_fec_corrections,
                    len(res.frames))
        for fr in res.frames:
            debug_print_buf_hex(D_BURST_DETAIL, fr, "unstuffed frame:")
        self._count_burst(ch, res, frame_pwr)
        for i, frame in enumerate(res.frames):
            md = MsgMetadata(
                station_id=self.station_id, freq=ch.freq,
                frame_pwr_dbfs=10.0 * math.log10(max(frame_pwr, 1e-30)),
                nf_pwr_dbfs=20.0 * math.log10(nf + 0.001),
                ppm_error=ppm,
                burst_timestamp=time.time(),
                datalen_octets=res.datalen_octets,
                synd_weight=res.synd_weight,
                num_fec_corrections=res.num_fec_corrections,
                idx=i)
            out.append(DecodedFrame(metadata=md, frame=frame))

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

    # ------------------------------------------------------- device gating
    def _gate_rows(self, l2_map):
        """Slot -> L2 batch row map as a (C, K) int32 tensor."""
        if l2_map is not None:
            return l2_map
        if self._gate_rows_cache is None:
            C, K = len(self.channels), self.max_candidates
            self._gate_rows_cache = torch.arange(
                C * K, dtype=torch.int32, device=self.device).reshape(C, K)
        return self._gate_rows_cache

    def _gate_delta(self, base: int) -> int:
        d = base - self._gate_base
        self._gate_base = base
        return int(np.clip(d, -nf_gate.MAX_DELTA, nf_gate.MAX_DELTA))

    def _gate_state_now(self) -> dict:
        if self._gate_state is None:
            self._gate_state = nf_gate.init_state(len(self.channels),
                                                  device=self.device)
        return self._gate_state

    def _dispatch_gate(self, dets, l2, l2_map, pwr3, H: int, delta):
        """Launch the device gate + NF step for one block on the carried
        gate state: ``(out, new_state)`` (the state chains on the
        device; see core/nf_gate.py)."""
        return nf_gate.gate_nf_single(
            dets.count, dets.det_idx, dets.sync_idx, dets.sym_valid,
            dets.dphi, self._gate_rows(l2_map), l2["hdr_ok"],
            l2["bits_consumed"], pwr3, H, delta, self._gate_state_now(),
            self._freqs_f32, self.max_ppm)

    def _process_verdicts(self, gout, fetched, l2_np, l2_map_np,
                          base: int) -> list[DecodedFrame]:
        """Device-gated twin of _process_candidates: the decisions were
        made on the device; the host mirrors the carried state, bumps
        the reference counters, and assembles frames for accepts."""
        out: list[DecodedFrame] = []
        v = gout["verdicts"]
        nf_read = gout["nf_read"]
        count, det_idx, sync_idx, dphi, pherr, sym_valid = fetched
        self._last_proc_base = base
        deferred = gout["deferred_at"]
        mins = deferred[deferred >= 0]
        self.last_deferred_min = base + int(mins.min()) if mins.size \
            else None
        K = det_idx.shape[1]

        def l2_row(c: int, k: int) -> int:
            return int(l2_map_np[c, k]) if l2_map_np is not None \
                else c * self.max_candidates + k

        for c, ch in enumerate(self.channels):
            if int(count[c]) > K:
                ch.bump("demod.sync.overflow")
            # mirror the carried device state (introspection and
            # handover; the decisions never consult these mirrors)
            ch.busy_until = base + int(gout["busy_until"][c])
            ch.next_det_min = base + int(gout["next_det_min"][c])
            ch.mag_nf = float(gout["mag_nf"][c])
            ch.mag_lp = float(gout["mag_lp"][c])
            ch.nfcnt = int(gout["nfcnt"][c])
            ch.nf_hold = base + int(gout["hold"][c]) \
                if bool(gout["hold_active"][c]) else None
            ch.deferred_at = None
            vc = v[c]
            for k in np.nonzero((vc != V_EMPTY) & (vc != V_SKIP)
                                & (vc != V_UNPROCESSED))[0]:
                verdict = int(vc[k])
                sp_g = base + int(sync_idx[c, k])
                if verdict == V_L2_OVERFLOW:
                    ch.bump("demod.sync.overflow")
                    continue
                if verdict not in nf_gate.SYNC_GOOD_VERDICTS:
                    continue          # V_DEFER / V_EOF_SHORT: pending
                ch.bump("demod.sync.good")
                debug_print(D_DEMOD,
                            "ch %d (%d Hz): sync at %d err=%.3f dphi=%.5f",
                            c, ch.freq, sp_g, float(pherr[c, k]),
                            float(dphi[c, k]))
                if verdict in (V_DEFER_DATA, V_PPM_REJECT):
                    continue
                if verdict == V_HDR_REJECT:
                    res = _result_from_batch(l2_np, l2_row(c, k))
                    debug_print(D_BURST, "ch %d: header rejected (%s)",
                                c, res.reason)
                    ch.bump(_error_counter(res.reason))
                    continue
                if verdict == V_EOF_TRUNC:
                    ch.bump("decoder.errors.eof_truncated")
                    continue
                # V_ACCEPT
                row = l2_row(c, k)
                res = _result_from_batch(l2_np, row)
                ppm = SYMBOL_RATE * float(dphi[c, k]) \
                    / (2.0 * math.pi * ch.freq) * 1e6
                self._emit(out, ch, c, res, float(l2_np["frame_pwr"][row]),
                           float(nf_read[c, k]), ppm)
        return out

    # ------------------------------------------------------------------ feed
    def feed(self, iq: np.ndarray, eof: bool = False) -> list[DecodedFrame]:
        """Process one wideband complex64 block; returns decoded frames.

        ``iq`` is the dequantized complex baseband at the ingest rate.
        Length need not be aligned; a residual is carried internally.
        """
        log = self.span_log
        blk = log.new_block(self.step_ms is not None)
        log.open(blk, "feed")
        log.open(blk, "feed.h2d")
        iq = np.ascontiguousarray(iq, dtype=np.complex64)
        if self._residual.size:
            iq = np.concatenate([self._residual, iq])
        usable = (iq.size // self.oversample) * self.oversample
        self._residual = iq[usable:]
        planar = torch.as_tensor(to_planar(iq[:usable]), device=self.device)
        log.close(blk, "feed.h2d")
        frames = self._feed_planar(planar, eof, blk)
        log.close(blk, "feed")
        return frames

    def feed_planar(self, iq, eof: bool = False) -> list[DecodedFrame]:
        """feed() for planar (2, N) float32 blocks, N a multiple of the
        oversample factor.  ``iq`` may be a tensor already on the
        pipeline's device (no host->device copy) or a numpy array."""
        return self._feed_planar(iq, eof, None)

    def _feed_planar(self, iq, eof: bool, blk) -> list[DecodedFrame]:
        """feed_planar() in the record ``blk`` of its feed() call, or in
        a new one."""
        iq = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
        if iq.shape[1] % self.oversample:
            raise ValueError(f"block length {iq.shape[1]} is not a multiple "
                             f"of the oversample factor {self.oversample}")
        if iq.shape[1] == 0:
            return self.finish() if eof else []
        log = self.span_log
        if blk is None:
            blk = log.new_block(self.step_ms is not None)
        log.open(blk, "feed_planar")
        # The queue holds no device tensors: the fetch future owns the
        # only references, so each block's buffers (with host L2 the
        # (C, K, S) symbols and powers, ~0.46 GB a wideband block) are
        # freed as soon as its transfer completes.  The fetch thread
        # puts its copies on the same (default) stream, after this
        # block's work.
        log.open(blk, "dispatch")
        tree, base, nf_base = self._dispatch_block(iq)
        log.close(blk, "dispatch")
        t_fetch = time.perf_counter_ns()
        fut = self._submit_fetch(tree, blk)
        del tree
        self._pending_q.append((self.use_device_gate, fut, base, nf_base,
                                blk))
        frames = []
        while len(self._pending_q) > 2 \
                or (self._pending_q and self._pending_q[0][1].done()):
            frames.extend(self._drain_oldest())
        if self.step_ms is not None:
            frames.extend(self._drain_pending())
            log.add(blk, "fetch_host", t_fetch)
            for key in ("detect", "l2", "gate", "fetch_host"):
                ms = blk.ms(key)
                if ms is not None:
                    self.step_ms[key] = self.step_ms.get(key, 0.0) + ms
        if eof:
            frames.extend(self.finish())
        log.close(blk, "feed_planar")
        return frames

    def _dispatch_block(self, iq: torch.Tensor):
        """Enqueue one block's device work (detection, L2 and, gated,
        the gate) and advance the carried stream state, each step a span
        of the current call's record; no wait but under ``step_ms``.  A
        steady block replays the steps' CUDA graphs (:meth:`_graphs_for`,
        the record's ``graphed``).  Returns the tree to fetch for the
        drain (a :class:`fetch.Packed` one for graphs), the block's base
        and its noise-floor base."""
        log = self.span_log
        blk = log.current
        H = self.hist.shape[2]
        g = self._graphs_for(iq.shape[1], H)
        n0 = self.n0 & 0xFFFFFF
        if not self.use_device_l2:
            # host L2: every candidate's window is sliced on the device
            # and decoded on the host
            log.open(blk, "detect")
            dets, new_hist, new_carry, pwr3 = process_block(
                iq, self.taps, self.dphi, n0, self.carry,
                self.hist, self.oversample, DEFAULT_HALO, SYNC_THRESHOLD,
                self.max_candidates, MAX_BURST_SYMS)
            log.close(blk, "detect")
            l2 = l2_map = None
        else:
            log.open(blk, "detect")
            if g is not None:
                blk.graphed = True
                self._bind_static()
                g.iq.copy_(iq)
                iq, n0 = g.iq, self._static["n0"].fill_(n0)
            dets, phases, pwr, new_hist, new_carry, pwr3 = \
                process_block_detect(
                    iq, self.taps, self.dphi, n0, self.carry, self.hist,
                    self.oversample, DEFAULT_HALO, SYNC_THRESHOLD,
                    self.max_candidates, MAX_BURST_SYMS,
                    graph=None if g is None else g.detect)
            log.close(blk, "detect")
            log.open(blk, "l2")
            l2, l2_map = l2_sliced(phases, pwr, dets.count, dets.sync_idx,
                                   dets.dphi, self.max_candidates,
                                   MAX_BURST_SYMS,
                                   graph=None if g is None else g.l2)
            if l2_map is not None:
                l2_map = l2_map.reshape(len(self.channels),
                                        self.max_candidates)
            del phases, pwr
            log.close(blk, "l2")
        self.carry = new_carry
        self.n0 = (self.n0 + iq.shape[1]) & 0xFFFFFF

        base = self.hist_base
        M_total = H + iq.shape[1] // self.oversample
        keep = min(DEFAULT_HALO, M_total)
        self.hist = new_hist
        self.hist_base = base + M_total - keep

        if self.use_device_gate:
            # the drain fetches verdicts and per-accept noise-floor
            # readings instead of the magnitude stream
            log.open(blk, "gate")
            if g is not None:
                self._static["delta"].fill_(self._gate_delta(base))
                tree = g.gate.replay()
            else:
                gout, self._gate_state = self._dispatch_gate(
                    dets, l2, l2_map, pwr3, H, self._gate_delta(base))
                tree = (gout, self._candidate_fields(dets), l2, l2_map)
            log.close(blk, "gate")
            if g is not None:
                tree = self._fetch_copy(*tree, blk)
            return tree, base, base + H
        return ((mag16(pwr3),
                 self._candidate_fields(dets, not self.use_device_l2), l2,
                 l2_map), base, base + H)

    # ------------------------------------------------------- CUDA graphs
    def _graphs_for(self, N: int, H: int) -> _BlockGraphs | None:
        """The graphs of a block of ``N`` samples on a halo of ``H``
        (captured here on the first steady block of its key, up to
        GRAPH_KEYS keys), or None: the block runs eagerly."""
        key = graph_key(self.device, self.use_device_l2,
                        self.use_device_gate, H, N, len(self.channels),
                        self.taps.shape[0], self.max_candidates,
                        MAX_BURST_SYMS)
        if key is None:
            return None
        g = self._graphs.get(key)
        if g is None and len(self._graphs) < GRAPH_KEYS:
            g = self._graphs[key] = self._capture(N)
        return g

    def _bind_static(self) -> None:
        """Point the carried state at the graphs' buffers, copying in
        what eager code (the EOF flush, load_state) left elsewhere."""
        st = self._static
        for name in ("taps", "dphi", "carry", "hist"):
            cur = getattr(self, name)
            if cur is not st[name]:
                st[name].copy_(cur)
                setattr(self, name, st[name])
        gate = self._gate_state_now()
        if gate is not st["gate"]:
            for k, buf in st["gate"].items():
                buf.copy_(gate[k])
            self._gate_state = st["gate"]

    def _capture(self, N: int) -> _BlockGraphs:
        """Capture the three steps of a steady block of ``N`` samples,
        with no fetch in flight and the device idle, on the pipeline's
        capture stream, into one memory pool (replayed in this order).
        Each graph reads the carried state from its buffers and writes
        the new state back there at its end; n0 and the gate's base
        delta are 0-dim device inputs, set before each replay."""
        wait([entry[1] for entry in self._pending_q])
        torch.cuda.synchronize(self.device)
        if self._static is None:
            self._static = {
                "taps": self.taps, "dphi": self.dphi,
                "carry": torch.empty_like(self.carry),
                "hist": torch.empty_like(self.hist),
                "gate": {k: torch.empty_like(v)
                         for k, v in self._gate_state_now().items()},
                "n0": torch.zeros((), dtype=torch.int64,
                                  device=self.device),
                "delta": torch.zeros((), dtype=torch.int32,
                                     device=self.device)}
            self._capture_stream = torch.cuda.Stream(self.device)
        self._bind_static()
        st = self._static
        C, K, S = len(self.channels), self.max_candidates, MAX_BURST_SYMS
        iq = torch.empty((2, N), dtype=torch.float32, device=self.device)
        made = {}

        # the steps' own functions, not this module's names for them: a
        # capture is no block, and what wraps those names must not see
        # it
        def detect():
            out = _device.process_block_detect(
                iq, st["taps"], st["dphi"], st["n0"], st["carry"],
                st["hist"], self.oversample, DEFAULT_HALO, SYNC_THRESHOLD,
                K, S)
            dets, phases, pwr, new_hist, new_carry, pwr3 = out
            st["hist"].copy_(new_hist)
            st["carry"].copy_(new_carry)
            made.update(dets=dets, phases=phases, pwr=pwr, pwr3=pwr3)
            snap, hist, carry = Snapshot(tuple(dets)), st["hist"], st["carry"]
            return lambda: (type(dets)(*snap.copy()), phases.clone(),
                            pwr.clone(), hist, carry, pwr3)

        def l2():
            d = made["dets"]
            made["l2"] = _l2_sliced(made["phases"], made["pwr"], d.count,
                                    d.sync_idx, d.dphi, K, S, False)
            return Snapshot(made["l2"]).copy

        def gate():
            d, (l2, inv) = made["dets"], made["l2"]
            l2_map = None if inv is None else inv.reshape(C, K)
            out, new_state = self._dispatch_gate(
                d, l2, l2_map, made["pwr3"], DEFAULT_HALO, st["delta"])
            for k, buf in st["gate"].items():
                buf.copy_(new_state[k])
            tree = (out, self._candidate_fields(d), l2, l2_map)
            buf = fetch.pack_tree(tree)
            return lambda: (tree, buf)

        pool = torch.cuda.graph_pool_handle()
        graphs = _BlockGraphs(iq, *(
            StepGraph(step, pool, self._capture_stream)
            for step in (detect, l2, gate)))
        self.graph_captures += 1
        return graphs

    def _fetch_copy(self, tree, buf: torch.Tensor, blk) -> fetch.Packed:
        """A graphed block's fetch, enqueued by the main thread after the
        gate replay, before the next replay overwrites ``buf`` (the gate
        graph's pack of ``tree``): one non-blocking copy into pinned
        host memory, and the event the fetch thread waits for.  (A
        pageable copy made by the fetch thread waits in the stream for
        all the work enqueued by then, and the main thread's CUDA calls
        stall behind it meanwhile.)  The copy is the fetch's first
        device operation, so the record's ``fetch`` event goes here
        (core/spans.py)."""
        self.span_log.fetch_enqueued(blk)
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return fetch.Packed(tree, host, ready)

    def _submit_fetch(self, tree, blk):
        if self._fetch_pool is None:
            self._fetch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="vdl2-fetch")
        return self._fetch_pool.submit(self._fetch, tree, blk)

    def _fetch(self, tree, blk):
        """The fetch thread's copy of one block's results (span
        ``fetch`` of ``blk``, its event before the first operation),
        then the block's device times (the copy waited for the stream,
        so its events have completed) and the bytes it copied by part
        of the tree."""
        log = self.span_log
        log.open(blk, "fetch")
        out = coalesced_get(tree)
        log.close(blk, "fetch")
        log.fetched(blk, out)
        return out

    def _drain_oldest(self) -> list[DecodedFrame]:
        """Host-process the oldest in-flight block, if any (spans
        ``drain`` > ``drain.wait``, ``drain.verdicts`` of its record)."""
        if not self._pending_q:
            return []
        gated, fut, base, nf_base, blk = self._pending_q.popleft()
        log = self.span_log
        log.open(blk, "drain")
        log.open(blk, "drain.wait")
        got = fut.result()
        log.close(blk, "drain.wait")
        log.open(blk, "drain.verdicts")
        if gated:
            frames = self._process_verdicts(*got, base)
        else:
            mags_np, fetched, l2_np, l2_map_np = got
            self._stash_noise_block(mags_np, nf_base)
            frames = self._process_candidates(base, False, fetched, l2_np,
                                              l2_map_np)
            self._finish_noise_block()
        log.close(blk, "drain.verdicts")
        log.close(blk, "drain")
        blk.frames = len(frames)
        return frames

    def _drain_pending(self) -> list[DecodedFrame]:
        """Drain every in-flight block in order."""
        frames = []
        while self._pending_q:
            frames.extend(self._drain_oldest())
        return frames

    def finish(self) -> list[DecodedFrame]:
        """Flush: resolve deferred candidates with the data we have (the
        span ``finish`` of a record of its own, which counts the
        flush's frames)."""
        log = self.span_log
        blk = log.new_block(self.step_ms is not None)
        log.open(blk, "finish")
        frames = self._drain_pending()
        flushed = self._flush()
        log.close(blk, "finish")
        blk.frames = len(flushed)
        return frames + flushed

    def _flush(self) -> list[DecodedFrame]:
        """finish()'s EOF flush of the halo, after the drain."""
        if self._fetch_pool is not None:
            # EOF: release the background fetch thread (recreated
            # lazily if the pipeline is fed again)
            self._fetch_pool.shutdown(wait=False)
            self._fetch_pool = None
        if self.hist.shape[2] == 0:
            return []
        if not self.use_device_l2:
            cands = find_and_slice(self.hist, SYNC_THRESHOLD,
                                   self.max_candidates, MAX_BURST_SYMS)
            fetched = coalesced_get(self._candidate_fields(cands, True))
            return self._process_candidates(self.hist_base, True, fetched,
                                            None, None)
        # device L2: the halo's detections, then the sliced L2 step (the
        # batch launch_compacted_l2 gives on the fully sliced candidates)
        dets, phases, pwr = detect_planes(self.hist, SYNC_THRESHOLD,
                                          self.max_candidates,
                                          MAX_BURST_SYMS)
        l2, l2_map = l2_sliced(phases, pwr, dets.count, dets.sync_idx,
                               dets.dphi, self.max_candidates,
                               MAX_BURST_SYMS, flush=True)
        del phases, pwr
        if l2_map is not None:
            l2_map = l2_map.reshape(len(self.channels), self.max_candidates)
        if self.use_device_gate:
            # EOF through the device gate: no fresh magnitude columns
            gout, self._gate_state = nf_gate.gate_only(
                dets.count, dets.det_idx, dets.sync_idx,
                dets.sym_valid, dets.dphi, self._gate_rows(l2_map),
                l2["hdr_ok"], l2["bits_consumed"],
                self._gate_delta(self.hist_base), self._gate_state_now(),
                self._freqs_f32, self.max_ppm, eof=True)
            gout_np, fetched, l2_np, l2_map_np = coalesced_get(
                (gout, self._candidate_fields(dets), l2, l2_map))
            return self._process_verdicts(gout_np, fetched, l2_np,
                                          l2_map_np, self.hist_base)
        fetched, l2_np, l2_map_np = coalesced_get(
            (self._candidate_fields(dets), l2, l2_map))
        return self._process_candidates(self.hist_base, True, fetched,
                                        l2_np, l2_map_np)


def load_state(pipe: VDL2Pipeline, state: dict) -> None:
    """Carry a receiver's stream state into ``pipe``.

    ``state`` holds numpy arrays and ints: ``taps``, ``dphi`` (uint32
    NCO increments), ``carry`` (2, T-1), ``n0``, ``hist`` (2, C, H),
    ``hist_base``, optionally ``residual`` (complex64 samples not yet
    fed), and ``channels``: one dict per channel with ``busy_until``,
    ``next_det_min``, ``mag_lp``, ``mag_nf``, ``nfcnt``, ``nf_hold``
    (int or None) and ``nf_saved`` (list of (indices, magnitudes)).
    A stream that ran device-gated also carries ``gate_state`` (the ten
    arrays of core/nf_gate.init_state, relative to ``gate_base``) and
    ``gate_base``.  The pipeline must have no block in flight.
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
    if state.get("gate_state") is not None:
        pipe._gate_state = nf_gate.state_from_numpy(state["gate_state"],
                                                    pipe.device)
        pipe._gate_base = int(state["gate_base"])
