"""Sharded streaming pipeline: the mesh DSP step in the app.

Port of ``dumpvdl2_tpu/core/mesh_pipeline.py`` (``--mesh CxT``):
wideband blocks are processed by parallel/sharded.py's step over a
(channel, time) device mesh, candidates from all time shards merge back
into VDL2Pipeline's decode (device-gated through
``nf_gate.gate_nf_mesh``, or host-gated, or host L2), and the output is
the single-device path's.

Cross-block bursts: within a block, time shards exchange a forward halo
sized for a whole burst, so any burst detected in a shard's fresh region
is sliced completely.  A burst that runs off the END of a block (the
last shard's forward pad is zeros) is deferred by the host
(``last_deferred_min``) and the next block is fed with a raw re-read of
the affected tail ("prepend"), re-channelized with the exact NCO phase
(n0 is absolute), reproducing the single-device halo semantics.  EOF
flushes through the single-device demod on the raw tail buffer:
bit-identical samples, same host logic.

The host keeps one block in flight (``_pending``): a block's results are
drained after the next block's sharded step has been launched, and the
prepend timing depends on that one-block lag.  It also means that the
block after a deferring one is stepped before the re-read is known, and
cannot re-detect the deferred burst (the detection lies before it).
The JAX package decides that block's later candidates on the burst's
channel all the same, which moves the channel past the burst, so the
re-read skips it and the burst is lost; and it saves that block's
magnitude columns for the held channel and replays them before the
burst reads its noise floor, so the floor includes samples after the
burst.  Here such a block leaves the channel to the re-read, both its
candidates at or after the pending hold (``_held_stops``) and its
magnitude columns, which the re-read block then tracks from that
block's start for the channel (``_column_starts``): as the
single-device path, which re-detects the burst in the next block and
tracks that block's columns after the burst's reading.  Where no
channel is held across a block the two packages decide alike; their
noise floors agree where the JAX package's blocks are also cut at
multiples of 3 decimated samples a shard (see ``_align``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import SPS, SYNC_THRESHOLD
from ..dsp.demod import Candidates, find_and_slice
from ..dsp.frontend import bandpass_channelize, to_planar
from ..dsp.ingest_kernel import pair_bytes
from ..io.iqfile import dequantize_block
from ..parallel.mesh import make_mesh
from ..parallel.sharded import (BACK_HALO, ShardedState, init_sharded_state,
                                make_sharded_step)
from ..utils.fetch import coalesced_get
from . import nf_gate
from .pipeline import (DEFAULT_HALO, MAX_BURST_SYMS, VDL2Pipeline,
                       launch_compacted_l2, mag16)

# Forward halo: a whole max-length burst fits ahead of any detection
# point in a shard's fresh region.
FWD_HALO = MAX_BURST_SYMS * SPS + 16
# Margin (decimated samples) of context re-fed before a deferred burst:
# sync-metric lookback + detection margin.
_DEFER_MARGIN = BACK_HALO + 192


class MeshPipeline(VDL2Pipeline):
    """VDL2Pipeline whose per-block DSP runs sharded over a mesh of
    ``mesh_shape`` (channel shards, time shards) on ``devices`` (see
    parallel/mesh.make_mesh: every visible GPU by default; a list may
    repeat a device).  The results gather on the mesh's first device,
    which is the pipeline's ``device``; the other keywords are
    VDL2Pipeline's."""

    def __init__(self, freqs, centerfreq, sample_rate, oversample,
                 mesh_shape=(1, 1), devices=None, **kw):
        cn, tn = mesh_shape
        if len(freqs) % cn != 0:
            raise ValueError(
                f"channel count {len(freqs)} not divisible by "
                f"channel shards {cn}")
        mesh = make_mesh(cn, tn, devices)
        super().__init__(freqs, centerfreq, sample_rate, oversample,
                         device=mesh.home, **kw)
        self.mesh = mesh
        self.Tn, self.Cn = tn, cn
        T = self.taps.shape[0]
        self.step = make_sharded_step(
            self.mesh, oversample=oversample, fwd_halo=FWD_HALO,
            threshold=SYNC_THRESHOLD, max_candidates=self.max_candidates,
            max_symbols=MAX_BURST_SYMS)
        self.state = init_sharded_state(self.mesh, len(freqs), T)
        # Blocks start at, and span, multiples of 3 decimated samples a
        # shard, so that every shard's every-3rd-sample magnitude
        # columns lie on the stream's every 3rd sample, as the
        # single-device path's do for blocks of 3k decimated samples
        # (the JAX package takes any multiple of Tn*oversample, and its
        # shards' columns drift from the stream's by up to 2 samples).
        self._align = 3 * oversample         # raw samples
        self._unit = tn * self._align        # block length divisibility
        self.global_raw = 0                 # absolute index of next input
        # rolling raw tail for deferred-burst re-reads + EOF flush
        self._tail_base_keep = (DEFAULT_HALO + _DEFER_MARGIN) * oversample \
            + T
        self._tail_keep = self._tail_base_keep
        self._tail = np.zeros((2, 0), np.float32)
        self._residual = np.zeros((2, 0), np.float32)   # planar here
        self._prepend_from: int | None = None   # absolute raw index
        self._pending = None                 # the one block in flight
        # channels the previous block left to a re-read, and its base
        self._left: np.ndarray | None = None
        self._left_base = 0

    # ------------------------------------------------------------ feed
    def feed(self, iq: np.ndarray, eof: bool = False):
        """Process one wideband complex64 block (any length)."""
        return self.feed_planar(
            to_planar(np.ascontiguousarray(iq, dtype=np.complex64)), eof=eof)

    def feed_raw(self, buf, sample_format: str, copied=None, read=None):
        """feed() for raw interleaved samples, as VDL2Pipeline.feed_raw
        takes them.  The raw tail of the re-reads lives on the host, so
        the mesh dequantizes there as io/iqfile.py::iq_blocks does (the
        partial sample pair at the buffer's end kept for the next call)
        and feeds the complex block; ``buf`` is read before the call
        returns, so ``copied`` is not recorded, and ``read`` is not
        kept."""
        data = self._raw_pend + np.asarray(buf).tobytes()
        usable = len(data) - len(data) % pair_bytes(sample_format)
        self._raw_pend = data[usable:]
        if not usable:
            return []
        return self.feed(dequantize_block(data[:usable], sample_format))

    def feed_planar(self, iq, eof: bool = False):
        """feed() for a planar (2, N) float32 block, any N: a numpy
        array or a tensor (copied to the host, where the raw tail for
        the re-reads lives)."""
        if isinstance(iq, torch.Tensor):
            iq = iq.detach().to("cpu", torch.float32).numpy()
        planar = np.asarray(iq, np.float32)
        if self._residual.shape[1]:
            planar = np.concatenate([self._residual, planar], axis=1)
            self._residual = np.zeros((2, 0), np.float32)

        prepend = np.zeros((2, 0), np.float32)
        base_raw = self.global_raw
        override_state = False
        if self._prepend_from is not None:
            start = max(self._prepend_from,
                        -(-(self.global_raw - self._tail.shape[1])
                          // self._align) * self._align)
            n_pre = self.global_raw - start
            if n_pre > 0 and n_pre + planar.shape[1] >= self._unit:
                prepend = self._tail[:, self._tail.shape[1] - n_pre:]
                base_raw = start
                override_state = True
                self._prepend_from = None
            # else: input too small to make a block; keep deferring

        block = np.concatenate([prepend, planar], axis=1)
        usable = (block.shape[1] // self._unit) * self._unit
        # each shard must at least cover the FIR carry exchange
        T = self.taps.shape[0]
        min_block = -(- self.Tn * (T - 1 + self.oversample)
                      // self._unit) * self._unit
        if usable < min_block:
            self._residual = planar
            if override_state:
                self._prepend_from = base_raw     # retry with more input
            return self.finish() if eof else []
        # residual = the tail of the *input* not consumed this round
        consumed_fresh = max(0, usable - prepend.shape[1])
        self._residual = planar[:, consumed_fresh:]
        block = block[:, :usable]

        # advance global position by consumed fresh samples only
        self.global_raw += consumed_fresh
        self._push_tail(planar[:, :consumed_fresh])

        state = self.state
        if override_state:
            state = self._rebase_state(base_raw)
        cands, pwr3, self.state = self.step(block, self.taps, self.dphi,
                                            state)
        if override_state:
            # carried n0 advanced from the overridden base; re-anchor it
            # to the true stream position for the next (normal) block
            self.state = self.state._replace(
                n0=self.global_raw & 0xFFFFFF)

        l2, l2_inv = self._launch_l2_flat(cands)   # launched pre-drain
        Ml = block.shape[1] // self.Tn // self.oversample
        prepend_dec = prepend.shape[1] // self.oversample
        # one-deep drain: the PREVIOUS block's results are fetched only
        # now that this block's sharded step is launched.  A deferral
        # discovered one block late re-reads from the raw tail, which
        # _push_tail sizes to retain one extra block for this case.
        frames = self._drain_pending()
        base_dec = base_raw // self.oversample
        stops = self._held_stops(base_dec)
        col_from = self._column_starts(base_dec, prepend_dec, stops)
        if self.use_device_gate:
            # device-side merge + gate + NF; the drain fetches verdicts
            # and the merged candidate fields, not the magnitude stream
            gout, merged, self._gate_state = nf_gate.gate_nf_mesh(
                cands.count, cands.det_idx, cands.sync_idx, cands.dphi,
                cands.pherr, cands.sym_valid, l2_inv, l2["hdr_ok"],
                l2["bits_consumed"], pwr3, Ml, prepend_dec,
                self._gate_delta(base_dec), self._gate_state_now(),
                self._freqs_f32, self.max_ppm,
                stops=None if stops is None else torch.as_tensor(
                    stops, device=self.device), col_from=col_from)
            self._pending = ("gate", gout, merged, cands.count, l2,
                             base_dec)
        else:
            if l2 is not None:
                # device L2 consumed the symbols: only the small fields
                # stay referenced
                cands = cands._replace(symbols=None, power=None)
            self._pending = (cands, l2, l2_inv, pwr3, base_raw,
                             (prepend_dec, Ml, col_from), stops)
        if eof:
            frames.extend(self.finish())
        return frames

    def _drain_pending(self):
        if self._pending is None:
            return []
        if self._pending[0] == "gate":
            _, gout, merged, count_tc, l2, base_dec = self._pending
            self._pending = None
            gout_np, merged_np, count_np, l2_np = coalesced_get(
                (gout, merged, count_tc, l2))
            # the host merge bumps overflow per (shard, channel) whose
            # detections exceeded the K slots
            for _t, c in zip(*np.nonzero(count_np > self.max_candidates)):
                self.channels[c].bump("demod.sync.overflow")
            fetched = tuple(merged_np[k] for k in (
                "count", "det_idx", "sync_idx", "dphi", "pherr",
                "sym_valid"))
            frames = self._process_verdicts(
                gout_np, fetched, l2_np, merged_np["l2_row"], base_dec)
            self._note_deferral()
            return frames
        cands, l2, l2_inv, pwr3, base_raw, columns, stops = self._pending
        self._pending = None
        # one transfer: candidate fields + magnitudes + device L2
        # results (sqrt + f16 cast on the device, see pipeline.mag16)
        merged, l2_map, (mags_np, l2_np, inv_np) = self._merge_candidates(
            cands, host_l2=l2 is None, extra=(mag16(pwr3), l2, l2_inv))
        if stops is not None:
            merged = merged._replace(count=nf_gate.count_before(
                merged.count, merged.det_idx, stops))
        if inv_np is not None:
            # compacted L2 batch: translate flat slot ids to batch rows
            # (-1 entries overflowed the cap; the candidate loop counts
            # them as demod.sync.overflow)
            l2_map = inv_np[l2_map]
        # tracker columns that re-cover prepended samples are dropped:
        # the tracker saw them already (save for channels the previous
        # block left to this re-read); the rest lie on every 3rd fresh
        # decimated sample
        n0, base_rel, first = nf_gate.mesh_columns(
            mags_np.shape[1], self.Tn, columns[1], columns[0], columns[2])
        self._stash_noise_block(mags_np[:, n0:],
                                base_raw // self.oversample + base_rel)
        if first is not None:
            self._nf_col[:] = first
        frames = self._process_candidates(
            base_raw // self.oversample, False,
            self._candidate_fields(merged, l2 is None), l2_np,
            None if l2 is None else l2_map)
        self._finish_noise_block()
        self._note_deferral()
        return frames

    def _held_stops(self, base_dec: int) -> np.ndarray | None:
        """Per channel, the block-relative index from which this block
        leaves candidates to a re-read: the channel's pending hold, where
        the hold lies before the block (``base_dec``), so that the block
        cannot re-detect the deferred burst.  int32 max elsewhere; None
        when no channel has such a hold."""
        holds = [ch.nf_hold for ch in self.channels]
        if not any(h is not None and h < base_dec for h in holds):
            return None
        return np.array([max(h - base_dec, -2 ** 31)
                         if h is not None and h < base_dec else 2 ** 31 - 1
                         for h in holds], np.int32)

    def _column_starts(self, base_dec: int, prepend_dec: int,
                       stops: np.ndarray | None) -> np.ndarray | None:
        """Per channel, the first block-relative data position whose
        magnitude columns this block's tracker consumes: none for the
        channels it leaves to a re-read (``stops``), the previous
        block's start for those that block left to this re-read, else
        ``prepend_dec`` (past the re-covered samples).  None when every
        channel takes the JAX package's ``prepend_dec``."""
        left, left_base = self._left, self._left_base
        self._left = None if stops is None else stops < 2 ** 31 - 1
        self._left_base = base_dec
        if stops is None and (left is None or prepend_dec == 0):
            return None
        col_from = np.full(len(self.channels), prepend_dec, np.int64)
        if left is not None and prepend_dec > 0:
            col_from[left] = left_base - base_dec
        if stops is not None:
            col_from[self._left] = 2 ** 31 - 1
        return col_from

    def _note_deferral(self) -> None:
        """A deferred burst is re-read from the raw tail next block."""
        if self.last_deferred_min is not None:
            self._prepend_from = max(
                0, (self.last_deferred_min - _DEFER_MARGIN)
                * self.oversample // self._align * self._align)

    # ----------------------------------------------------------- flush
    def finish(self):
        """EOF: run the single-device demod over the raw tail buffer.

        The band-pass channelizer is a pure function of (samples, n0),
        so re-channelizing the tail yields bit-identical decimated
        samples; candidates resolve with the same host logic as the
        single-device finish().
        """
        frames0 = self._drain_pending()
        if self._residual.shape[1]:
            extra = self._residual
            self._residual = np.zeros((2, 0), np.float32)
            self.global_raw += extra.shape[1]
            self._push_tail(extra)
        T = self.taps.shape[0]
        need = (DEFAULT_HALO + _DEFER_MARGIN) * self.oversample + (T - 1)
        if self._prepend_from is not None:
            # a deferral discovered while draining the in-flight block
            # can lie further back than the default window
            need = max(need, self.global_raw - self._prepend_from + (T - 1))
        take = min(self._tail.shape[1], need)
        if take < T:
            return frames0
        usable = (take // self.oversample) * self.oversample
        tail = self._tail[:, self._tail.shape[1] - usable:]
        start_raw = self.global_raw - usable
        carry = torch.zeros((2, T - 1), dtype=torch.float32,
                            device=self.device)
        dec, _ = bandpass_channelize(
            torch.as_tensor(tail, device=self.device), self.taps, self.dphi,
            start_raw & 0xFFFFFF, carry, self.oversample, self.pfb_plan)
        # the first taps' worth of outputs used a zero carry: junk, but
        # they precede every unprocessed detection (margin covers them)
        cands = find_and_slice(dec, SYNC_THRESHOLD, self.max_candidates,
                               MAX_BURST_SYMS)
        start_dec = start_raw // self.oversample
        if not self.use_device_l2:
            fetched = coalesced_get(self._candidate_fields(cands, True))
            return frames0 + self._process_candidates(
                start_dec, True, fetched, None, None)
        l2, l2_map = launch_compacted_l2(cands.symbols, cands.power,
                                         cands.count, self.max_candidates)
        if l2_map is not None:
            l2_map = l2_map.reshape(len(self.channels), self.max_candidates)
        if self.use_device_gate:
            gout, self._gate_state = nf_gate.gate_only(
                cands.count, cands.det_idx, cands.sync_idx,
                cands.sym_valid, cands.dphi, self._gate_rows(l2_map),
                l2["hdr_ok"], l2["bits_consumed"],
                self._gate_delta(start_dec), self._gate_state_now(),
                self._freqs_f32, self.max_ppm, eof=True)
            gout_np, fetched, l2_np, l2_map_np = coalesced_get(
                (gout, self._candidate_fields(cands), l2, l2_map))
            return frames0 + self._process_verdicts(
                gout_np, fetched, l2_np, l2_map_np, start_dec)
        fetched, l2_np, l2_map_np = coalesced_get(
            (self._candidate_fields(cands), l2, l2_map))
        return frames0 + self._process_candidates(
            start_dec, True, fetched, l2_np, l2_map_np)

    # --------------------------------------------------------- helpers
    def _push_tail(self, planar: np.ndarray) -> None:
        if planar.shape[1] == 0:
            return
        # with the one-deep drain, a deferral from the in-flight block
        # is discovered one block late: retain one extra block (the
        # largest seen) on top of the burst+margin window so the
        # prepend re-read always finds its samples
        self._tail_keep = max(self._tail_keep,
                              self._tail_base_keep + planar.shape[1])
        self._tail = np.concatenate([self._tail, planar], axis=1)
        if self._tail.shape[1] > self._tail_keep:
            self._tail = self._tail[:, self._tail.shape[1]
                                    - self._tail_keep:]

    def _rebase_state(self, base_raw: int) -> ShardedState:
        """State for a block that re-reads old samples: time shard 0's
        FIR prefix comes from the tail buffer, its sync halo is zeroed
        (covered by the defer margin), n0 is the absolute position."""
        st = init_sharded_state(self.mesh, len(self.freqs),
                                self.taps.shape[0])
        T = self.taps.shape[0]
        have = self.global_raw - base_raw
        pre = self._tail[:, max(0, self._tail.shape[1] - have - (T - 1)):
                         self._tail.shape[1] - have]
        raw_tail = st.raw_tail
        if pre.shape[1] == T - 1:
            raw_tail = tuple(torch.as_tensor(np.ascontiguousarray(pre),
                                             device=x.device)
                             for x in raw_tail)
        return ShardedState(raw_tail=raw_tail, dec_tail=st.dec_tail,
                            n0=base_raw & 0xFFFFFF)

    def _merge_candidates(self, cands, host_l2: bool, extra):
        """Compact (Tn, C, K) candidate slots into (C, Tn*K) in time
        order, with a map back to the flat L2 batch index.

        With device L2 the (Tn, C, K, S) symbols/power were consumed on
        the device and are not fetched (``host_l2`` False); ``extra``
        is a tree of further device values fetched in the SAME transfer
        and returned fetched as the third element."""
        big = ("symbols", "power")
        names = [f for f in Candidates._fields
                 if f != "count" and (host_l2 or f not in big)]
        fetched, extra_np = coalesced_get(
            (tuple([cands.count] + [getattr(cands, f) for f in names]),
             extra))
        count = fetched[0]                       # (Tn, C)
        arrs = dict(zip(names, fetched[1:]))
        Tn, C, K = arrs["det_idx"].shape
        W = Tn * K
        out = {f: np.zeros((C, W) + a.shape[3:], a.dtype)
               for f, a in arrs.items()}
        out["det_idx"] = np.full((C, W), -1, np.int32)
        mcount = np.zeros(C, np.int32)
        l2_map = np.zeros((C, W), np.int64)
        for c in range(C):
            j = 0
            for t in range(Tn):
                n = int(min(count[t, c], K))
                for f, a in arrs.items():
                    out[f][c, j:j + n] = a[t, c, :n]
                l2_map[c, j:j + n] = (t * C + c) * K + np.arange(n)
                j += n
                if count[t, c] > K:
                    self.channels[c].bump("demod.sync.overflow")
            mcount[c] = j
        for f in big:
            out.setdefault(f, None)
        return Candidates(count=mcount, **out), l2_map, extra_np

    def _launch_l2_flat(self, cands):
        """Device L2 over the (Tn, C, K) candidate slots, with the same
        compaction as the single-device EOF path; ``inv`` is flat
        (translated through the merged slot map at drain time)."""
        if not self.use_device_l2:
            return None, None
        return launch_compacted_l2(cands.symbols, cands.power,
                                   cands.count.reshape(-1),
                                   self.max_candidates)
