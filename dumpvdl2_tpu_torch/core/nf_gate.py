"""Device-side candidate gating + noise-floor tracker: one step a block.

Port of ``dumpvdl2_tpu/core/nf_gate.py``: the single-device step
``gate_nf_single``, the mesh step ``gate_nf_mesh`` and the EOF step
``gate_only``.  The per-channel
burst state machine of ``VDL2Pipeline._process_candidates`` -- busy
windows, deferral, ppm gate, and the magnitude EMA / noise-floor
tracker with its busy-pause and deferral-hold semantics -- runs on the
device, so the host drain carries per-candidate verdicts and
noise-floor readings instead of the every-3rd-sample magnitude stream
(reference analog: demod.c:229-285, decode.c:198-258).

Semantics, as in the JAX package:

* per block, the tracker consumes magnitude columns in index order
  restricted to a computable mask -- the busy frontier, per-candidate
  claimed windows (header reject: 9 symbols, accept: the burst length),
  the hold drop-interval, and the deferral frontier;
* a noise-floor update fires at every 1000th TRACKED column with the
  EMA value at that column;
* each accepted candidate reads the floor as of its sync point;
* columns met while a deferral hold is pending are saved in a ring, not
  tracked, and replayed (filtered to positions at/after the busy window
  the resolution established) as a prefix of the stream when the hold
  releases.  The ring holds RING columns per channel; columns beyond it
  are dropped (a noise-floor-only effect).

Two kernels do the work, see core/gate_kernel.py: G1 (the gating
decisions over the candidate slots and the hold bookkeeping,
``_decisions``) and G2 (the tracker: the window mask, the ring replay,
the EMA over the tracked columns, the per-1000 floor updates and the
readings).  Only the ring update stays plain PyTorch here.  The EMA is
an affine first-order recurrence summed in another association than
JAX's ``associative_scan``: its float32 results match to about 1e-6
relative, not bit for bit.

int32 hygiene: every carried index is relative to the current block's
base; the caller passes the clamped inter-block delta and the rebase
clamps at _FLOOR, so a long stream never overflows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import SPS
from . import gate_kernel
from .gate_scan import (V_ACCEPT, V_DEFER_DATA, V_EOF_SHORT, V_EOF_TRUNC,
                        V_HDR_REJECT, V_L2_OVERFLOW, V_PPM_REJECT,
                        ceil_syms)

# Verdicts that resolve a candidate (host loop paths calling decided()).
DECIDED_VERDICTS = (V_L2_OVERFLOW, V_EOF_SHORT, V_HDR_REJECT,
                    V_EOF_TRUNC, V_PPM_REJECT, V_ACCEPT)
# Verdicts whose host path advanced the tracker to the sync point and
# claimed a busy window (hold drop-interval / replay-filter cases).
ADVANCE_VERDICTS = (V_HDR_REJECT, V_ACCEPT)
# Verdicts that bump demod.sync.good (header fitted the block).
SYNC_GOOD_VERDICTS = frozenset((V_DEFER_DATA, V_HDR_REJECT, V_EOF_TRUNC,
                                V_PPM_REJECT, V_ACCEPT))

_FLOOR = -(1 << 30)        # "long in the past" clamp for rebased indices
MAX_DELTA = 1 << 29        # caller clamps base deltas here
RING = 32768               # held-column ring capacity per channel

STATE_KEYS = ("busy_until", "next_det_min", "hold", "hold_active",
              "mag_lp", "mag_nf", "nfcnt", "ring_pos", "ring_val", "ring_n")
_STATE_DTYPES = {"hold_active": torch.bool, "mag_lp": torch.float32,
                 "mag_nf": torch.float32, "ring_val": torch.float32}


def init_state(C: int, ring: int = RING, device=None) -> dict:
    """Fresh carried device state (mirrors ChannelState defaults)."""
    def z(shape, dtype=torch.int32, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=device)
    return {
        "busy_until": z((C,)), "next_det_min": z((C,)), "hold": z((C,)),
        "hold_active": z((C,), torch.bool, False),
        "mag_lp": z((C,), torch.float32, 0.0),
        "mag_nf": z((C,), torch.float32, 2.0),
        "nfcnt": z((C,)),
        "ring_pos": z((C, ring), fill=_FLOOR),
        "ring_val": z((C, ring), torch.float32, 0.0),
        "ring_n": z((C,)),
    }


def state_from_numpy(state: dict, device) -> dict:
    """A carried state given as numpy arrays (e.g. the JAX pipeline's)
    as tensors of the gate's dtypes on ``device``."""
    return {k: torch.as_tensor(np.array(state[k]),
                               device=device).to(_STATE_DTYPES.get(
                                   k, torch.int32)).contiguous()
            for k in STATE_KEYS}


def _isin(v: torch.Tensor, codes) -> torch.Tensor:
    m = v == codes[0]
    for c in codes[1:]:
        m = m | (v == c)
    return m


def _rebase(state: dict, delta) -> dict:
    """Shift carried indices to the new block base (int32-safe).
    ``delta`` is an int or a 0-dim integer tensor on the state's device
    (a CUDA graph's input, core/graphs.py): the same int32 arithmetic."""
    if not isinstance(delta, torch.Tensor):
        delta = int(delta)
    st = dict(state)
    for k in ("busy_until", "next_det_min", "hold", "ring_pos"):
        st[k] = torch.clamp(state[k] - delta, min=_FLOOR)
    return st


def _gate(count, det_idx, sync_idx, sym_valid, dphi, l2_row, hdr_rows,
          bits_rows, state, freqs, max_ppm: float, eof: bool, end_rel: int):
    """Kernel G1 (or its plain twin) on the block's candidate slots:
    ``(g, bits, dec)``, the verdicts and carried gate state, each slot's
    bit count, and the hold decisions (:func:`_decisions`) with the
    tracker's bounds ``low`` and ``f_track``."""
    i32 = torch.int32
    return gate_kernel.gate(
        count.to(i32).contiguous(), det_idx.to(i32).contiguous(),
        sync_idx.to(i32).contiguous(), sym_valid.to(i32).contiguous(),
        dphi.to(torch.float32).contiguous(), l2_row.to(i32).contiguous(),
        hdr_rows.contiguous(), bits_rows.to(i32).contiguous(),
        *(state[k].contiguous() for k in ("busy_until", "next_det_min",
                                          "hold", "hold_active")),
        freqs, max_ppm, eof, end_rel)


def _decisions(verdicts, sync_idx, bits, state, deferred) -> dict:
    """Hold bookkeeping shared by every entry point: released, persist,
    drop_end (block-column low bound from the hold drop-interval),
    ring_filter (replay position filter), and the new hold state."""
    hold0, hold_act = state["hold"], state["hold_active"]
    busy0 = state["busy_until"]
    total_syms = ceil_syms(bits)
    decided = _isin(verdicts, DECIDED_VERDICTS)
    any_dec = decided.any(dim=1)
    first = torch.argmax(decided.to(torch.int32), dim=1)
    ar = torch.arange(verdicts.shape[0], device=verdicts.device)
    fv = verdicts[ar, first]
    fsync = sync_idx[ar, first]
    f_adv = _isin(fv, ADVANCE_VERDICTS)
    busy_after_first = torch.where(
        fv == V_HDR_REJECT, fsync + 9 * SPS,
        torch.where(fv == V_ACCEPT, fsync + total_syms[ar, first] * SPS,
                    busy0)).to(torch.int32)

    recovered = hold0 >= 0                    # block re-covered the hold
    released = hold_act & (any_dec | ((deferred < 0) & recovered))
    persist = hold_act & ~released
    floor = torch.full_like(hold0, _FLOOR)
    drop_end = torch.where(hold_act & any_dec & f_adv, fsync, floor)
    ring_filter = torch.where(any_dec & f_adv, busy_after_first, busy0)
    hold1_act = persist | (deferred >= 0)
    hold1 = torch.where(
        deferred >= 0,
        torch.where(persist, torch.minimum(hold0, deferred), deferred),
        hold0)
    return {"released": released, "persist": persist,
            "drop_end": drop_end, "ring_filter": ring_filter,
            "hold": hold1, "hold_active": hold1_act}


def _nf_track(verdicts, sync_idx, bits, mags, col_pos, state, dec,
              deferred, end_rel: int):
    """Noise-floor tracker (kernel G2, or its plain twin) and ring update
    for one block.

    The processed column stream is [ring (hold-release replay)] ++
    [this block's columns]; ``col_pos`` (W,) int32 are the rebased
    decimated indices of the block's columns, strictly increasing.
    Returns (nf_read (C, K), new tracker and ring state).
    """
    W = mags.shape[1]
    dev = verdicts.device
    i32 = torch.int32
    busy0 = state["busy_until"]
    ring_pos, ring_val, ring_n = (state["ring_pos"], state["ring_val"],
                                  state["ring_n"])
    R = ring_pos.shape[1]
    mag_lp1, mag_nf1, nfcnt1, nf_read, _ = gate_kernel.nf_track(
        mags.contiguous(), col_pos.contiguous(), verdicts, sync_idx, bits,
        dec["low"], dec["f_track"], dec["released"], dec["ring_filter"],
        ring_pos, ring_val, ring_n, state["mag_lp"], state["mag_nf"],
        state["nfcnt"])

    # --- ring update ---------------------------------------------------
    # appended while the hold persists: columns past the busy frontier,
    # up to the (new) deferral bound.  They form an interval [j_lo,
    # j_lo + n_app) of block columns, so ring slot s holds column
    # j_lo + (s - base_n): one gather from the block padded by R on
    # both sides.
    slot = torch.arange(R, dtype=i32, device=dev)[None, :]
    f_app = torch.where(deferred >= 0, deferred,
                        torch.full_like(busy0, end_rel))
    app = dec["persist"][:, None] & (col_pos[None, :] >= busy0[:, None]) \
        & (col_pos[None, :] < f_app[:, None])
    base_n = torch.where(dec["released"], torch.zeros_like(ring_n), ring_n)
    keep_old = ~dec["released"][:, None] & (slot < ring_n[:, None])
    n_app = app.sum(dim=1).to(i32)
    pos1 = torch.where(keep_old, ring_pos, torch.full_like(ring_pos, _FLOOR))
    val1 = torch.where(keep_old, ring_val, torch.zeros_like(ring_val))
    if W > 0:
        C = mags.shape[0]
        j_lo = torch.argmax(app.to(i32), dim=1).to(i32)
        is_app = (slot >= base_n[:, None]) \
            & (slot < (base_n + n_app)[:, None])
        start = R + j_lo - base_n                     # in [0, R + W - 1]
        idx = (start[:, None].long()
               + torch.arange(R, device=dev)[None, :])
        val_pad = torch.cat([torch.zeros((C, R), dtype=torch.float32,
                                         device=dev), mags,
                             torch.zeros((C, R), dtype=torch.float32,
                                         device=dev)], dim=1)
        pos_pad = torch.cat([torch.full((R,), _FLOOR, dtype=i32, device=dev),
                             col_pos,
                             torch.full((R,), _FLOOR, dtype=i32, device=dev)])
        pos1 = torch.where(is_app, pos_pad[idx], pos1)
        val1 = torch.where(is_app, torch.take_along_dim(val_pad, idx, dim=1),
                           val1)
    ring_n1 = torch.clamp(base_n + n_app, max=R).to(i32)

    new = {"mag_lp": mag_lp1, "mag_nf": mag_nf1, "nfcnt": nfcnt1,
           "ring_pos": pos1, "ring_val": val1, "ring_n": ring_n1}
    return nf_read, new


def mag(pwr3: torch.Tensor) -> torch.Tensor:
    """Device magnitude with the same f16 rounding the host-gated drain
    applies (core/pipeline.mag16), so both modes track identical
    inputs."""
    return torch.sqrt(pwr3).to(torch.float16).to(torch.float32)


def _finish_state(g, dec, nf_new) -> dict:
    return {"busy_until": g["busy_until"],
            "next_det_min": g["next_det_min"],
            "hold": dec["hold"], "hold_active": dec["hold_active"],
            **nf_new}


def _out(g, nf_read, state) -> dict:
    return {"verdicts": g["verdicts"], "nf_read": nf_read,
            "deferred_at": g["deferred_at"],
            **{k: state[k] for k in (
                "busy_until", "next_det_min", "hold", "hold_active",
                "mag_lp", "mag_nf", "nfcnt", "ring_n")}}


def gate_nf_single(count, det_idx, sync_idx, sym_valid, dphi, l2_row,
                   hdr_rows, bits_rows, pwr3, nf_base_rel: int, delta,
                   state: dict, freqs, max_ppm: float):
    """Full device gate + NF step for the single-device pipeline.

    All index args/state are decimated-sample indices relative to the
    current block's base; ``delta`` (an int, or a 0-dim tensor as
    :func:`_rebase` takes it) rebases the carried state from the
    previous base, ``pwr3`` (C, W) holds the powers of the block's
    fresh samples nf_base_rel, nf_base_rel + 3, ...  Returns (out,
    new_state) where ``out`` is what the host drain fetches.
    """
    st = _rebase(state, delta)
    W = pwr3.shape[1]
    end_rel = int(nf_base_rel) + 3 * W
    sync_idx = sync_idx.to(torch.int32).contiguous()
    g, bits, dec = _gate(count, det_idx, sync_idx, sym_valid, dphi, l2_row,
                         hdr_rows, bits_rows, st, freqs, max_ppm, False,
                         end_rel)
    col_pos = int(nf_base_rel) + 3 * torch.arange(W, dtype=torch.int32,
                                                  device=pwr3.device)
    nf_read, nf_new = _nf_track(g["verdicts"], sync_idx, bits, mag(pwr3),
                                col_pos, st, dec, g["deferred_at"], end_rel)
    new_state = _finish_state(g, dec, nf_new)
    return _out(g, nf_read, new_state), new_state


def mesh_columns(W: int, Tn: int, Ml: int, prepend_dec: int,
                 col_from=None) -> tuple[int, int, np.ndarray | None]:
    """The magnitude columns of a mesh block that the tracker consumes.

    Time shard s's column jj (X = W // Tn columns a shard) lies at data
    position s*Ml + 3*jj; since 3*(X - 1) < Ml the positions increase,
    so the columns the JAX package drops, those re-covering prepended
    samples (positions < ``prepend_dec``), are a prefix, whose length
    ``n_drop`` is a host integer.  Returns ``(n0, base_rel, first)``:
    the tracker sees the block's columns from ``n0`` on (n_drop unless
    ``col_from`` asks for earlier ones), column j at position
    base_rel + 3*(j - n0) (the JAX package's rank-based positions: column
    n_drop sits at prepend_dec).  ``col_from`` (C,), where given, is each
    channel's first data position to consume (past the block: none);
    ``first`` (C,) is then the index, counted from n0, of each channel's
    first consumed column, else None (every channel starts at n0)."""
    X = max(W // Tn, 1)
    j = np.arange(W)
    pos = (j // X) * Ml + 3 * (j % X)
    n_drop = int(np.searchsorted(pos, prepend_dec))
    if col_from is None:
        return n_drop, prepend_dec, None
    first = np.searchsorted(pos, np.asarray(col_from, np.int64))
    n0 = int(first.min())
    return n0, prepend_dec - 3 * (n_drop - n0), first - n0


def count_before(count, det_idx, stops):
    """Per channel, how many of the first ``count`` (time-ordered) slots
    of ``det_idx`` lie before ``stops`` (numpy or torch alike)."""
    W = det_idx.shape[1]
    if isinstance(det_idx, torch.Tensor):
        slot = torch.arange(W, device=det_idx.device)[None, :]
        return ((slot < count[:, None]) & (det_idx < stops[:, None])) \
            .sum(dim=1).to(torch.int32)
    slot = np.arange(W)[None, :]
    return ((slot < count[:, None]) & (det_idx < stops[:, None])) \
        .sum(axis=1).astype(np.int32)


def gate_nf_mesh(count_tc, det, sync, dphi, pherr, sym_valid, inv_flat,
                 hdr_rows, bits_rows, pwr3, Ml: int, prepend_dec: int,
                 delta: int, state: dict, freqs, max_ppm: float,
                 stops=None, col_from=None):
    """Mesh-mode gate + NF step: the device-side candidate merge (a
    stable sort of each channel's (Tn*K) slots, valid ones first, in
    time order) followed by the single-device gate and tracker.

    Candidate arrays are (Tn, C, K) as the sharded step gives them
    (indices relative to the block's base); ``pwr3`` is (C, Tn*X).
    ``inv_flat`` maps flat slot (t*C + c)*K + k to its L2 row, or is
    None when the L2 batch was not compacted.  ``prepend_dec`` > 0 on
    blocks that re-read a deferred burst: the columns re-covering the
    prepended samples are dropped (a prefix, see :func:`mesh_columns`)
    and the rest take the JAX package's rank-based positions
    prepend_dec + 3*rank, so G1 and G2 run as in the single-device step
    on the kept columns.

    ``stops`` (C,) int32, where given, leaves each channel's candidates
    at or after its stop unseen, and ``col_from`` (C,) sets where each
    channel's tracker columns begin (see :func:`mesh_columns`; both from
    core/mesh_pipeline.py: the JAX package has neither).

    Returns (out, merged, new_state): ``merged`` carries the merged
    per-channel candidate fields the host drain needs for metadata.
    """
    Tn, C, K = det.shape
    dev = det.device
    i32 = torch.int32
    cnt = torch.clamp(count_tc, max=K)
    valid = torch.arange(K, dtype=i32, device=dev)[None, None, :] \
        < cnt[:, :, None]

    def tr(a):
        return a.movedim(0, 1).reshape(C, Tn * K)

    order = torch.argsort((~tr(valid)).to(i32), dim=1, stable=True)

    def take(a):
        return torch.take_along_dim(tr(a), order, dim=1).contiguous()

    flat = ((torch.arange(Tn, dtype=i32, device=dev)[:, None, None] * C
             + torch.arange(C, dtype=i32, device=dev)[None, :, None]) * K
            + torch.arange(K, dtype=i32, device=dev)[None, None, :])
    flat_m = take(flat)
    row_m = flat_m if inv_flat is None else \
        inv_flat[flat_m.clamp(0, inv_flat.shape[0] - 1).long()].to(i32)
    merged = {"count": cnt.sum(dim=0).to(i32), "det_idx": take(det),
              "sync_idx": take(sync), "dphi": take(dphi),
              "pherr": take(pherr), "sym_valid": take(sym_valid),
              "l2_row": row_m}
    if stops is not None:
        merged["count"] = count_before(merged["count"], merged["det_idx"],
                                       stops)
    n0, base_rel, first = mesh_columns(pwr3.shape[1], Tn, int(Ml),
                                       int(prepend_dec), col_from)
    # gate_nf_single's step on the kept columns
    st = _rebase(state, delta)
    mags = mag(pwr3[:, n0:])
    W = mags.shape[1]
    end_rel = base_rel + 3 * W
    sync_m = merged["sync_idx"].to(i32).contiguous()
    g, bits, dec = _gate(merged["count"], merged["det_idx"], sync_m,
                         merged["sym_valid"], merged["dphi"], row_m,
                         hdr_rows, bits_rows, st, freqs, max_ppm, False,
                         end_rel)
    track_st = st
    if first is not None:
        # each channel's first consumed column bounds what the tracker
        # reads (G1's ``low``) and what the ring appends (past the busy
        # frontier)
        col_low = torch.as_tensor((base_rel + 3 * first).astype(np.int32),
                                  device=dev)
        dec["low"] = torch.maximum(dec["low"], col_low)
        track_st = {**st, "busy_until": torch.maximum(st["busy_until"],
                                                      col_low)}
    col_pos = base_rel + 3 * torch.arange(W, dtype=i32, device=dev)
    nf_read, nf_new = _nf_track(g["verdicts"], sync_m, bits, mags, col_pos,
                                track_st, dec, g["deferred_at"], end_rel)
    new_state = _finish_state(g, dec, nf_new)
    return _out(g, nf_read, new_state), merged, new_state


def gate_only(count, det_idx, sync_idx, sym_valid, dphi, l2_row, hdr_rows,
              bits_rows, delta: int, state: dict, freqs, max_ppm: float,
              eof: bool = True):
    """Gate without fresh magnitude columns (the EOF flush: finish()
    re-demodulates the carried halo; a resolution can still release the
    hold and replay the ring)."""
    st = _rebase(state, delta)
    sync_idx = sync_idx.to(torch.int32).contiguous()
    g, bits, dec = _gate(count, det_idx, sync_idx, sym_valid, dphi, l2_row,
                         hdr_rows, bits_rows, st, freqs, max_ppm, eof,
                         _FLOOR)
    C = det_idx.shape[0]
    dev = det_idx.device
    nf_read, nf_new = _nf_track(
        g["verdicts"], sync_idx, bits,
        torch.zeros((C, 0), dtype=torch.float32, device=dev),
        torch.zeros((0,), dtype=torch.int32, device=dev), st, dec,
        g["deferred_at"], _FLOOR)
    new_state = _finish_state(g, dec, nf_new)
    return _out(g, nf_read, new_state), new_state
