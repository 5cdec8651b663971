"""Sharded DSP step: channel x time mesh with halo exchange.

Port of ``dumpvdl2_tpu/parallel/sharded.py``.  The JAX package runs the
per-shard body under ``shard_map`` and moves halos with ``ppermute``;
here one process drives every shard (single controller) and each
``ppermute`` leg becomes an explicit ``.to(neighbour_device,
non_blocking=True)``.  Three neighbour exchanges a block:

  1. raw tail   (2, T-1)        shard t -> t+1   FIR carry samples
  2. dec tail   (2, Cl, H)      shard t -> t+1   sync-metric lookback
  3. dec head   (2, Cl, F)      shard t -> t-1   forward burst window
                                (several hops when F > Ml)

Exchange 1 sends raw (pre-mix) samples: the band-pass channelizer folds
the NCO into its taps, so raw history is all a shard needs.  The
wrap-around leg of the +1 shifts (shard Tn-1 -> shard 0) is the carried
state the next block's leading shard consumes.

SPMD runs every shard's channelizer before any halo moves; the loop
keeps that order: phase A channelizes every shard, phase B builds the
halos and detects.  Kernel K1 runs once per shard a block, on ragged
(Cl, H + Ml + F) planes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import SPS, SYNC_THRESHOLD
from ..dsp.demod import Candidates, find_and_slice
from ..dsp import pfb_kernel
from ..dsp.frontend import bandpass_channelize
from .mesh import CHANNEL_AXIS, TIME_AXIS, Mesh

# Sync metric lookback is 150 decimated samples + 2 for the minimum
# test, rounded up.
BACK_HALO = 160
_MASK24 = 0xFFFFFF


class ShardedState(NamedTuple):
    """Carried state: what time shard 0 of the next block receives over
    the wrap-around leg, one entry per channel shard c (on the device of
    shard (c, 0))."""
    raw_tail: tuple      # (2, T-1) raw planar tail of the previous block
    dec_tail: tuple      # (2, Cl, H) decimated tail of the previous block
    n0: int              # global raw index of the next block, mod 2^24


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x.to(dev, non_blocking=True)


def make_sharded_step(mesh: Mesh, *, oversample: int, fwd_halo: int,
                      threshold: float = SYNC_THRESHOLD,
                      max_candidates: int = 16, max_symbols: int = 1024):
    """Build the sharded per-block step over ``mesh``.

    Returns ``step(iq, taps, dphi, state) -> (Candidates, pwr3, state)``
    where ``iq`` is the full (2, N) raw block (N divisible by
    time_shards*oversample; a tensor on any device or a numpy array),
    ``taps`` the (T,) FIR taps, ``dphi`` the full (C,) int64 channel
    set.  The results lie on ``mesh.home``: Candidates of shapes (Tn, C,
    K[, S]) with indices relative to the block's first fresh decimated
    sample (halo hits of time shard 0 come out negative, as the
    single-device halo's do), and ``pwr3`` (C, Tn*X), the power of every
    3rd fresh decimated sample of each time shard (X = ceil(Ml/3)).
    """
    Cn, Tn = mesh.shape[CHANNEL_AXIS], mesh.shape[TIME_AXIS]
    grid, home = mesh.grid, mesh.home
    H, F = BACK_HALO, fwd_halo
    K, S = max_candidates, max_symbols
    placed = {}

    def place(taps, dphi):
        """Each shard's taps, channel slice and filter bank plan on its
        device, made for the first block and kept while the step is
        given these very tensors (held here, so that no other tensor
        takes their identity; an in-place change bumps the version)."""
        key = (id(taps), taps._version, id(dphi), dphi._version)
        if placed.get("key") != key:
            C = dphi.shape[0]
            Cl = C // Cn
            shards = {}
            for c in range(Cn):
                for t in range(Tn):
                    dev = grid[c][t]
                    tp = _to(taps, dev)
                    dp = _to(dphi[c * Cl:(c + 1) * Cl], dev)
                    shards[c, t] = (tp, dp,
                                    pfb_kernel.plan_for(tp, dp, oversample))
            placed.clear()
            placed.update(key=key, held=(taps, dphi), shards=shards)
        return placed["shards"]

    def step(iq, taps, dphi, state: ShardedState):
        iq = torch.as_tensor(iq, dtype=torch.float32)
        N = iq.shape[1]
        Nl = N // Tn
        Ml = Nl // oversample
        T = taps.shape[0]
        C = dphi.shape[0]
        Cl = C // Cn
        chunks = [iq[:, t * Nl:(t + 1) * Nl] for t in range(Tn)]
        shards = place(taps, dphi)

        # -- phase A: every shard channelizes its span; exchange 1 ------
        dec = [[None] * Tn for _ in range(Cn)]
        for c in range(Cn):
            for t in range(Tn):
                dev = grid[c][t]
                local = _to(chunks[t], dev)
                prefix = state.raw_tail[c] if t == 0 else \
                    _to(chunks[t - 1][:, Nl - (T - 1):], dev)
                tp, dp, plan = shards[c, t]
                dec[c][t], _ = bandpass_channelize(
                    local, tp, dp, (state.n0 + t * Nl) & _MASK24,
                    _to(prefix, dev), oversample, plan)

        # -- phase B: exchanges 2 and 3, detection ----------------------
        cands = [[None] * Tn for _ in range(Cn)]
        pwr3 = [[None] * Tn for _ in range(Cn)]
        hops = -(-F // Ml)
        for c in range(Cn):
            for t in range(Tn):
                dev = grid[c][t]
                back = _to(state.dec_tail[c], dev) if t == 0 else \
                    _to(dec[c][t - 1][:, :, Ml - H:], dev)
                # the forward halo may span several shards when shards
                # are shorter than a max-length burst (F > Ml): hop h
                # brings shard t+h's samples, zeros past the last shard
                parts, remaining = [], F
                for h in range(1, hops + 1):
                    take = min(Ml, remaining)
                    if t + h < Tn:
                        parts.append(_to(dec[c][t + h][:, :, :take], dev))
                    else:
                        parts.append(torch.zeros((2, Cl, take),
                                                 dtype=torch.float32,
                                                 device=dev))
                    remaining -= take
                block = torch.cat([back, dec[c][t]] + parts, dim=2)
                cd = find_and_slice(block, threshold, K, S, detect_lo=H,
                                    detect_hi=H + Ml)
                # samples past the last shard's fresh region are zero
                # pad, not future data: cap sym_valid at the shard's
                # true data horizon so the host defers bursts that run
                # off the block end
                avail_fwd = min(F, (Tn - 1 - t) * Ml)
                cap = torch.clamp(torch.div(H + Ml + avail_fwd - 1
                                            - cd.sync_idx, SPS,
                                            rounding_mode="floor"), 0, S)
                # rebase to block-global decimated indices
                base = t * Ml - H

                def fix(ix):
                    return torch.where(ix >= 0, ix + base, ix)

                cands[c][t] = cd._replace(
                    sym_valid=torch.minimum(cd.sym_valid,
                                            cap.to(torch.int32)),
                    det_idx=fix(cd.det_idx), sync_idx=fix(cd.sync_idx))
                d = dec[c][t]
                pwr3[c][t] = d[0, :, ::3] ** 2 + d[1, :, ::3] ** 2

        # -- gather onto the home device: (Tn, C, ...) and (C, Tn*X) -----
        out = Candidates(*(torch.stack([
            torch.cat([_to(getattr(cands[c][t], f), home)
                       for c in range(Cn)]) for t in range(Tn)])
            for f in Candidates._fields))
        p3 = torch.cat([torch.cat([_to(pwr3[c][t], home) for t in range(Tn)],
                                  dim=1) for c in range(Cn)])
        # the wrap-around legs: shard Tn-1's tails go to shard 0
        new_state = ShardedState(
            raw_tail=tuple(_to(chunks[Tn - 1][:, Nl - (T - 1):].contiguous(),
                               grid[c][0]) for c in range(Cn)),
            dec_tail=tuple(_to(dec[c][Tn - 1][:, :, Ml - H:].contiguous(),
                               grid[c][0]) for c in range(Cn)),
            n0=(state.n0 + N) & _MASK24)
        return out, p3, new_state

    return step


def init_sharded_state(mesh: Mesh, n_channels: int, n_taps: int
                       ) -> ShardedState:
    """Zero carried state, laid out on the mesh."""
    Cn = mesh.shape[CHANNEL_AXIS]
    Cl = n_channels // Cn
    return ShardedState(
        raw_tail=tuple(torch.zeros((2, n_taps - 1), dtype=torch.float32,
                                   device=mesh.grid[c][0])
                       for c in range(Cn)),
        dec_tail=tuple(torch.zeros((2, Cl, BACK_HALO), dtype=torch.float32,
                                   device=mesh.grid[c][0])
                       for c in range(Cn)),
        n0=0)
