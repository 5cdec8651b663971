"""Device-side candidate gating: the host decision loop over K slots.

Port of ``dumpvdl2_tpu/core/gate_scan.py``.  For each channel the
candidates of one block are decided in time order, as the host loop
``VDL2Pipeline._process_candidates`` decides them (reference analog:
the DM_* / DEC_* state machine, demod.c:229-285 + decode.c:198-258):

* a candidate inside the channel's busy window or before the
  next-detection watermark is skipped;
* too few symbols for a header => DEFER (stop the channel's block)
  unless EOF, where the candidate is abandoned;
* header-FEC failure => 9-symbol busy window, move on;
* not enough symbols for the full burst => DEFER unless EOF
  (abandoned as eof-truncated);
* |ppm| beyond --max-ppm => rejected;
* acceptance claims the full burst length as the busy window.

:func:`gate_scan` is the plain version: vectorised over channels, a
Python loop over the K slots.  On the gated main path the same
decisions run in kernel G1 (``csrc/gate.cu``, see core/gate_kernel.py),
one thread per channel; this function is its plain twin.  Indices are
int32 and wrap as JAX's do; callers pass block-relative indices.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import HEADER_LEN, SPS

# verdict codes (int8)
V_EMPTY = 0        # slot >= count: no candidate
V_SKIP = 1         # inside busy window / before next_det_min
V_L2_OVERFLOW = 2  # compacted L2 batch had no row (l2_row < 0)
V_DEFER = 3        # header doesn't fit the available symbols: deferred
V_DEFER_DATA = 10  # header ok but burst tail missing: deferred
                   # (counts demod.sync.good, unlike V_DEFER)
V_EOF_SHORT = 4    # same at EOF: abandoned
V_HDR_REJECT = 5   # header FEC rejected
V_EOF_TRUNC = 6    # burst truncated at EOF: abandoned
V_PPM_REJECT = 7   # --max-ppm gate
V_ACCEPT = 8       # burst decoded; busy window claimed
V_UNPROCESSED = 9  # after a deferral stopped the channel

_MIN_HDR_SYMS = (HEADER_LEN + 2) // 3 + 1


def ceil_syms(bits: torch.Tensor) -> torch.Tensor:
    """Symbols of a burst of ``bits`` bits: ``-(-bits // 3)`` with
    floor division, as the JAX package computes it."""
    return -(-bits // 3)


def gate_scan(count, det_idx, sync_idx, sym_valid, hdr_ok, bits_consumed,
              ppm, l2_row, busy_until0, next_det_min0, base: int,
              max_ppm: float, eof: bool = False) -> dict:
    """Run the gating decisions for one block.

    Args (shapes: C channels x K candidate slots, all on one device):
      count (C,) i32; det_idx/sync_idx (C, K) i32 block-local indices
      (-1 pad); sym_valid (C, K) i32; hdr_ok (C, K) bool;
      bits_consumed (C, K) i32; ppm (C, K) f32; l2_row (C, K) i32
      (-1 = overflowed the compacted L2 batch); busy_until0 /
      next_det_min0 (C,) i32 carried state; base: global index of the
      det/sync origin (int32); max_ppm (0 disables the gate).

    Returns dict: verdicts (C, K) i8, busy_until / next_det_min (C,)
    i32 final state, deferred_at (C,) i32 (-1 = none).
    """
    C, K = det_idx.shape
    dev = det_idx.device
    i32 = torch.int32
    base_t = torch.tensor(base, dtype=i32, device=dev)
    max_ppm_t = torch.tensor(max_ppm, dtype=torch.float32, device=dev)
    busy = busy_until0.to(i32)
    nxt = next_det_min0.to(i32)
    stopped = torch.zeros(C, dtype=torch.bool, device=dev)
    deferred = torch.full((C,), -1, dtype=i32, device=dev)
    gate_on = bool(np.float32(max_ppm) > 0)
    verdicts = []
    for k in range(K):
        det_g = base_t + det_idx[:, k].to(i32)
        sp_g = base_t + sync_idx[:, k].to(i32)
        nsyms = sym_valid[:, k]
        is_cand = count > k
        live = is_cand & ~stopped
        skip = live & ((det_g < nxt) | (det_g < busy))
        act = live & ~skip

        overflow = act & (l2_row[:, k] < 0)
        act = act & ~overflow

        short = act & (nsyms < _MIN_HDR_SYMS)
        defer_hdr = short & (not eof)
        eof_short = short & eof
        act = act & ~short

        hdr_rej = act & ~hdr_ok[:, k]
        act = act & ~hdr_rej

        total = ceil_syms(bits_consumed[:, k].to(i32))
        trunc = act & (nsyms < total)
        defer_dat = trunc & (not eof)
        eof_trunc = trunc & eof
        act = act & ~trunc

        ppm_rej = act & gate_on & (torch.abs(ppm[:, k]) > max_ppm_t)
        accept = act & ~ppm_rej

        v = torch.full((C,), V_ACCEPT, dtype=torch.int8, device=dev)
        for mask, code in ((ppm_rej, V_PPM_REJECT), (eof_trunc, V_EOF_TRUNC),
                           (hdr_rej, V_HDR_REJECT), (eof_short, V_EOF_SHORT),
                           (defer_dat, V_DEFER_DATA), (defer_hdr, V_DEFER),
                           (overflow, V_L2_OVERFLOW), (skip, V_SKIP),
                           (stopped, V_UNPROCESSED), (~is_cand, V_EMPTY)):
            v = torch.where(mask, torch.tensor(code, dtype=torch.int8,
                                               device=dev), v)
        verdicts.append(v)

        busy = torch.where(hdr_rej, sp_g + 9 * SPS,
                           torch.where(accept, sp_g + total * SPS, busy))
        deferring = defer_hdr | defer_dat
        advanced = (overflow | eof_short | hdr_rej | eof_trunc | ppm_rej
                    | accept)
        nxt = torch.where(deferring, det_g,
                          torch.where(advanced, det_g + 1, nxt))
        deferred = torch.where(deferring & (deferred < 0), det_g, deferred)
        stopped = stopped | deferring
    v_all = torch.stack(verdicts, dim=1) if K else \
        torch.zeros((C, 0), dtype=torch.int8, device=dev)
    return {"verdicts": v_all, "busy_until": busy, "next_det_min": nxt,
            "deferred_at": deferred}
