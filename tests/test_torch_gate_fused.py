"""Kernel G2 (``nf_track``, the fused noise-floor tracker), checked on a
host with no nvcc.

* Its plain version, ``gate_kernel.nf_track_plain``, against the JAX
  package's ``nf_gate._nf_track`` up to its floor outputs (nf_read,
  mag_lp, mag_nf, nfcnt) on numpy-seeded grids that reach a ring
  replay through a filter, persisting holds, no floor update, W = 0
  with a non-empty ring and inverted windows (negative bit counts).
  nfcnt exact; floats within rtol 1e-5, atol 1e-7.
* A numpy model of the kernel's statements (its tiles of kRun columns
  a thread, the fold of a run into an affine map, the warp-shuffle
  scan, the scan of the warp totals, the carry from tile to tile, the
  replay with floor updates where the running count reaches a multiple
  of 1000, the binary-search read-out) against the plain version:
  the count and the crossing columns exact, floats within rtol 1e-5,
  atol 1e-7.  The model's constants are parsed from ``csrc/gate.cu``
  and MODELLED_STATEMENTS pins its arithmetic to the source, so a
  change of the kernel's order fails here until the model follows it.
  This tests the model, not the compiled kernel (chip_smoke.py and
  tests/test_torch_cuda.py do that on the card).
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu.constants import MAG_LP, NF_LP
from dumpvdl2_tpu.core import nf_gate as jnf
from dumpvdl2_tpu_torch.core import gate_kernel

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = (REPO / "dumpvdl2_tpu_torch" / "csrc" / "gate.cu").read_text()
INT_MAX = 2 ** 31 - 1
F32 = np.float32


def _const(name):
    return int(re.search(r"constexpr int " + name + r" = (\d+);",
                         SOURCE).group(1))


THREADS = _const("kTrackThreads")
RUN = _const("kRun")
EVERY = _const("kNfEvery")

# The kernel's statements the model below repeats, in its order.
MODELLED_STATEMENTS = (
    "if (e < tl.len && rpos_row[tl.first + e] >= rfilt)",
    "if (e0 + i < tl.len && j >= lo && j < hi && ca - cb <= 0)",
    "S = __fmul_rn(S, kMagA);",
    "O = __fadd_rn(__fmul_rn(O, kMagA), __fmul_rn(cur[e0 + i], kMagB));",
    "O = __fadd_rn(__fmul_rn(o_up, S), O);",
    "S = __fmul_rn(s_up, S);",
    "po = __fadd_rn(__fmul_rn(po, w_s[q]), w_o[q]);",
    "ps = __fmul_rn(ps, w_s[q]);",
    "const float in_s = __fmul_rn(ps, es);",
    "const float in_o = __fadd_rn(__fmul_rn(po, es), eo);",
    "float y = __fadd_rn(__fmul_rn(in_s, carry_y), in_o);",
    "y = __fadd_rn(__fmul_rn(y, kMagA), __fmul_rn(cur[e0 + i], kMagB));",
    "const int m = (nf_base + seen) / kNfEvery - 1;",
    "nf = __fadd_rn(__fadd_rn(__fmul_rn(kNfA, nf), __fmul_rn(kNfB, mn)),",
    "const int r = lower_bound(s_jc, ncross, s_bound[k]);",
)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()

# (C, W, K, R, seed, track_grid options): each reaches what its name says
GRIDS = {
    "block": (6, 3000, 12, 64, 1, {}),
    "ring replay": (6, 2500, 12, 3000, 2, {"replay": 0.8}),
    "persisting holds": (6, 2500, 12, 3000, 3, {"persist": 0.5,
                                                "replay": 0.4}),
    "no crossings": (6, 300, 12, 64, 4, {"nfcnt_max": 400}),
    "W = 0, ring replay": (6, 0, 12, 2500, 5, {"replay": 1.0}),
    "inverted windows": (6, 3000, 12, 64, 6, {"negative_bits": True}),
}


def _wrap(x):
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31) \
        .astype(np.int32)


def _plain(grid):
    args = SMOKE.track_args(grid, "cpu")
    return [x.numpy() for x in gate_kernel.nf_track_plain(*args)]


def _reaches(name, grid, jc):
    """The grid reaches the case it is named for."""
    R = grid["ring_pos"].shape[1]
    crossings = int((jc >= 0).sum())
    if name == "no crossings":
        return crossings == 0
    if name in ("ring replay", "W = 0, ring replay"):
        # a floor update inside the replayed ring
        return bool(((jc >= 0) & (jc < R)).any())
    if name == "persisting holds":
        return bool(grid["persist"].any()) and crossings > 0
    if name == "inverted windows":
        return bool(((grid["verdicts"] == 5) | (grid["verdicts"] == 8))
                    .any()) and crossings > 0
    return crossings > 0


@pytest.mark.parametrize("name", list(GRIDS))
def test_nf_track_plain_matches_jax(name):
    C, W, K, R, seed, kw = GRIDS[name]
    grid = SMOKE.track_grid(C, W, K, R, seed, **kw)
    state = {"busy_until": grid["busy0"], "mag_lp": grid["mag_lp0"],
             "mag_nf": grid["mag_nf0"], "nfcnt": grid["nfcnt0"],
             "ring_pos": grid["ring_pos"], "ring_val": grid["ring_val"],
             "ring_n": grid["ring_n"]}
    dec = {k: grid[k] for k in ("released", "persist", "drop_end",
                                "ring_filter")}
    j_read, j_new = jnf._nf_track(
        grid["verdicts"], grid["sync_idx"], grid["bits"], grid["mags"],
        grid["col_pos"], None, state, dec, grid["deferred"],
        np.int32(grid["end_rel"]))
    lp1, nf1, cnt1, read, jc = _plain(grid)
    assert _reaches(name, grid, jc), name
    np.testing.assert_array_equal(cnt1, np.asarray(j_new["nfcnt"]))
    for got, want, what in ((lp1, j_new["mag_lp"], "mag_lp"),
                            (nf1, j_new["mag_nf"], "mag_nf"),
                            (read, j_read, "nf_read")):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-7, err_msg=f"{name} {what}")


def kernel_model(mags, col_pos, verdicts, sync, bits, low, f_track,
                 released, ring_filter, ring_pos, ring_val, ring_n, lp0,
                 nf0, nfcnt0):
    """csrc/gate.cu's nf_track_kernel, statement for statement, in
    numpy float32 (every product and sum rounded, no fused multiply-
    add, as the file builds with --fmad=false)."""
    C, W = mags.shape
    K = verdicts.shape[1]
    R = ring_pos.shape[1]
    tile = THREADS * RUN
    cap = (R + W) // EVERY + 1
    A, B = F32(MAG_LP), F32(1.0 - MAG_LP)
    NA, NB, NE = F32(NF_LP), F32(1.0 - NF_LP), F32(1e-4)
    out_lp = np.zeros(C, F32)
    out_nf = np.zeros(C, F32)
    out_cnt = np.zeros(C, np.int32)
    out_read = np.zeros((C, K), F32)
    out_jc = np.full((C, cap), -1, np.int32)
    e = np.arange(THREADS)[:, None] * RUN + np.arange(RUN)[None, :]
    lane_ge = {d: np.arange(32) >= d for d in (1, 2, 4, 8, 16)}
    for c in range(C):
        # windows and bounds (one thread a slot, binary searches)
        v = verdicts[c]
        rej = v == 5
        win = rej | (v == 8)
        total = -(-bits[c].astype(np.int64) // 3)
        we = _wrap(sync[c].astype(np.int64) + np.where(rej, 90, total * 10))
        a = np.searchsorted(col_pos, sync[c], "left")
        b = np.searchsorted(col_pos, we, "left")
        s_a = np.sort(np.where(win, a, INT_MAX))
        s_b = np.sort(np.where(win, b, INT_MAX))
        bound = R + a
        lo = np.searchsorted(col_pos, low[c], "left")
        hi = np.searchsorted(col_pos, f_track[c], "left")
        n_ring = int(ring_n[c]) if released[c] else 0
        tiles = [(True, f) for f in range(0, n_ring, tile)] \
            + [(False, f) for f in range(0, W, tile)]
        carry_y, carry_n = F32(lp0[c]), 0
        s_y = np.zeros(cap, F32)
        s_jc = np.zeros(cap, np.int64)
        for ring, first in tiles:
            length = min(tile, (n_ring if ring else W) - first)
            ok = e < length
            idx = first + np.minimum(e, length - 1)
            if ring:
                vals = ring_val[c, idx]
                tracked = ok & (ring_pos[c, idx] >= ring_filter[c])
                col = idx
            else:
                vals = mags[c, idx]
                j = first + e
                count = np.searchsorted(s_a, j, "right") \
                    - np.searchsorted(s_b, j, "right")
                tracked = ok & (j >= lo) & (j < hi) & (count <= 0)
                col = R + j
            off = np.where(tracked, vals * B, F32(0))
            # fold each thread's run
            S = np.ones(THREADS, F32)
            O = np.zeros(THREADS, F32)
            n = np.zeros(THREADS, np.int64)
            for i in range(RUN):
                t = tracked[:, i]
                S = np.where(t, S * A, S)
                O = np.where(t, O * A + off[:, i], O)
                n = n + t
            # inclusive warp scan (shuffle up by d)
            S, O, n = (x.reshape(-1, 32) for x in (S, O, n))
            for d in (1, 2, 4, 8, 16):
                s_up, o_up, n_up = (np.roll(x, d, axis=1) for x in (S, O, n))
                m = lane_ge[d]
                S, O, n = (np.where(m, s_up * S, S),
                           np.where(m, o_up * S + O, O),
                           np.where(m, n + n_up, n))
            w_s, w_o, w_n = S[:, 31], O[:, 31], n[:, 31]
            es, eo, en = (np.roll(x, 1, axis=1) for x in (S, O, n))
            es[:, 0], eo[:, 0], en[:, 0] = 1, 0, 0
            # the warps before each warp, in order
            n_w = THREADS // 32
            ps, po, pn = np.ones(n_w, F32), np.zeros(n_w, F32), \
                np.zeros(n_w, np.int64)
            for w in range(n_w):
                for q in range(w):
                    po[w] = po[w] * w_s[q] + w_o[q]
                    ps[w] = ps[w] * w_s[q]
                    pn[w] += w_n[q]
            in_s = ps[:, None] * es
            in_o = po[:, None] * es + eo
            y = (in_s * carry_y + in_o).reshape(-1)
            seen = (carry_n + pn[:, None] + en).reshape(-1)
            # replay; floor updates where the running count hits 1000 k
            for i in range(RUN):
                t = tracked[:, i]
                y = np.where(t, y * A + off[:, i], y)
                seen = seen + t
                for th in np.nonzero(t & ((nfcnt0[c] + seen) % EVERY
                                          == 0))[0]:
                    mm = (nfcnt0[c] + seen[th]) // EVERY - 1
                    if mm < cap:
                        s_y[mm], s_jc[mm] = y[th], col[th, i]
            carry_y, carry_n = y[-1], int(seen[-1])
        total = int(nfcnt0[c]) + carry_n
        ncross = min(total // EVERY, cap)
        nf = F32(nf0[c])
        for mm in range(ncross):
            yv = s_y[mm]
            mn = yv if (yv < nf or yv != yv) else nf
            nf = (NA * nf + NB * mn) + NE
            s_y[mm] = nf
        out_lp[c], out_nf[c], out_cnt[c] = carry_y, nf, total % EVERY
        out_jc[c, :ncross] = s_jc[:ncross]
        r = np.searchsorted(s_jc[:ncross], bound, "left")
        out_read[c] = np.where(r > 0, s_y[np.maximum(r - 1, 0)], F32(nf0[c]))
    return out_lp, out_nf, out_cnt, out_read, out_jc


def test_source_has_modelled_statements():
    for stmt in MODELLED_STATEMENTS:
        assert stmt in SOURCE, stmt
    assert re.search(r"constexpr int kTile = kTrackThreads \* kRun;", SOURCE)
    assert THREADS % 32 == 0 and RUN % 2 == 1 and RUN <= 64
    assert EVERY == gate_kernel.NF_EVERY


# (C, W, K, R, seed, options): several tiles, several ring tiles, one
# short tile, W = 0, persisting holds
MODEL_GRIDS = {
    "three block tiles": (3, 2 * THREADS * RUN + 500, 20, 64, 21, {}),
    "two ring tiles then block": (3, 5000, 20, THREADS * RUN + 900, 22,
                                  {"replay": 1.0}),
    "short block": (4, 100, 5, 8, 23, {"replay": 0.5}),
    "W = 0": (3, 0, 6, 3000, 26, {"replay": 1.0}),
    "persisting holds, inverted windows": (4, 6000, 16, 2000, 25,
                                           {"persist": 0.5, "replay": 0.5,
                                            "negative_bits": True}),
}


@pytest.mark.parametrize("name", list(MODEL_GRIDS))
def test_kernel_model_matches_plain(name):
    C, W, K, R, seed, kw = MODEL_GRIDS[name]
    grid = SMOKE.track_grid(C, W, K, R, seed, **kw)
    args = [x.numpy() for x in SMOKE.track_args(grid, "cpu")]
    got = kernel_model(*args)
    want = _plain(grid)
    assert int((want[4] >= 0).sum()) > 0, name
    for what, g, w in zip(SMOKE.TRACK_OUT, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        if what in ("nfcnt1", "jc"):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {what}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {what}")


def test_nf_track_wrapper_shapes_on_cpu():
    """nf_track on CPU tensors runs the plain version: outputs of the
    documented shapes, and the crossing columns ascend."""
    grid = SMOKE.track_grid(5, 4000, 7, 3000, 41, replay=0.6)
    args = SMOKE.track_args(grid, "cpu")
    lp1, nf1, cnt1, read, jc = gate_kernel.nf_track(*args)
    cap = (3000 + 4000) // 1000 + 1
    assert lp1.shape == nf1.shape == cnt1.shape == (5,)
    assert read.shape == (5, 7) and jc.shape == (5, cap)
    assert torch.all((cnt1 >= 0) & (cnt1 < 1000))
    for row in jc.numpy():
        live = row[row >= 0]
        assert np.all(np.diff(live) > 0)
        assert np.all(row[len(live):] == -1)
