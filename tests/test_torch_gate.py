"""PyTorch port vs JAX: the device gate (G1, G2 and the gate step).

* G1's plain version (``gate_kernel.gate_plain`` = ``_slot_inputs`` +
  ``gate_scan`` + ``nf_gate._decisions`` and the tracker's bounds)
  against the JAX package's ``nf_gate._gate`` + ``_decisions`` on
  randomized scenarios shaped like tests/test_gate_scan.py's: eof False
  and True, max_ppm 0 and 5, L2 rows of -1, K = 8 and K = 64, holds
  active, recovered and not.  Every output is an integer and must match
  exactly.
* ``gate_nf_single`` and ``gate_only`` against the JAX package's on
  chains of fabricated blocks that reach every branch of
  ``_decisions``: holds released by a decision, persisting and
  re-covered; ring replay through the ring filter; ring appends and
  ring overflow (a small ring); rebases clamped at _FLOOR.  Verdicts,
  integer state and the ring must match exactly; mag_lp, mag_nf and
  nf_read within rtol 1e-5, atol 1e-7.
* The floor recurrence inside G2's plain version against the JAX
  package's ``nf_step`` scan and per-candidate read-out
  (nf_gate.py:264-286).  G2 as a whole: tests/test_torch_gate_fused.py.
* ``csrc/gate.cu``'s constants equal the plain versions' float32 ones,
  and the CUDA wrappers refuse tensors that are not on a GPU.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu.constants import MAG_LP, NF_LP, SYMBOL_RATE
from dumpvdl2_tpu.core import nf_gate as jnf
from dumpvdl2_tpu_torch.core import gate_kernel, gate_scan
from dumpvdl2_tpu_torch.core import nf_gate as tnf

SRC = Path(gate_kernel.__file__).resolve().parent.parent / "csrc" / "gate.cu"
C = 6
FREQS = np.array([136975000 - 25000 * c for c in range(C)], np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _scenario(rng, K):
    """Candidate slots of one block, as tests/test_gate_scan.py draws
    them, plus the compacted L2 rows they point into."""
    count = rng.integers(0, K + 1, C).astype(np.int32)
    det = np.full((C, K), -1, np.int32)
    sync = np.full((C, K), -1, np.int32)
    for c in range(C):
        n = int(count[c])
        pos = np.sort(rng.choice(np.arange(60, 3000 + 50 * K), size=n,
                                 replace=False)).astype(np.int32)
        if n > 2 and rng.random() < 0.5:      # near-duplicates
            pos[2] = pos[1] + int(rng.integers(0, 2))
            pos = np.sort(pos)
        det[c, :n] = pos
        sync[c, :n] = pos - rng.integers(1, 4, n).astype(np.int32)
    sym_valid = rng.integers(0, 600, (C, K)).astype(np.int32)
    B = C * K
    hdr_rows = rng.random(B) >= 0.3
    total_syms = rng.integers(12, 500, B)
    bits_rows = (3 * total_syms - rng.integers(0, 3, B)).astype(np.int32)
    dphi = rng.normal(0.0, 0.004, (C, K)).astype(np.float32)
    hot = rng.random((C, K)) < 0.15          # |ppm| ~ 8-15
    dphi = np.where(hot, rng.choice([-1.0, 1.0], (C, K))
                    * rng.uniform(0.65, 1.2, (C, K)), dphi).astype(np.float32)
    l2_row = np.where(rng.random((C, K)) < 0.05, -1,
                      rng.permutation(B).reshape(C, K)).astype(np.int32)
    return dict(count=count, det=det, sync=sync, sym_valid=sym_valid,
                dphi=dphi, l2_row=l2_row, hdr_rows=hdr_rows,
                bits_rows=bits_rows,
                busy0=rng.integers(0, 500, C).astype(np.int32),
                next0=rng.integers(0, 500, C).astype(np.int32),
                max_ppm=float(rng.choice([0.0, 5.0])),
                hold=rng.integers(-300, 2000, C).astype(np.int32),
                hold_active=rng.random(C) < 0.6,
                end_rel=int(rng.integers(3000, 9000)))


@pytest.mark.parametrize("K", [8, 64])
@pytest.mark.parametrize("eof", [False, True])
def test_g1_plain_matches_jax_gate(K, eof):
    rng = np.random.default_rng(1000 * K + eof)
    seen = set()
    for trial in range(12):
        sc = _scenario(rng, K)
        slots = (sc["count"], sc["det"], sc["sync"], sc["sym_valid"],
                 sc["dphi"], sc["l2_row"], sc["hdr_rows"], sc["bits_rows"])
        state = {"busy_until": sc["busy0"], "next_det_min": sc["next0"],
                 "hold": sc["hold"], "hold_active": sc["hold_active"]}
        jg, jbits = jnf._gate(*slots, state, FREQS, sc["max_ppm"], eof=eof)
        jdec = jnf._decisions(jg["verdicts"], sc["sync"], jbits, state,
                              jg["deferred_at"])
        jdec["low"] = np.maximum(sc["busy0"], jdec["drop_end"])
        jdec["f_track"] = np.where(
            jdec["persist"], jnf._FLOOR,
            np.where(jg["deferred_at"] >= 0, jg["deferred_at"],
                     sc["end_rel"]))
        tg, tbits, tdec = gate_kernel.gate_plain(
            *(_t(x) for x in slots), _t(sc["busy0"]), _t(sc["next0"]),
            _t(sc["hold"]), _t(sc["hold_active"]), _t(FREQS), sc["max_ppm"],
            eof, sc["end_rel"])
        ctx = f"trial {trial}"
        for k in ("verdicts", "busy_until", "next_det_min", "deferred_at"):
            assert tg[k].dtype == {"verdicts": torch.int8}.get(
                k, torch.int32), k
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]),
                                          err_msg=f"{ctx} {k}")
        np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
        assert set(tdec) == set(jdec) == set(gate_kernel.DEC_INT
                                             + gate_kernel.DEC_BOOL)
        for k in tdec:
            assert tdec[k].dtype == (torch.bool if k in gate_kernel.DEC_BOOL
                                     else torch.int32), k
            np.testing.assert_array_equal(tdec[k].numpy(),
                                          np.asarray(jdec[k]),
                                          err_msg=f"{ctx} {k}")
        seen.update(np.unique(tg["verdicts"].numpy()).tolist())
        decided = np.isin(tg["verdicts"].numpy(),
                          tnf.DECIDED_VERDICTS).any(axis=1)
        rel = tdec["released"].numpy()
        seen.update({"released by a decision"} if (rel & decided).any()
                    else set())
        seen.update({"released, recovered"} if (rel & ~decided).any()
                    else set())
        seen.update({"persist"} if tdec["persist"].numpy().any() else set())
        seen.update({"drop_end"} if (tdec["drop_end"].numpy()
                                     > jnf._FLOOR).any() else set())
    # the scenarios reach the decisions of this mode
    want = {gate_scan.V_EMPTY, gate_scan.V_SKIP, gate_scan.V_L2_OVERFLOW,
            gate_scan.V_HDR_REJECT, gate_scan.V_ACCEPT,
            gate_scan.V_PPM_REJECT}
    want |= ({gate_scan.V_EOF_SHORT, gate_scan.V_EOF_TRUNC} if eof else
             {gate_scan.V_DEFER, gate_scan.V_DEFER_DATA,
              gate_scan.V_UNPROCESSED})
    want |= {"released by a decision", "drop_end"}
    if not eof:
        # at EOF nothing defers: a hold then persists or is re-covered
        # only on a channel without decisions, which these rarely have
        want |= {"persist", "released, recovered"}
    assert want <= seen, sorted(map(str, want - seen))


def test_gate_scan_wraps_int32_like_jax():
    """Indices near 2^31 with a base: int32 sums wrap in both."""
    K = 4
    count = np.full(2, K, np.int32)
    det = np.array([[10, 20, 30, 40], [2**31 - 50, 2**31 - 40,
                                       2**31 - 30, 2**31 - 20]], np.int32)
    sync = det - 2
    sym_valid = np.full((2, K), 600, np.int32)
    hdr_ok = np.array([[True, False, True, True]] * 2)
    bits = np.full((2, K), 30, np.int32)
    ppm = np.zeros((2, K), np.float32)
    l2_row = np.arange(2 * K, dtype=np.int32).reshape(2, K)
    busy = np.array([0, 2**31 - 100], np.int32)
    nxt = np.zeros(2, np.int32)
    from dumpvdl2_tpu.core.gate_scan import gate_scan as jgs
    for base in (0, 2**31 - 25, -7):
        want = jgs(count, det, sync, sym_valid, hdr_ok, bits, ppm, l2_row,
                   busy, nxt, np.int32(base), np.float32(0.0))
        got = gate_scan.gate_scan(
            _t(count), _t(det), _t(sync), _t(sym_valid), _t(hdr_ok),
            _t(bits), _t(ppm), _t(l2_row), _t(busy), _t(nxt), base, 0.0)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------- the gate step
R_SMALL = 48          # ring capacity, small enough to overflow
W = 1500              # magnitude columns a block
KG = 8


def _block(rng, H):
    """One fabricated block: candidates placed over the block's
    decimated span [0, H + 3W), some with too few symbols (deferrals),
    some channels without candidates (holds persist)."""
    count = np.where(rng.random(C) < 0.3, 0,
                     rng.integers(1, KG + 1, C)).astype(np.int32)
    det = np.full((C, KG), -1, np.int32)
    sync = np.full((C, KG), -1, np.int32)
    span = H + 3 * W
    for c in range(C):
        n = int(count[c])
        pos = np.sort(rng.choice(np.arange(20, span), size=n,
                                 replace=False)).astype(np.int32)
        det[c, :n] = pos
        sync[c, :n] = pos - rng.integers(1, 4, n).astype(np.int32)
    sym_valid = np.where(rng.random((C, KG)) < 0.25,
                         rng.integers(0, 12, (C, KG)),
                         rng.integers(12, 300, (C, KG))).astype(np.int32)
    B = C * KG
    hdr_rows = rng.random(B) >= 0.2
    bits_rows = (3 * rng.integers(12, 200, B)
                 - rng.integers(0, 3, B)).astype(np.int32)
    dphi = rng.normal(0.0, 0.004, (C, KG)).astype(np.float32)
    dphi[rng.random((C, KG)) < 0.1] = 1.0
    l2_row = np.where(rng.random((C, KG)) < 0.05, -1,
                      np.arange(B).reshape(C, KG)).astype(np.int32)
    pwr3 = (rng.exponential(0.02, (C, W))
            * np.where(rng.random((C, W)) < 0.01, 400.0, 1.0)) \
        .astype(np.float32)
    return (count, det, sync, sym_valid, dphi, l2_row, hdr_rows,
            bits_rows), pwr3


def _cmp_out(tout, jout, ctx):
    exact = ("verdicts", "deferred_at", "busy_until", "next_det_min",
             "hold", "hold_active", "nfcnt", "ring_n")
    for k in exact:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=f"{ctx} {k}")
    for k in ("mag_lp", "mag_nf", "nf_read"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"{ctx} {k}")


def _cmp_state(ts, js, ctx):
    for k in tnf.STATE_KEYS:
        got, want = ts[k].numpy(), np.asarray(js[k])
        if k in ("mag_lp", "mag_nf"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{ctx} {k}")
        else:       # ring_val holds copied magnitudes: exact
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx} {k}")


def _coverage(st, slots, H, delta, max_ppm, eof_flush):
    """Which _decisions branches this step reaches (port side)."""
    st = tnf._rebase(st, delta)
    g, bits, dec = tnf._gate(*(_t(x) for x in slots), st, _t(FREQS),
                             max_ppm, eof_flush, H + 3 * W)
    any_dec = torch.zeros(C, dtype=torch.bool)
    for v in tnf.DECIDED_VERDICTS:
        any_dec |= (g["verdicts"] == v).any(dim=1)
    rel = dec["released"]
    return {
        "released_by_decision": bool((rel & any_dec).any()),
        "released_recovered": bool((rel & ~any_dec).any()),
        "persist": bool(dec["persist"].any()),
        "replay": bool((rel & (st["ring_n"] > 0)
                        & (dec["ring_filter"] > -(1 << 30))).any()),
        "clamped": bool((st["busy_until"] == tnf._FLOOR).any()),
    }


def test_gate_step_chain_matches_jax():
    """Twelve blocks, then the EOF flush, through both packages with
    the carried state of each chained on its own side."""
    rng = np.random.default_rng(77)
    jst = jnf.init_state(C, ring=R_SMALL)
    tst = tnf.init_state(C, ring=R_SMALL)
    _cmp_state(tst, jst, "init")
    seen = {}
    overflow = append = False
    n_blocks = 12
    for b in range(n_blocks + 1):
        H = int(rng.integers(0, 200))
        # mostly one block on (the hold is re-covered or left behind);
        # twice a jump far enough to clamp every carried index
        delta = int(rng.integers(3 * W - 600, 3 * W + 200))
        if b in (5, 9):
            delta = jnf.MAX_DELTA
        max_ppm = float(rng.choice([0.0, 5.0]))
        slots, pwr3 = _block(rng, H)
        eof_flush = b == n_blocks
        for k, v in _coverage(tst, slots, H, delta, max_ppm,
                              eof_flush).items():
            seen[k] = seen.get(k, False) or v
        ring_n0 = tst["ring_n"].clone()
        if eof_flush:
            jout, jst = jnf.gate_only(*slots, np.int32(delta), jst, FREQS,
                                      np.float32(max_ppm), eof=True)
            tout, tst = tnf.gate_only(*(_t(x) for x in slots), delta, tst,
                                      _t(FREQS), max_ppm, eof=True)
        else:
            jout, jst = jnf.gate_nf_single(
                *slots, pwr3, np.int32(H), np.int32(delta), jst, FREQS,
                np.float32(max_ppm))
            tout, tst = tnf.gate_nf_single(
                *(_t(x) for x in slots), _t(pwr3), H, delta, tst,
                _t(FREQS), max_ppm)
        ctx = f"block {b}"
        _cmp_out(tout, jout, ctx)
        _cmp_state(tst, jst, ctx)
        append |= bool((tst["ring_n"] > ring_n0).any())
        overflow |= bool((tst["ring_n"] == R_SMALL).any())
    seen.update(ring_append=append, ring_overflow=overflow)
    assert all(seen.values()), seen


def test_gate_only_matches_jax_without_eof():
    """gate_only with eof=False (a flush that may still defer)."""
    rng = np.random.default_rng(5)
    jst = jnf.init_state(C, ring=R_SMALL)
    tst = tnf.init_state(C, ring=R_SMALL)
    for b in range(3):
        slots, pwr3 = _block(rng, 100)
        jout, jst = jnf.gate_nf_single(*slots, pwr3, np.int32(100),
                                       np.int32(3 * W), jst, FREQS,
                                       np.float32(0.0))
        tout, tst = tnf.gate_nf_single(*(_t(x) for x in slots), _t(pwr3),
                                       100, 3 * W, tst, _t(FREQS), 0.0)
    slots, _ = _block(rng, 100)
    jout, jst = jnf.gate_only(*slots, np.int32(3 * W), jst, FREQS,
                              np.float32(5.0), eof=False)
    tout, tst = tnf.gate_only(*(_t(x) for x in slots), 3 * W, tst,
                              _t(FREQS), 5.0, eof=False)
    _cmp_out(tout, jout, "flush")
    _cmp_state(tst, jst, "flush")


# ------------------------------------------------------------------- G2
def _jax_nf_floor(y_cross, valid_c, jc, bound, mag_nf0):
    """The JAX package's floor recurrence and read-out,
    nf_gate.py:264-286."""
    cap = y_cross.shape[1]

    def nf_step(nf, xs):
        yv, ok = xs
        upd = jnp.float32(NF_LP) * nf \
            + jnp.float32(1.0 - NF_LP) * jnp.minimum(yv, nf) \
            + jnp.float32(1e-4)
        nf2 = jnp.where(ok, upd, nf)
        return nf2, nf2

    mag_nf1, nf_seq = jax.lax.scan(nf_step, jnp.asarray(mag_nf0),
                                   (jnp.asarray(y_cross).T,
                                    jnp.asarray(valid_c).T))
    nf_seq = nf_seq.T
    r = ((jc[:, None, :] < bound[:, :, None]) & valid_c[:, None, :]) \
        .sum(axis=2)
    nf_read = jnp.where(
        r > 0, jnp.take_along_axis(nf_seq, jnp.clip(r - 1, 0, cap - 1),
                                   axis=1), mag_nf0[:, None])
    return np.asarray(mag_nf1), np.asarray(nf_read)


@pytest.mark.parametrize("cap,K", [(1, 8), (3, 8), (51, 64)])
def test_g2_plain_matches_jax(cap, K):
    rng = np.random.default_rng(cap * 100 + K)
    Cn = 16
    y = rng.exponential(0.05, (Cn, cap)).astype(np.float32)
    y[rng.random((Cn, cap)) < 0.05] = 2.5
    ncross = rng.integers(0, cap + 1, Cn)
    valid = np.arange(cap)[None, :] < ncross[:, None]
    jc = np.sort(rng.integers(0, 1000 * cap + 64, (Cn, cap)), axis=1) \
        .astype(np.int32)
    bound = rng.integers(-5, 1000 * cap + 64, (Cn, K)).astype(np.int32)
    nf0 = rng.uniform(0.01, 2.0, Cn).astype(np.float32)
    want = _jax_nf_floor(y, valid, jc, bound, nf0)
    got = gate_kernel.nf_floor_plain(_t(y), _t(valid), _t(jc), _t(bound),
                                     _t(nf0))
    for g, w, name in zip(got, want, ("mag_nf1", "nf_read")):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0,
                                   err_msg=name)


# ------------------------------------------------------- the CUDA side
def test_gate_cu_constants_equal_plain_float32():
    src = SRC.read_text()

    def const(name):
        m = re.search(rf"{name} = (0x[0-9a-fp.+-]+)f;", src)
        assert m, name
        return np.float32(float.fromhex(m.group(1)))

    assert const("kPpmScale") == gate_kernel.PPM_SCALE == \
        np.float32(SYMBOL_RATE * 1e6 / (2.0 * np.pi))
    assert const("kNfA") == gate_kernel.NF_A == np.float32(NF_LP)
    assert const("kNfB") == gate_kernel.NF_B == np.float32(1.0 - NF_LP)
    assert const("kNfEps") == gate_kernel.NF_EPS == np.float32(1e-4)
    assert const("kMagA") == np.float32(MAG_LP)
    assert const("kMagB") == np.float32(1.0 - MAG_LP)
    assert re.search(r"kNfEvery = (\d+);", src).group(1) == \
        str(gate_kernel.NF_EVERY)
    assert re.search(r"kFloor = -\(1 << (\d+)\);", src).group(1) == "30"
    assert tnf._FLOOR == -(1 << 30)
    assert re.search(r"kMinHdrSyms = (\d+);", src).group(1) == \
        str(gate_scan._MIN_HDR_SYMS)
    assert re.search(r"kSps = (\d+);", src).group(1) == str(tnf.SPS)
    # the ppm compare sees IEEE products and quotients
    assert "__fdiv_rn(__fmul_rn(kPpmScale" in src


def test_cuda_wrappers_refuse_cpu_tensors():
    rng = np.random.default_rng(0)
    sc = _scenario(rng, 8)
    args = [_t(sc[k]) for k in ("count", "det", "sync", "sym_valid", "dphi",
                                "l2_row", "hdr_rows", "bits_rows", "busy0",
                                "next0", "hold", "hold_active")] + [_t(FREQS)]
    before = dict(gate_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        gate_kernel.gate_cuda(*args, 0.0, False, 100)
    smoke = _chip_smoke()
    targs = smoke.track_args(smoke.track_grid(C, 40, 3, 8, seed=0), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        gate_kernel.nf_track_cuda(*targs)
    assert gate_kernel.launches == before
    # on the CPU the wrappers run the plain versions and count nothing
    g, _, dec = gate_kernel.gate(*args, 0.0, False, 100)
    assert g["verdicts"].dtype == torch.int8
    assert dec["released"].dtype == torch.bool
    out = gate_kernel.nf_track(*targs)
    assert [x.dtype for x in out] == [torch.float32] * 2 + [torch.int32] \
        + [torch.float32, torch.int32]
    assert gate_kernel.launches == before


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", SRC.parent.parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gate_bounds_by_hand():
    """chip_smoke's G1 and G2 bounds: bytes in and out once over the
    memory rate, against the issue time of their least instructions."""
    smoke = _chip_smoke()
    sms, clock = 132, 1.98e9
    issue = 128 * sms * clock
    C, K = 256, 64
    b = smoke.g1_bound(C, K, C * K, sms, clock)
    # in: count, busy, next, hold, freqs (4 B) and hold_active (1 B) a
    # channel; det, sync, sym_valid, l2_row, dphi (C, K) 4 bytes each;
    # hdr (1 B) and bits (4 B) rows.  Out: verdicts (1 B) and bits (4 B)
    # a slot; eight int32 and three bool decisions a channel.
    nbytes = 21 * C + 20 * C * K + 5 * C * K + 5 * C * K + 35 * C
    assert b["bytes_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert b["ops_ms"] == pytest.approx((20 * C * K + 15 * C) / issue
                                        * 1e3)
    assert b["bound_by"] == "bytes"
    W, R = 17476, 32768
    grid = smoke.track_grid(C, 8, K, 4, seed=1)
    args = list(smoke.track_args(grid, "cpu"))
    args[0] = torch.zeros((C, W))                      # mags
    args[1] = torch.arange(W, dtype=torch.int32)       # col_pos
    args[7] = torch.arange(C) % 2 == 0                 # released
    args[9] = torch.zeros((C, R), dtype=torch.int32)   # ring_pos
    args[10] = torch.zeros((C, R))                     # ring_val
    args[11] = torch.full((C,), 100, dtype=torch.int32)  # ring_n
    b2 = smoke.g2_bound(tuple(args), 3000, sms, clock)
    cap = (R + W) // 1000 + 1
    replayed = 100 * C // 2
    nbytes = 4 * C * W + 8 * replayed + 9 * C * K + 41 * C \
        + 4 * C * K + 4 * C * cap
    assert b2["bytes_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    # the magnitudes alone: 17.9 MB, 5.3 us at 3.35 TB/s
    assert 5.3e-3 < b2["bytes_ms"] < 5.5e-3
    assert b2["ops_ms"] == pytest.approx(
        (6 * (C * W + replayed) + 5 * 3000 + 18 * C * K) / issue * 1e3)
    assert b2["bound_by"] == "bytes"
    assert b2["bound_ms"] == max(b2["bytes_ms"], b2["ops_ms"])
