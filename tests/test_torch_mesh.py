"""PyTorch port vs JAX: the mesh path (``--mesh CxT``).

* ``nf_gate.gate_nf_mesh``: chains of fabricated mesh blocks (Tn, C, K)
  through both packages, with prepend_dec = 0 on every block, and with
  re-read blocks (prepend_dec > 0) at shard lengths Ml with Ml % 3 != 0,
  where JAX drops a prefix of the magnitude columns by mask and the port
  slices it off.  The merged candidate fields must be equal, verdicts,
  integer state and the ring exactly, mag_lp, mag_nf and nf_read within
  rtol 1e-5, atol 1e-7.
* ``MeshPipeline`` against JAX's MeshPipeline (frames and per-channel
  counters) and against the port's single-device VDL2Pipeline (frames)
  on the 2x2 channel-sharded scene of tests/test_mesh_cli.py, the
  gated-vs-host-gated scene with the prepend re-read of
  tests/test_nf_gate.py, a max-length burst across 4 time shards
  (tests/test_maxlen_burst.py).  The port's shards
  all sit on the CPU ("cpu" repeated), JAX's on the virtual CPU devices
  of tests/conftest.py.  Frames: bytes, freq, datalen_octets,
  synd_weight, num_fec_corrections and idx exactly, ppm_error,
  frame_pwr_dbfs and nf_pwr_dbfs within 1e-4 (2e-4 dB between the
  gated and host-gated modes, the tolerance of tests/test_nf_gate.py).
  The port's mesh cuts blocks at multiples of 3 decimated samples a
  shard, and on scenes with a re-read the noise floor of the re-read
  burst follows the single-device path, not JAX's mesh
  (core/mesh_pipeline.py; ROADMAP.md queue 3).  The scenes without a
  re-read (the channel-sharded scene, the max-length burst) are one
  feed whose length is a multiple of 3 * OS * Tn, so both packages cut
  the same blocks, and there the noise-floor tracker's state (nfcnt,
  mag_nf) is held to JAX's mesh too; on re-read scenes the frames are
  held to the single-device run in full and to JAX's mesh on their
  exact fields.  Every pipeline takes K_SLOTS candidate slots a shard
  and channel, both packages alike.
The host-L2 mesh and a deferred burst the reference loses:
tests/test_torch_mesh_reread.py; the CLI's ``--mesh``:
tests/test_torch_mesh_cli.py.
"""
from collections import Counter

import numpy as np
import pytest
from _torch_port import (assert_frames_match, frame_keys,  # noqa: F401
                         one_torch_thread)
from test_maxlen_burst import _PAYLOAD
from test_torch_gate import C, FREQS, R_SMALL, _cmp_out, _cmp_state, _t
from test_torch_pipeline_gated import _modulate

from dumpvdl2_tpu.constants import SPS, SYMBOL_RATE
from dumpvdl2_tpu.core import nf_gate as jnf
from dumpvdl2_tpu.core.mesh_pipeline import MeshPipeline as JaxMesh
from dumpvdl2_tpu.sim import (build_burst_bits, frame_with_fcs,
                              synthesize_iq_raw)
from dumpvdl2_tpu_torch.core import nf_gate as tnf
from dumpvdl2_tpu_torch.core.mesh_pipeline import MeshPipeline
from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline

OS = 10
FS = SYMBOL_RATE * SPS * OS
CENTER = 136975000
# candidate slots a (time shard, channel): each block decodes Tn*C*K
# slots in L2, and no scene here holds more than a few candidates
K_SLOTS = 16


# ----------------------------------------------------------- gate_nf_mesh
def _mesh_block(rng, Tn, K, Ml):
    """One fabricated mesh block: each (time shard, channel) holds
    candidates in its fresh span [t*Ml, (t+1)*Ml), shard 0 also halo
    hits at negative indices; some with too few symbols (deferrals),
    some slots over the K cap; the L2 rows compacted or not."""
    count = np.where(rng.random((Tn, C)) < 0.25, 0,
                     rng.integers(1, K + 3, (Tn, C))).astype(np.int32)
    det = np.full((Tn, C, K), -1, np.int32)
    sync = np.full((Tn, C, K), -1, np.int32)
    for t in range(Tn):
        for c in range(C):
            n = min(int(count[t, c]), K)
            lo = -150 if t == 0 else t * Ml
            pos = np.sort(rng.choice(np.arange(lo, (t + 1) * Ml), size=n,
                                     replace=False)).astype(np.int32)
            det[t, c, :n] = pos
            sync[t, c, :n] = pos - rng.integers(1, 4, n).astype(np.int32)
    sym_valid = np.where(rng.random((Tn, C, K)) < 0.2,
                         rng.integers(0, 12, (Tn, C, K)),
                         rng.integers(12, 300, (Tn, C, K))).astype(np.int32)
    dphi = rng.normal(0.0, 0.004, (Tn, C, K)).astype(np.float32)
    dphi[rng.random((Tn, C, K)) < 0.1] = 1.0
    pherr = rng.uniform(0, 4, (Tn, C, K)).astype(np.float32)
    total = Tn * C * K
    if rng.random() < 0.5:
        inv, B = None, total
    else:
        B = total // 2
        inv = np.full(total, -1, np.int32)
        take = rng.choice(total, size=B, replace=False)
        inv[take] = rng.permutation(B)
    hdr_rows = rng.random(B) >= 0.2
    bits_rows = (3 * rng.integers(12, 200, B)
                 - rng.integers(0, 3, B)).astype(np.int32)
    X = -(-Ml // 3)
    pwr3 = (rng.exponential(0.02, (C, Tn * X))
            * np.where(rng.random((C, Tn * X)) < 0.01, 400.0, 1.0)) \
        .astype(np.float32)
    return (count, det, sync, dphi, pherr, sym_valid, inv, hdr_rows,
            bits_rows, pwr3)


@pytest.mark.parametrize("reread,Tn,K,Ml", [(False, 4, 6, 1049),
                                             (True, 4, 6, 1049),
                                             (True, 2, 8, 1052)],
                         ids=["prepend0", "reread_ml%3=1", "reread_ml%3=2"])
def test_gate_nf_mesh_matches_jax(reread, Tn, K, Ml):
    rng = np.random.default_rng(91 + reread + Ml)
    jst = jnf.init_state(C, ring=R_SMALL)
    tst = tnf.init_state(C, ring=R_SMALL)
    drops = []
    for b in range(8):
        prepend_dec = int(rng.integers(1, 2 * Ml)) if reread and b % 3 \
            else 0
        delta = int(rng.integers(Tn * Ml - 500, Tn * Ml + 100))
        max_ppm = float(rng.choice([0.0, 5.0]))
        (count, det, sync, dphi, pherr, sym_valid, inv, hdr_rows,
         bits_rows, pwr3) = _mesh_block(rng, Tn, K, Ml)
        jout, jmerged, jst = jnf.gate_nf_mesh(
            count, det, sync, dphi, pherr, sym_valid, inv, hdr_rows,
            bits_rows, pwr3, np.int32(Ml), np.int32(prepend_dec),
            np.int32(delta), jst, FREQS, np.float32(max_ppm))
        tout, tmerged, tst = tnf.gate_nf_mesh(
            _t(count), _t(det), _t(sync), _t(dphi), _t(pherr),
            _t(sym_valid), None if inv is None else _t(inv), _t(hdr_rows),
            _t(bits_rows), _t(pwr3), Ml, prepend_dec, delta, tst,
            _t(FREQS), max_ppm)
        ctx = f"block {b}"
        assert set(tmerged) == set(jmerged)
        for k in tmerged:
            np.testing.assert_array_equal(tmerged[k].numpy(),
                                          np.asarray(jmerged[k]),
                                          err_msg=f"{ctx} merged {k}")
        _cmp_out(tout, jout, ctx)
        _cmp_state(tst, jst, ctx)
        drops.append(tnf.mesh_columns(pwr3.shape[1], Tn, Ml,
                                      prepend_dec)[0])
    assert (max(drops) > 0) is reread


@pytest.mark.parametrize("W,Tn,Ml,pre", [
    (1400, 4, 1049, 0), (1400, 4, 1049, 1), (1400, 4, 1049, 1050),
    (1400, 4, 1049, 4000), (702, 2, 1052, 1053), (702, 2, 1052, 6000),
    (0, 2, 5, 3)])
def test_mesh_column_drop_is_jax_mask(W, Tn, Ml, pre):
    """The dropped columns are a prefix of JAX's col_keep mask."""
    X = W // Tn
    j = np.arange(W)
    keep = (j // max(X, 1)) * Ml + 3 * (j % max(X, 1)) >= pre
    n = tnf.mesh_columns(W, Tn, Ml, pre)[0]
    np.testing.assert_array_equal(keep, j >= n)


# ------------------------------------------------------------ the pipeline
def _span(n, seed, noise=0.01):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            .astype(np.complex64) * noise)


def _port_mesh(freqs, shape, **kw):
    return MeshPipeline(freqs, CENTER, int(FS), OS, mesh_shape=shape,
                        devices=["cpu"] * (shape[0] * shape[1]),
                        max_candidates=K_SLOTS, **kw)


def _jax_mesh(monkeypatch, freqs, shape, l2="1"):
    monkeypatch.setenv("DUMPVDL2_TPU_L2", l2)
    monkeypatch.delenv("DUMPVDL2_TPU_GATE", raising=False)
    return JaxMesh(freqs, CENTER, int(FS), OS, mesh_shape=shape,
                   max_candidates=K_SLOTS)


def _single(freqs, **kw):
    return VDL2Pipeline(freqs, CENTER, int(FS), OS, device="cpu",
                        max_candidates=K_SLOTS, **kw)


def _feed(pipe, span, block):
    frames = []
    for off in range(0, span.size, block):
        frames += pipe.feed(span[off:off + block])
    return frames + pipe.finish()


def _assert_stats_match(tp, jp, tracker=True):
    """Per-channel counters equal; with ``tracker`` also the noise-floor
    tracker's count and floor."""
    for c, (ct, cj) in enumerate(zip(tp.channels, jp.channels)):
        assert Counter(ct.stats) == Counter(cj.stats), f"ch {c}"
        if tracker:
            assert ct.nfcnt == cj.nfcnt, f"ch {c}"
            assert ct.mag_nf == pytest.approx(cj.mag_nf, rel=1e-5), f"ch {c}"


def _by_key(frames):
    return sorted(frames, key=lambda f: frame_keys([f])[0])


def test_mesh_channel_sharded_scene(monkeypatch):
    """A burst on channel 1 of two, 2x2 mesh: the frames of JAX's mesh
    and of the port's single-device pipeline."""
    freqs = [CENTER, CENTER - 25000]
    iq0 = synthesize_iq_raw([b"mesh channel shard test payload"],
                            oversample=OS)
    t = np.arange(iq0.size) / FS
    iq1 = (iq0 * np.exp(-2j * np.pi * 25e3 * t)).astype(np.complex64)
    # both packages cut one block of the whole stream: its length is a
    # multiple of 3 * OS * Tn
    n = -(-(80_000 + iq1.size) // (3 * OS * 2)) * (3 * OS * 2)
    stream = np.zeros(n, np.complex64)
    stream[40_000:40_000 + iq1.size] = iq1
    jp = _jax_mesh(monkeypatch, freqs, (2, 2))
    want = jp.feed(stream, eof=True)
    tp = _port_mesh(freqs, (2, 2))
    got = tp.feed(stream, eof=True)
    assert [bytes(f.frame) for f in got] == \
        [frame_with_fcs(b"mesh channel shard test payload")]
    assert_frames_match(got, want)
    _assert_stats_match(tp, jp)
    assert_frames_match(got, _single(freqs).feed(stream, eof=True))


# feed length of the prepend scene: 1x4 shards of Ml = 5 250 decimated
# samples, a multiple of 3, so that the shards' every-3rd-sample
# magnitude columns are the single-device path's columns
FEED = 210_000


def _prepend_scene():
    rng = np.random.default_rng(12)
    p1 = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    p2 = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    # four feeds: the burst deferred in the second is re-read in the
    # fourth (after the third was drained), not in the EOF flush
    span = _span(4 * FEED, seed=13)
    b1 = _modulate(build_burst_bits([p1]))
    span[40_000:40_000 + b1.size] += b1
    # straddles the 2nd/3rd feed boundary -> deferral + prepend re-read
    b2 = _modulate(build_burst_bits([p2]))
    at = 2 * FEED - 30_000
    span[at:at + b2.size] += b2
    return span, sorted([frame_with_fcs(p1), frame_with_fcs(p2)])


def test_mesh_gated_and_host_gated_with_prepend(monkeypatch):
    """1x4 mesh, 210k-sample feeds, a burst across the 2nd/3rd feed
    boundary (deferral, then the prepend re-read): the port's gated run
    against JAX's gated run, the port's host-gated run and the port's
    single-device run."""
    span, want_frames = _prepend_scene()
    jp = _jax_mesh(monkeypatch, [CENTER], (1, 4))
    want = _feed(jp, span, FEED)
    tp = _port_mesh([CENTER], (1, 4))
    assert tp.use_device_gate
    rereads, rebase = [], tp._rebase_state
    tp._rebase_state = lambda base: rereads.append(base) or rebase(base)
    got = _feed(tp, span, FEED)
    assert rereads, "the scene must re-read a deferred burst"
    assert sorted(bytes(f.frame) for f in got) == want_frames
    assert frame_keys(got) == frame_keys(want)
    _assert_stats_match(tp, jp, tracker=False)
    th = _port_mesh([CENTER], (1, 4), device_gate=False)
    host = _feed(th, span, FEED)
    assert frame_keys(host) == frame_keys(got)
    for a, b in zip(host, got):
        assert abs(a.metadata.nf_pwr_dbfs - b.metadata.nf_pwr_dbfs) < 2e-4
    for c, (ca, cb) in enumerate(zip(th.channels, tp.channels)):
        assert ca.stats == cb.stats, f"ch {c}"
        assert ca.nfcnt == cb.nfcnt, f"ch {c}"
    single = _feed(_single([CENTER]), span, FEED)
    assert_frames_match(_by_key(got), _by_key(single))


def test_maxlen_burst_across_four_time_shards(monkeypatch):
    """Each time shard's fresh span (26k decimated samples) is shorter
    than the burst (56k): the decode rides the multi-hop forward halo."""
    iq = synthesize_iq_raw([_PAYLOAD], oversample=OS, snr_db=40.0,
                           seed=3).astype(np.complex64)
    sig = _span(1_040_040, seed=5)          # 3 * OS * Tn divides it
    sig[150_000:150_000 + iq.size] += iq
    jp = _jax_mesh(monkeypatch, [CENTER], (1, 4))
    want = jp.feed(sig, eof=True)
    tp = _port_mesh([CENTER], (1, 4))
    got = tp.feed(sig, eof=True)
    assert [bytes(f.frame) for f in got] == [frame_with_fcs(_PAYLOAD)]
    assert_frames_match(got, want)
    _assert_stats_match(tp, jp)
    assert_frames_match(got, _single([CENTER]).feed(sig, eof=True))
