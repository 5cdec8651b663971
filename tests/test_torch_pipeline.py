"""PyTorch port vs JAX: the device-L2, host-gated receive pipeline.

The JAX pipeline runs with DUMPVDL2_TPU_L2=1 DUMPVDL2_TPU_GATE=0; the
port runs the same mode (device="cpu", device_gate=False); its gated
mode is held to the JAX package in tests/test_torch_pipeline_gated.py.
On each scene the frames must agree: bytes, freq, datalen_octets, synd_weight,
num_fec_corrections and idx exactly; ppm_error, frame_pwr_dbfs and
nf_pwr_dbfs within 1e-4 (burst_timestamp is wall time and ignored).
Per-channel counters and carried state must agree too.  All scenes
share one block shape, so the JAX side compiles once per file.
"""
from collections import Counter

import numpy as np
import pytest
from _torch_port import assert_frames_match, one_torch_thread  # noqa: F401

from dumpvdl2_tpu.core.pipeline import VDL2Pipeline as JaxPipeline
from dumpvdl2_tpu.sim import frame_with_fcs, synthesize_iq_raw
from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline, load_state

OS = 10
FS = 105000 * OS
CENTER = 136975000
FREQS = [CENTER - 25000 * i for i in range(4)]
BLOCK = 600_000                  # raw samples per feed (60k decimated)


@pytest.fixture
def jax_device_l2(monkeypatch):
    monkeypatch.setenv("DUMPVDL2_TPU_L2", "1")
    monkeypatch.setenv("DUMPVDL2_TPU_GATE", "0")


def _noise(n: int, seed: int, level: float = 0.01) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * (level / np.sqrt(2))).astype(np.complex64)


def _burst(payload: bytes, off_hz: float, seed: int) -> np.ndarray:
    return synthesize_iq_raw([payload], oversample=OS,
                             carrier_offset_hz=off_hz, seed=seed)


def _pipes():
    jp = JaxPipeline(FREQS, CENTER, FS, OS)
    assert jp.use_device_l2 and not jp.use_device_gate
    return jp, VDL2Pipeline(FREQS, CENTER, FS, OS, device="cpu",
                            device_gate=False)


def _feed_all(pipe, sig: np.ndarray, finish: bool = True):
    frames = []
    for off in range(0, sig.size, BLOCK):
        frames += pipe.feed(sig[off:off + BLOCK])
    if finish:
        frames += pipe.finish()
    return frames


def _assert_channels_match(tp, jp, j_stats_before=None):
    for c, (ct, cj) in enumerate(zip(tp.channels, jp.channels)):
        want = Counter(cj.stats)
        if j_stats_before is not None:
            want.subtract(j_stats_before[c])
        assert Counter(ct.stats) == +want, f"ch {c}"
        assert (ct.busy_until, ct.next_det_min, ct.nfcnt) == \
            (cj.busy_until, cj.next_det_min, cj.nfcnt), f"ch {c}"
        assert ct.mag_nf == pytest.approx(cj.mag_nf, rel=1e-5), f"ch {c}"
        assert ct.mag_lp == pytest.approx(cj.mag_lp, rel=1e-4, abs=1e-6)


def test_three_burst_scene(jax_device_l2):
    """Strong, marginal and near-cap (1990-octet) bursts; the near-cap
    burst straddles the block boundary."""
    rng = np.random.default_rng(1)
    nfloor = 0.01
    vector = [(b"torch port strong burst \x01\x02", 0.5, -25e3),
              (b"torch port marginal burst", nfloor, -25e3),
              (bytes(rng.integers(0, 256, 1990, dtype=np.uint8)), 0.5, 0.0)]
    sig = _noise(2 * BLOCK, seed=2, level=nfloor)
    pos = 60000
    for i, (payload, amp, off) in enumerate(vector):
        b = _burst(payload, off, seed=7 + i)
        sig[pos:pos + b.size] += b * amp
        pos += b.size + 60000
    assert pos < sig.size
    jp, tp = _pipes()
    want, got = _feed_all(jp, sig), _feed_all(tp, sig)
    assert_frames_match(got, want)
    _assert_channels_match(tp, jp)
    have = {(bytes(f.frame), f.metadata.freq) for f in got}
    for payload, _, off in vector:
        assert (frame_with_fcs(payload), int(CENTER + off)) in have


def test_block_boundary_scene(jax_device_l2):
    """Bursts whose preamble, header or payload straddle the feed
    boundary on three channels, plus one right at stream start."""
    rng = np.random.default_rng(5)
    sig = _noise(2 * BLOCK, seed=6)
    for at, ch, n in ((0, 0, 30), (BLOCK - 1200, 1, 40),
                      (BLOCK - 9000, 2, 120), (BLOCK - 30000, 3, 600)):
        b = _burst(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                   FREQS[ch] - CENTER, seed=at)
        sig[at:at + b.size] += b * 0.3
    jp, tp = _pipes()
    want, got = _feed_all(jp, sig), _feed_all(tp, sig)
    assert len(want) >= 4
    assert_frames_match(got, want)
    _assert_channels_match(tp, jp)


def test_mid_stream_start_from_jax_state(jax_device_l2):
    """The port picks up the JAX pipeline's stream state (load_state)
    with a burst deferred across the handover boundary."""
    rng = np.random.default_rng(9)
    sig = _noise(3 * BLOCK, seed=10)
    for at, ch, n in ((100_000, 0, 50), (2 * BLOCK - 8100, 2, 300),
                      (2 * BLOCK + 200_000, 1, 80), (BLOCK + 10_000, 3, 20)):
        b = _burst(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                   FREQS[ch] - CENTER, seed=at)
        sig[at:at + b.size] += b * 0.4
    jp, tp = _pipes()
    head = _feed_all(jp, sig[:2 * BLOCK], finish=False)
    head += jp._drain_pending()
    assert any(ch.nf_hold is not None for ch in jp.channels)
    before = [Counter(ch.stats) for ch in jp.channels]
    load_state(tp, {
        "taps": np.asarray(jp.taps), "dphi": np.asarray(jp.dphi),
        "carry": np.asarray(jp.carry), "n0": jp.n0,
        "hist": np.asarray(jp.hist), "hist_base": jp.hist_base,
        "residual": jp._residual,
        "channels": [{
            "busy_until": ch.busy_until, "next_det_min": ch.next_det_min,
            "mag_lp": ch.mag_lp, "mag_nf": ch.mag_nf, "nfcnt": ch.nfcnt,
            "nf_hold": ch.nf_hold, "nf_saved": ch.nf_saved}
            for ch in jp.channels]})
    tail = sig[2 * BLOCK:]
    want, got = _feed_all(jp, tail), _feed_all(tp, tail)
    assert len(head) >= 2 and len(want) >= 2
    assert_frames_match(got, want)
    _assert_channels_match(tp, jp, before)
