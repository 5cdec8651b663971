"""PyTorch port vs JAX: the host-L2 receive pipeline.

The JAX pipeline runs with DUMPVDL2_TPU_L2=0 (set before construction):
the device slices every candidate's symbol window and the host decodes
each burst and gates it.  The port runs the same mode (device="cpu",
device_l2=False).  On the scenes of tests/test_torch_pipeline.py --
three bursts with one across the block boundary, bursts straddling the
feed boundary, and a burst cut by the end of the stream -- the frames
must agree (bytes, freq, datalen_octets, synd_weight,
num_fec_corrections and idx exactly; ppm_error, frame_pwr_dbfs and
nf_pwr_dbfs within 1e-4), and so must the per-channel counters and
carried state.  The port's host-L2 frames must also equal its own
device-L2 frames (host-gated), also where each fetch is still in flight
when later blocks are dispatched.
"""
import time

import numpy as np
import pytest
from _torch_port import (assert_frames_match, frame_keys,  # noqa: F401
                         one_torch_thread)
from test_torch_pipeline import (BLOCK, CENTER, FREQS, FS, OS,
                                 _assert_channels_match, _burst, _feed_all,
                                 _noise)

from dumpvdl2_tpu.core.pipeline import VDL2Pipeline as JaxPipeline
from dumpvdl2_tpu.sim import frame_with_fcs
from dumpvdl2_tpu_torch.core.pipeline import (VDL2Pipeline, resolve_device_gate,
                                              resolve_device_l2)


def _slowed(pipe, slow_fetch: float):
    """``pipe`` with its fetch thread sleeping ``slow_fetch`` s before
    each block's wait."""
    if slow_fetch:
        fetch_block = pipe._fetch

        def slow(pending, blk):
            time.sleep(slow_fetch)
            return fetch_block(pending, blk)
        pipe._fetch = slow
    return pipe


def _run_both(monkeypatch, sig, slow_fetch: float = 0.0):
    monkeypatch.setenv("DUMPVDL2_TPU_L2", "0")
    jp = JaxPipeline(FREQS, CENTER, FS, OS)
    assert not jp.use_device_l2 and not jp.use_device_gate
    tp = _slowed(VDL2Pipeline(FREQS, CENTER, FS, OS, device="cpu",
                              device_l2=False), slow_fetch)
    assert not tp.use_device_l2 and not tp.use_device_gate
    want, got = _feed_all(jp, sig), _feed_all(tp, sig)
    assert_frames_match(got, want)
    _assert_channels_match(tp, jp)
    dev = _feed_all(_slowed(VDL2Pipeline(FREQS, CENTER, FS, OS,
                                         device="cpu", device_l2=True,
                                         device_gate=False), slow_fetch),
                    sig)
    assert_frames_match(got, dev)
    return got, tp


def test_three_burst_scene(monkeypatch):
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
    got, _ = _run_both(monkeypatch, sig)
    have = {(bytes(f.frame), f.metadata.freq) for f in got}
    for payload, _, off in vector:
        assert (frame_with_fcs(payload), int(CENTER + off)) in have


@pytest.mark.parametrize("slow_fetch", [0.0, 0.2])
def test_block_boundary_and_eof_scene(monkeypatch, slow_fetch):
    """Bursts whose preamble, header or payload straddle the feed
    boundary, one at stream start, and one cut by the end of the stream
    (decided by finish()); with ``slow_fetch``, every block's fetch is
    still pending when the next block is dispatched."""
    rng = np.random.default_rng(5)
    sig = _noise(2 * BLOCK, seed=6)
    for at, ch, n in ((0, 0, 30), (BLOCK - 1200, 1, 40),
                      (BLOCK - 9000, 2, 120), (BLOCK - 30000, 3, 600),
                      (2 * BLOCK - 20000, 1, 400)):
        b = _burst(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                   FREQS[ch] - CENTER, seed=at)
        end = min(sig.size, at + b.size)
        sig[at:end] += b[:end - at] * 0.3
    got, tp = _run_both(monkeypatch, sig, slow_fetch)
    assert len(got) >= 4
    assert tp.channels[1].stats.get("decoder.errors.eof_truncated", 0) >= 1


@pytest.mark.parametrize("env,arg,want", [
    (None, None, True), ("1", None, True), ("auto", None, True),
    ("0", None, False), ("0", True, True), ("1", False, False)])
def test_resolve_device_l2(monkeypatch, env, arg, want):
    """DUMPVDL2_TPU_L2=0 selects host L2 unless the caller says
    otherwise; host L2 turns the device gate off."""
    if env is None:
        monkeypatch.delenv("DUMPVDL2_TPU_L2", raising=False)
    else:
        monkeypatch.setenv("DUMPVDL2_TPU_L2", env)
    monkeypatch.delenv("DUMPVDL2_TPU_GATE", raising=False)
    assert resolve_device_l2(arg) is want
    pipe = VDL2Pipeline(FREQS, CENTER, FS, OS, device="cpu", device_l2=arg)
    assert pipe.use_device_l2 is want
    assert pipe.use_device_gate is (want and resolve_device_gate())
