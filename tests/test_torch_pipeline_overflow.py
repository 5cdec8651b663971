"""PyTorch port vs JAX: the pipeline's candidate caps under overload.

Five channels (so the 320 candidate slots exceed the 256-row L2 cap)
carry back-to-back short bursts: more valid candidates than the slot
cap (demod.sync.overflow) and more hdr-ok rows than the RS-stage cap
(decoder.errors.l2_overflow).  Which candidates overflow depends on
the stable compaction order, so the frames and both counters must
match the JAX pipeline (DUMPVDL2_TPU_L2=1 DUMPVDL2_TPU_GATE=0) exactly.
"""
import numpy as np
from _torch_port import assert_frames_match, one_torch_thread  # noqa: F401

from dumpvdl2_tpu.core.pipeline import VDL2Pipeline as JaxPipeline
from dumpvdl2_tpu.sim import synthesize_iq_raw
from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline

OS = 10
FS = 105000 * OS
CENTER = 136975000
FREQS = [CENTER + 100_000 * (i - 2) for i in range(5)]
BLOCK = 600_000


def _dense_scene() -> np.ndarray:
    rng = np.random.default_rng(21)
    sig = ((rng.standard_normal(2 * BLOCK) + 1j * rng.standard_normal(
        2 * BLOCK)) * 0.007).astype(np.complex64)
    for c, f in enumerate(FREQS):
        at = 2000 + 700 * c
        for k in range(62):
            payload = b"%c%02d" % (65 + c, k)
            b = synthesize_iq_raw([payload], oversample=OS,
                                  carrier_offset_hz=f - CENTER,
                                  lead_in_syms=0, tail_syms=4,
                                  seed=100 * c + k)
            sig[at:at + b.size] += b * 0.5
            at += b.size + 800
        assert at < BLOCK
    return sig


def test_candidate_caps_overflow_like_jax(monkeypatch):
    monkeypatch.setenv("DUMPVDL2_TPU_L2", "1")
    monkeypatch.setenv("DUMPVDL2_TPU_GATE", "0")
    sig = _dense_scene()
    outs = []
    for pipe in (JaxPipeline(FREQS, CENTER, FS, OS),
                 VDL2Pipeline(FREQS, CENTER, FS, OS, device="cpu")):
        frames = []
        for off in range(0, sig.size, BLOCK):
            frames += pipe.feed(sig[off:off + BLOCK])
        frames += pipe.finish()
        outs.append((pipe, frames))
    (jp, want), (tp, got) = outs
    assert_frames_match(got, want)
    for c, (ct, cj) in enumerate(zip(tp.channels, jp.channels)):
        assert ct.stats == cj.stats, f"ch {c}"
    total = {k: sum(ch.stats.get(k, 0) for ch in tp.channels)
             for k in ("demod.sync.overflow", "decoder.errors.l2_overflow",
                       "decoder.msg.good")}
    assert total["demod.sync.overflow"] > 0, total
    assert total["decoder.errors.l2_overflow"] > 0, total
    assert total["decoder.msg.good"] > 100, total
