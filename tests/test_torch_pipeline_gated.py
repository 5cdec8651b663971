"""PyTorch port vs JAX: the device-gated receive pipeline.

The JAX pipeline runs with DUMPVDL2_TPU_L2=1 and device gating on (its
default main path); the port runs with device="cpu" and its default,
device gating.  The scenes are those of tests/test_nf_gate.py:

* a multichannel scene with good, header-corrupt, deferred and
  back-to-back bursts,
* tiny blocks with a long deferral (the hold persists for blocks),
* the --max-ppm gate, rejecting and accepting,
* a noise-only noise-floor trajectory,
* carried indices rebased near 2^31.

On each scene the frames must agree: bytes, freq, datalen_octets,
synd_weight, num_fec_corrections and idx exactly; ppm_error,
frame_pwr_dbfs and nf_pwr_dbfs within 1e-4.  Per-channel counters, the
state mirrored into ChannelState, and the carried gate state must agree
too: integers exactly, mag_nf and mag_lp within rtol 1e-5.

Two more checks stay inside the port: its gated and host-gated runs on
the same scenes (the dual-mode check, held as tests/test_nf_gate.py
holds the JAX package's two modes), and a mid-stream handover from a
JAX gated pipeline whose hold is active with saved columns in its ring.
"""
from collections import Counter

import numpy as np
import pytest
from _torch_port import assert_frames_match, one_torch_thread  # noqa: F401

from dumpvdl2_tpu.constants import PREAMBLE_PHASE_UNITS, SPS, SYMBOL_RATE
from dumpvdl2_tpu.core.pipeline import VDL2Pipeline as JaxPipeline
from dumpvdl2_tpu.fec.scramble import PRBS
from dumpvdl2_tpu.sim import (bits_to_symbols, build_burst_bits,
                              build_header, frame_with_fcs)
from dumpvdl2_tpu_torch.core import nf_gate
from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline, load_state

OS = 10
FS = SYMBOL_RATE * SPS * OS
CENTER = 136975000
SPSYM = SPS * OS
BLOCK = 100_000                  # raw samples per feed
TWO = [CENTER, CENTER + 25_000]


def _modulate(bits: np.ndarray, carrier_offset_hz: float = 0.0
              ) -> np.ndarray:
    """Burst bits -> complex64 at the ingest rate (no noise)."""
    steps = bits_to_symbols(bits)
    pre = np.array(PREAMBLE_PHASE_UNITS, np.float64) * (np.pi / 4)
    phase = list(pre)
    cur = pre[-1]
    for k in steps:
        cur += k * np.pi / 4
        phase.append(cur)
    sig = np.repeat(np.exp(1j * np.array(phase)), SPSYM)
    if carrier_offset_hz:
        t = np.arange(sig.size) / FS
        sig = sig * np.exp(2j * np.pi * carrier_offset_hz * t)
    return sig.astype(np.complex64)


def _place(span: np.ndarray, at: int, burst: np.ndarray) -> None:
    span[at:at + burst.size] += burst[:max(0, span.size - at)]


def _span(n_raw: int, seed: int = 7, noise: float = 0.01) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n_raw) + 1j * rng.standard_normal(n_raw))
            .astype(np.complex64) * noise)


def _multichannel():
    rng = np.random.default_rng(3)
    p_a = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    p_c = bytes(rng.integers(0, 256, 600, dtype=np.uint8))
    p_d = bytes(rng.integers(0, 256, 30, dtype=np.uint8))
    p_e = bytes(rng.integers(0, 256, 80, dtype=np.uint8))
    span = _span(800_000)
    # ch0: A good; C long (straddles two feeds); D right after C's end
    _place(span, 30_000, _modulate(build_burst_bits([p_a])))
    bits_c = build_burst_bits([p_c])
    c_at = 380_000
    _place(span, c_at, _modulate(bits_c))
    c_end = c_at + (16 + (bits_c.size + 2) // 3) * SPSYM
    _place(span, c_end + 40 * SPSYM, _modulate(build_burst_bits([p_d])))
    # ch0: header-reject burst (too_long) whose sync lands just before
    # a feed boundary: header-short deferral, then the reject
    bits_x = build_burst_bits([p_a]).copy()
    clear = bits_x ^ PRBS[:bits_x.size]
    clear[:25] = build_header(0x1FFFF)
    _place(span, 2 * BLOCK - 1500 - 16 * SPSYM,
           _modulate(clear ^ PRBS[:bits_x.size]))
    # ch1: E good, straddling a feed boundary
    _place(span, 6 * BLOCK - 4000,
           _modulate(build_burst_bits([p_e]), carrier_offset_hz=25_000))
    want = {(CENTER, frame_with_fcs(p_a)), (CENTER, frame_with_fcs(p_c)),
            (CENTER, frame_with_fcs(p_d)),
            (CENTER + 25_000, frame_with_fcs(p_e))}
    return dict(freqs=TWO, span=span, want=want)


def _tiny_blocks():
    rng = np.random.default_rng(4)
    p = bytes(rng.integers(0, 256, 600, dtype=np.uint8))
    span = _span(700_000, seed=8)
    _place(span, 200_000, _modulate(build_burst_bits([p])))
    return dict(freqs=[CENTER], span=span, block=65_536,
                want={(CENTER, frame_with_fcs(p))})


def _ppm(max_ppm):
    def scene():
        rng = np.random.default_rng(5)
        p = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
        span = _span(300_000, seed=9)
        # ~150 Hz offset -> ~1.1 ppm at 137 MHz
        _place(span, 60_000, _modulate(build_burst_bits([p]),
                                       carrier_offset_hz=150.0))
        want = set() if max_ppm < 1 else {(CENTER, frame_with_fcs(p))}
        return dict(freqs=[CENTER], span=span, max_ppm=max_ppm, want=want,
                    exact=True)
    return scene


def _noise_floor():
    return dict(freqs=[CENTER], span=_span(1_200_000, seed=10, noise=0.05),
                want=set(), exact=True)


def _rebase():
    rng = np.random.default_rng(6)
    p = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    span = _span(400_000, seed=11)
    _place(span, 150_000, _modulate(build_burst_bits([p])))
    return dict(freqs=[CENTER], span=span, base_offset=2**31 - 20_000,
                want={(CENTER, frame_with_fcs(p))}, exact=True)


SCENES = {"multichannel": _multichannel, "tiny_blocks": _tiny_blocks,
          "ppm_reject": _ppm(0.5), "ppm_accept": _ppm(3.0),
          "noise_floor": _noise_floor, "rebase_2p31": _rebase}


def _run(pipe, sc):
    if sc.get("base_offset"):
        pipe.hist_base = sc["base_offset"]
        pipe._gate_base = 0            # the device rebases via the clamp
    block = sc.get("block", BLOCK)
    span = sc["span"]
    frames = []
    for off in range(0, span.size, block):
        frames += pipe.feed(span[off:off + block])
    frames += pipe.finish()
    return pipe, frames


def _jax_pipe(freqs, max_ppm=0.0):
    jp = JaxPipeline(freqs, CENTER, int(FS), OS, max_ppm=max_ppm)
    jp.use_device_l2 = True
    jp.use_device_gate = True
    return jp


def _port_pipe(freqs, max_ppm=0.0, device_gate=None):
    return VDL2Pipeline(freqs, CENTER, int(FS), OS, max_ppm=max_ppm,
                        device="cpu", device_gate=device_gate)


_CACHE: dict = {}


def _scene_runs(name):
    """(scene, JAX gated run, port gated run), computed once a file."""
    if name not in _CACHE:
        sc = SCENES[name]()
        mp = sc.get("max_ppm", 0.0)
        jax_run = _run(_jax_pipe(sc["freqs"], mp), sc)
        port = _port_pipe(sc["freqs"], mp)
        assert port.use_device_gate
        _CACHE[name] = (sc, jax_run, _run(port, sc))
    return _CACHE[name]


def _assert_gate_state(ts: dict, js: dict):
    for k in nf_gate.STATE_KEYS:
        got = ts[k].cpu().numpy()
        want = np.asarray(js[k])
        if k in ("mag_lp", "mag_nf", "ring_val"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def _assert_channels(tp, jp, j_stats_before=None):
    for c, (ct, cj) in enumerate(zip(tp.channels, jp.channels)):
        want = Counter(cj.stats)
        if j_stats_before is not None:
            want.subtract(j_stats_before[c])
        assert Counter(ct.stats) == +want, f"ch {c}"
        assert (ct.busy_until, ct.next_det_min, ct.nfcnt, ct.nf_hold) == \
            (cj.busy_until, cj.next_det_min, cj.nfcnt, cj.nf_hold), f"ch {c}"
        assert ct.mag_nf == pytest.approx(cj.mag_nf, rel=1e-5), f"ch {c}"
        assert ct.mag_lp == pytest.approx(cj.mag_lp, rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("name", list(SCENES))
def test_gated_port_matches_jax(name):
    sc, (jp, want), (tp, got) = _scene_runs(name)
    assert_frames_match(got, want)
    _assert_channels(tp, jp)
    _assert_gate_state(tp._gate_state, jp._gate_state)
    assert tp._gate_base == jp._gate_base
    assert tp.last_deferred_min == jp.last_deferred_min
    have = {(f.metadata.freq, bytes(f.frame)) for f in got}
    if sc.get("exact"):
        assert {(f, b) for f, b in have if f == CENTER} == \
            {(f, b) for f, b in sc["want"]}
    else:
        assert sc["want"] <= have


@pytest.mark.parametrize("name", list(SCENES))
def test_gated_and_host_gated_port_agree(name):
    """The port's two modes accept the same bursts with the same
    counters and carried state (noise floor within 2e-4 dB)."""
    sc, _, (tp, got) = _scene_runs(name)
    hp, host = _run(_port_pipe(sc["freqs"], sc.get("max_ppm", 0.0),
                               device_gate=False), sc)
    assert not hp.use_device_gate
    assert_frames_match(got, host)
    for a, b in zip(got, host):
        assert abs(a.metadata.nf_pwr_dbfs - b.metadata.nf_pwr_dbfs) < 2e-4
    for c, (cg, ch) in enumerate(zip(tp.channels, hp.channels)):
        assert cg.stats == ch.stats, f"ch {c}"
        assert (cg.busy_until, cg.next_det_min, cg.nfcnt) == \
            (ch.busy_until, ch.next_det_min, ch.nfcnt), f"ch {c}"
        assert cg.mag_nf == pytest.approx(ch.mag_nf, rel=1e-5), f"ch {c}"
        assert cg.mag_lp == pytest.approx(ch.mag_lp, rel=1e-4, abs=1e-6)


def test_step_ms_has_gate_key():
    """The synchronized breakdown times the gate step apart."""
    sc = _ppm(3.0)()
    pipe = _port_pipe(sc["freqs"], 3.0)
    pipe.step_ms = {}
    frames = _run(pipe, sc)[1]
    assert [bytes(f.frame) for f in frames] == \
        [b for _, b in sorted(sc["want"])]
    assert {"detect", "l2", "gate", "fetch_host"} <= set(pipe.step_ms)


def test_handover_from_jax_with_active_hold():
    """load_state from a JAX gated pipeline mid-deferral (the tiny-block
    scene's long burst holds the tracker), then both run to EOF.

    A single-device stream keeps the ring empty here: it fills only
    when a held burst is not re-detected, as the mesh pipeline's drain
    lag makes happen.  So before the handover the test writes 7 000
    saved columns into the JAX state's ring, from the hold onwards;
    when the burst resolves, both packages replay the ones past its
    busy window."""
    import jax.numpy as jnp
    sc = _tiny_blocks()
    span, block = sc["span"], sc["block"]
    jp = _jax_pipe(sc["freqs"])
    head = []
    cut = None
    for off in range(0, span.size, block):
        head += jp.feed(span[off:off + block])
        head += jp._drain_pending()
        st = jp._gate_state
        if st is not None and bool(np.asarray(st["hold_active"])[0]):
            cut = off + block
            break
    assert cut is not None and cut < span.size, "no active hold to hand over"
    st = dict(jp._gate_state)
    n = 7000
    hold = int(np.asarray(st["hold"])[0])
    pos = np.array(st["ring_pos"])
    val = np.array(st["ring_val"])
    pos[0, :n] = hold + 3 * np.arange(n)
    val[0, :n] = np.random.default_rng(12).exponential(0.01, n)
    st.update(ring_pos=jnp.asarray(pos), ring_val=jnp.asarray(val),
              ring_n=jnp.asarray(np.array([n], np.int32)))
    jp._gate_state = st
    before = [Counter(ch.stats) for ch in jp.channels]
    tp = _port_pipe(sc["freqs"])
    load_state(tp, {
        "taps": np.asarray(jp.taps), "dphi": np.asarray(jp.dphi),
        "carry": np.asarray(jp.carry), "n0": jp.n0,
        "hist": np.asarray(jp.hist), "hist_base": jp.hist_base,
        "residual": jp._residual,
        "channels": [{
            "busy_until": ch.busy_until, "next_det_min": ch.next_det_min,
            "mag_lp": ch.mag_lp, "mag_nf": ch.mag_nf, "nfcnt": ch.nfcnt,
            "nf_hold": ch.nf_hold, "nf_saved": ch.nf_saved}
            for ch in jp.channels],
        "gate_state": {k: np.asarray(v) for k, v in jp._gate_state.items()},
        "gate_base": jp._gate_base})
    tail = span[cut:]
    outs = []
    for pipe in (jp, tp):
        frames = []
        for off in range(0, tail.size, block):
            frames += pipe.feed(tail[off:off + block])
        outs.append(frames + pipe.finish())
    want, got = outs
    assert_frames_match(got, want)
    assert [bytes(f.frame) for f in head + got] == \
        [b for _, b in sorted(sc["want"])]
    _assert_channels(tp, jp, before)
    _assert_gate_state(tp._gate_state, jp._gate_state)
    assert int(tp._gate_state["ring_n"][0]) == 0        # replayed
    assert not bool(tp._gate_state["hold_active"][0])
