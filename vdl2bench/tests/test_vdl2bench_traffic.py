"""The traffic generator: deterministic per seed, the same work on
every seed, unique payloads, no burst across the pool's wrap, and a
frozen copy that still equals the port's synthesis."""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from vdl2bench.traffic import scene as S
from vdl2bench.traffic import synth

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (0, 2 ** 31 + 5, -7, 10 ** 19 + 3)


def cell(name):
    cfg = json.loads((ROOT / f"vdl2bench/configs/{name}.json").read_text())
    return cfg


def stream_mix():
    return json.loads((ROOT / "vdl2bench/traffic/stream.json").read_text())


def live_mix():
    return json.loads((ROOT / "vdl2bench/traffic/live.json").read_text())


@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_is_a_function_of_the_seed(seed):
    cfg, mix = cell("sdr8_os20"), live_mix()
    a = S.schedule(cfg, mix, seed, 8 * cfg["block_samples"])
    b = S.schedule(cfg, mix, seed, 8 * cfg["block_samples"])
    assert np.array_equal(a.start, b.start)
    assert [x.frame for x in a.bursts] == [x.frame for x in b.bursts]


def test_render_is_a_function_of_the_seed():
    cfg, mix = cell("sdr8_os20"), live_mix()
    sc = S.schedule(cfg, mix, 11, 12 * 262144)
    x = S.render(sc, 11, "cpu")
    y = S.render(sc, 11, "cpu")
    assert torch.equal(x, y)
    assert not torch.equal(x, S.render(sc, 12, "cpu"))


def test_every_seed_gets_the_same_work():
    cfg, mix = cell("sdr8_os20"), live_mix()
    n = 12 * cfg["block_samples"]
    runs = [S.schedule(cfg, mix, s, n) for s in (1, 2, 3)]
    lengths = [sorted(len(b.frame) for b in sc.bursts) for sc in runs]
    per_channel = [Counter(sc.channel.tolist()) for sc in runs]
    levels = [sorted(sc.amplitude.tolist()) for sc in runs]
    assert lengths[0] == lengths[1] == lengths[2]
    assert per_channel[0] == per_channel[1] == per_channel[2]
    assert levels[0] == levels[1] == levels[2]
    assert not np.array_equal(runs[0].start, runs[1].start)


def test_every_seed_gets_the_same_arrivals_a_block():
    """The pool's bursts fall alike into its blocks on every seed (the
    arrival times are the same; the seed orders the bursts over them)."""
    cfg, mix = cell("wb256_os80"), stream_mix()
    N = cfg["block_samples"]
    runs = [S.schedule(cfg, mix, s, 8 * N) for s in (1, 2, 2 ** 31 + 9)]
    counts = [np.bincount(sc.end // N, minlength=8).tolist() for sc in runs]
    assert counts[0] == counts[1] == counts[2]
    assert not np.array_equal(runs[0].channel, runs[1].channel)


@pytest.mark.parametrize("name,mix,blocks", [
    ("wb256_os80", "stream", 8), ("sdr8_os20", "live", 40)])
def test_payloads_unique_and_nothing_crosses_the_end(name, mix, blocks):
    cfg = cell(name)
    m = stream_mix() if mix == "stream" else live_mix()
    n = blocks * cfg["block_samples"]
    sc = S.schedule(cfg, m, 99, n)
    frames = [b.frame for b in sc.bursts]
    assert len(set(frames)) == len(frames)
    edge = m["edge_symbols"] * synth.SPS * cfg["oversample"]
    assert sc.start.min() >= edge
    assert sc.end.max() < n - edge        # the pool's wrap: no straddling
    for c in np.unique(sc.channel):       # one burst a channel at a time
        sel = np.nonzero(sc.channel == c)[0]
        assert np.all(sc.start[sel][1:] > sc.end[sel][:-1])


def test_stream_mix_rate_and_lengths():
    cfg, mix = cell("wb256_os80"), stream_mix()
    sc = S.schedule(cfg, mix, 5, mix["pool_blocks"] * cfg["block_samples"])
    assert len(np.unique(sc.channel)) == min(len(sc.bursts), 24)
    assert np.all(sc.channel % 4 == 0)
    octets = np.array([len(b.frame) - 2 for b in sc.bursts])
    assert octets.min() >= 120 and octets.max() <= 144


def test_frozen_synthesis_equals_the_port():
    from dumpvdl2_tpu_torch import sim
    rng = np.random.default_rng(3)
    payloads = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
                for n in (1, 29, 30, 67, 68, 132, 249, 250, 1990)]
    payloads.append(b"\xff" * 300)
    for p, b in zip(payloads, synth.build_bursts(payloads)):
        assert np.array_equal(b.bits, sim.build_burst_bits([p]))
        assert b.frame == sim.frame_with_fcs(p)
        assert np.array_equal(synth.bits_to_steps(b.bits),
                              sim.bits_to_symbols(b.bits))


def test_rendered_burst_equals_the_port_waveform():
    """A clean burst from ``render`` against sim.synthesize_iq_raw (no
    noise, no lead-in), at its amplitude, offset and carrier phase."""
    from dumpvdl2_tpu_torch import sim
    payload = b"vdl2bench render check"
    os_, fs, off = 10, 1050000.0, 12500.0
    ref = sim.synthesize_iq_raw([payload], oversample=os_,
                                carrier_offset_hz=off, snr_db=300.0,
                                lead_in_syms=0, tail_syms=0)
    b = synth.build_bursts([payload])[0]
    ph = synth.symbol_phases(b.bits)
    sig = torch.zeros((2, ref.size))
    synth.render(sig, [0], [ph], [1.0], [off], [0.0], fs, os_)
    got = sig[0].numpy() + 1j * sig[1].numpy()
    assert np.abs(got - ref).max() < 1e-4
