"""The plain reference: its channelizer against the direct mix, filter
and decimate, its header decode, the TF32 control's rounding, and a
tiny scene decoded to its known payloads."""
from __future__ import annotations

import numpy as np
import torch

from vdl2bench.reference import receiver as R
from vdl2bench.traffic import scene as S
from vdl2bench.traffic import synth

# channels 100 kHz apart: the channel filter leaves no echo of a burst on
# a neighbour to claim it (at 25 kHz a garbled echo header can)
CFG = {"channels": 4, "spacing_hz": 100000, "first_hz": 136975000,
       "oversample": 10}


def test_channelizer_equals_the_direct_mix_filter_decimate():
    rng = np.random.default_rng(0)
    freqs = [136975000, 136950000, 136900000]
    center, fs, os_ = 136940000, 1050000, 10
    n = 20000
    x = rng.standard_normal((2, n))
    ch = R.Channelizer(freqs, center, fs, os_, "cpu")
    got = ch.decimate(torch.as_tensor(x), 0, 0, n // os_).numpy()
    h = R.lpf_taps(fs, os_)
    xc = x[0] + 1j * x[1]
    idx = np.arange(n)
    for c, f in enumerate(freqs):
        dphi = R.nco_dphi(center, f, fs)
        mixed = xc * np.exp(2j * np.pi * (((idx & R.MASK24) * dphi)
                                          & R.MASK24) / 2 ** 24)
        y = np.convolve(mixed, h)[:n]
        want = y[os_ - 1::os_]
        assert np.abs(got[c] - want).max() < 1e-10 * np.abs(want).max()


def test_vectorised_headers_equal_the_scalar_decode():
    bits = np.random.default_rng(1).integers(0, 2, (3000, 25)) \
        .astype(np.uint8)
    ok, datalen, consumed = R.headers(bits)
    for i in range(bits.shape[0]):
        assert R.header(bits[i]) == (bool(ok[i]), int(datalen[i]),
                                     int(consumed[i]))


def test_transmitted_headers_decode():
    bursts = synth.build_bursts([b"x" * n for n in (5, 60, 300, 1990)])
    ok, datalen, _ = R.headers(np.stack([b.bits[:25] for b in bursts]))
    assert ok.all()
    assert datalen.tolist() == [b.datalen for b in bursts]


def test_tf32_control_rounds_to_ten_mantissa_bits():
    ch = R.Channelizer([136975000], 136975000, 1050000, 10, "cpu",
                       precision="tf32")
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -12])
    y = ch._operand(x)
    assert y.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -10]
    bits = ch.kernel.contiguous().view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0


def test_tiny_scene_decodes_to_its_payloads():
    """Strong bursts on 4 channels 100 kHz apart: the reference emits
    each that no other burst overlaps once, byte for byte, on its
    channel."""
    mix = {"noise_rms": 0.002, "channels": {"stride": 1, "active": 4},
           "per_channel_bursts_per_s": 1.0,
           "lengths": [{"share": 1.0, "min": 30, "max": 200}],
           "levels": [{"share": 1.0, "amplitude": 0.5}],
           "gap_symbols": 40, "edge_symbols": 100, "freq_error_hz": 100.0}
    n = 8 * 262140
    sc = S.schedule(CFG, mix, 21, n)
    sig = S.render(sc, 21, "cpu")
    ch = R.Channelizer(sc.freqs, sc.center, sc.fs, sc.oversample, "cpu")
    D = n // sc.oversample
    z = ch.decimate(sig, 0, 0, D)
    out = R.receive(torch.atan2(z.imag, z.real), z.real ** 2 + z.imag ** 2,
                    sc, D, np.arange(len(sc.bursts)),
                    R.expected_sync(sc, 8 * sc.oversample),
                    np.arange(1, 9) * (n // 8) // sc.oversample)
    own = {(f["burst"], f["channel"]) for f in out["frames"]
           if f["channel"] == sc.channel[f["burst"]]}
    alone = [j for j in range(len(sc.bursts))
             if not np.any((sc.start < sc.end[j]) & (sc.end > sc.start[j])
                           & (np.arange(len(sc.bursts)) != j))]
    assert len(alone) >= 3
    assert {(j, int(sc.channel[j])) for j in alone} <= own
    assert all(f["frame_pwr"] > 0.2 for f in out["frames"]
               if (f["burst"], f["channel"]) in own)


def test_noise_floor_tracker_equals_the_column_by_column_ema():
    """The tracker's truncated EMA, sampled at every 1000th tracked
    column, against the EMA and floor updates run column by column over
    the columns no known claim covers."""
    rng = np.random.default_rng(5)
    block_starts = np.arange(0, 60000, 9000)
    pos = np.arange(0, 60000, 3)
    mags = rng.rayleigh(0.02, pos.size)
    claimed = [(1000, 1400, 1020, False), (8950, 9300, 9100, True),
               (20000, 26000, 20100, False), (33000, 33500, 36500, False)]
    reads = [10, 5000, 9200, 30000, 44000, 59990]
    got = R.track_noise_floor(
        torch.as_tensor(pos), lambda p: torch.as_tensor(mags)[p // 3],
        claimed,
        reads, block_starts)
    skip = np.zeros(pos.size, bool)
    for s, e, det, deferred in claimed:
        first = block_starts[np.searchsorted(block_starts, det, "right") - 1]
        skip |= (pos >= max(det if deferred else s, first)) & (pos < e)
    y, nf, n, floor_at = 0.0, 2.0, 0, []
    for p, m, sk in zip(pos, mags, skip):
        if sk:
            continue
        y = R.MAG_LP * y + (1 - R.MAG_LP) * m
        n += 1
        if n % 1000 == 0:
            nf = R.NF_LP * nf + (1 - R.NF_LP) * min(y, nf) + 0.0001
        floor_at.append((p, nf))
    want = [2.0 if not [f for p, f in floor_at if p < r]
            else [f for p, f in floor_at if p < r][-1] for r in reads]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert len(set(got)) > 3
