"""The benchmark's one traffic generator: a deployment (configs/*.json)
and a traffic mix (traffic/*.json) in, a seeded scene out.

A scene is a schedule of bursts over a span of raw samples and the
samples themselves, made on the device.  What varies with the seed is
the order: every seed gets the same number of bursts on each channel,
the same multiset of lengths and levels and the same arrival times
(evenly spaced), and draws only which burst comes at which arrival, so
a seed changes the arrangement and not the amount of work, nor how it
falls into blocks.

Mix keys (all numbers; see the README for their meaning):

``noise_rms`` Gaussian noise per I/Q component over the whole span;
``channels``  ``{"stride": s, "active": n}``: n of the config's channels
              whose index is a multiple of s carry traffic, chosen by
              the seed (all of them when n equals their number);
``bursts_per_s`` the whole span's rate, or ``per_channel_bursts_per_s``;
``lengths``   ``[{"share", "min", "max"}]``: payload octets, each band's
              share of the bursts spread evenly over [min, max];
``levels``    ``[{"share", "amplitude"}]``: burst amplitudes;
``gap_symbols`` least silence between two bursts a channel keeps (one
              burst a channel at a time, as CSMA gives);
``edge_symbols`` silence at either end of the span;
``freq_error_hz`` each burst's carrier error, spread evenly over
              [-x, x].
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from . import synth

SYMBOL_RATE = synth.SYMBOL_RATE


def channel_freqs(cfg: dict) -> list[int]:
    """The deployment's channel frequencies, Hz: index i at ``first_hz``
    less ``spacing_hz`` times i (from the top of the band down)."""
    C, sp = int(cfg["channels"]), int(cfg["spacing_hz"])
    return [int(cfg["first_hz"] - sp * i) for i in range(C)]


def center_freq(cfg: dict) -> int:
    """The tuner's center, by the CLI's rule: the middle of the lowest
    and highest channel."""
    f = channel_freqs(cfg)
    return (min(f) + max(f)) // 2


def sample_rate(cfg: dict) -> int:
    return SYMBOL_RATE * synth.SPS * int(cfg["oversample"])


def seed_words(seed: int, label: str) -> list[int]:
    """Entropy for numpy from any integer seed (negative or above 2**63)
    and a label, so each use draws its own stream."""
    s = int(seed) % (1 << 128)
    return [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, (s >> 64) & 0xFFFFFFFF,
            (s >> 96) & 0xFFFFFFFF, zlib.crc32(label.encode())]


def torch_seed(seed: int, label: str) -> int:
    return int(np.random.SeedSequence(seed_words(seed, label))
               .generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def _spread(n: int, lo: float, hi: float) -> np.ndarray:
    """n values spread evenly over [lo, hi], ends included."""
    if n <= 0:
        return np.zeros(0)
    if n == 1:
        return np.array([(lo + hi) / 2.0])
    return np.linspace(lo, hi, n)


def _shares(n: int, bands: list[dict]) -> np.ndarray:
    """How many of n items each band gets (largest remainder)."""
    raw = np.array([b["share"] for b in bands], float) * n
    raw /= max(np.array([b["share"] for b in bands]).sum(), 1e-12)
    got = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - got))[: n - got.sum()]:
        got[i] += 1
    return got


@dataclasses.dataclass
class Scene:
    """A scheduled span: ``freqs``, ``fs``, ``oversample``, ``center``,
    ``n_samples`` raw samples, and a row a burst (sorted by start):
    ``start``/``end`` raw sample of its first and last sample,
    ``channel`` index, ``amplitude``, ``offset_hz`` its
    carrier against the center, ``carrier0`` starting phase, ``bursts``
    (synth.BurstBits: frame, bits, RS table, datalen)."""
    freqs: list
    fs: int
    oversample: int
    center: int
    n_samples: int
    start: np.ndarray
    end: np.ndarray
    channel: np.ndarray
    amplitude: np.ndarray
    offset_hz: np.ndarray
    carrier0: np.ndarray
    bursts: list
    noise_rms: float

    def payload_index(self) -> dict:
        """frame bytes (with FCS) -> burst row."""
        return {b.frame: i for i, b in enumerate(self.bursts)}


def _max_symbols(octets: int) -> int:
    """Symbols on air of a burst of at most ``octets`` payload octets:
    FCS, flags, at most one stuffed bit in five, RS parity, header and
    preamble."""
    bits = 16 + (octets + 2) * 8 * 6 // 5 + 1
    doct = (bits + 7) // 8
    _, _, fec = synth.burst_geometry(doct)
    return len(synth.PREAMBLE_PHASE_UNITS) + -(-(synth.HEADER_LEN
                                                   + 8 * (doct + fec)) // 3)


def _payload(tag: bytes, n: int, rng: np.random.Generator) -> bytes:
    """n octets: a unique tag, then printable filler."""
    body = tag + bytes(rng.integers(0x20, 0x7F, max(n - len(tag), 0),
                                    dtype=np.uint8))
    return body[:n] if n >= len(tag) else tag[:n]


def schedule(cfg: dict, mix: dict, seed: int, n_samples: int) -> Scene:
    """Place the mix's bursts on ``n_samples`` raw samples (no samples
    made yet)."""
    freqs = channel_freqs(cfg)
    fs, os_ = sample_rate(cfg), int(cfg["oversample"])
    center = center_freq(cfg)
    spsym = synth.SPS * os_
    dur_s = n_samples / fs
    rng = np.random.default_rng(seed_words(seed, "schedule"))

    stride = int(mix["channels"]["stride"])
    eligible = np.arange(0, len(freqs), stride)
    n_active = int(mix["channels"]["active"])
    active = np.sort(rng.choice(eligible, size=n_active, replace=False))
    # arrivals fall in the span's first 85 % (after its edge, before room
    # for the longest burst), which leaves the rest for the queueing below
    edge = int(mix["edge_symbols"]) * spsym
    longest = _max_symbols(max(b["max"] for b in mix["lengths"])) * spsym
    arrive = int(0.85 * (n_samples - 2 * edge - longest))
    if arrive <= 0:
        raise ValueError("span too short for the mix")
    if "per_channel_bursts_per_s" in mix:
        per = int(round(mix["per_channel_bursts_per_s"] * arrive / fs))
        chan = np.repeat(active, per)
    else:
        n = int(round(mix["bursts_per_s"] * arrive / fs))
        chan = np.resize(active, n)
    n = chan.size
    rng.shuffle(chan)

    lengths = np.concatenate([
        np.round(_spread(k, b["min"], b["max"])).astype(int)
        for k, b in zip(_shares(n, mix["lengths"]), mix["lengths"])])
    lvl_n = _shares(n, mix["levels"])
    amps = np.concatenate([np.full(k, float(b["amplitude"]))
                           for k, b in zip(lvl_n, mix["levels"])])
    order = rng.permutation(n)
    lengths, amps = lengths[order], amps[order]
    ferr = _spread(n, -mix.get("freq_error_hz", 0.0),
                   mix.get("freq_error_hz", 0.0))[rng.permutation(n)]
    carrier0 = rng.uniform(0.0, 2.0 * np.pi, n)

    tag = b"%08x" % (zlib.crc32(b"%d" % int(seed)) & 0xFFFFFFFF)
    pay_rng = np.random.default_rng(seed_words(seed, "payload"))
    payloads = [_payload(b"VDL2BENCH %s %06d " % (tag, i), int(lengths[i]),
                         pay_rng) for i in range(n)]
    bursts = synth.build_bursts(payloads)
    nsamp = np.array([synth.n_symbols(b.bits) * spsym for b in bursts],
                     np.int64)

    gap = int(mix["gap_symbols"]) * spsym
    last_ok = n_samples - edge
    want = edge + (np.arange(n) + 0.5) * (arrive / n)
    free = np.zeros(len(freqs), np.int64)    # next start allowed a channel
    start = np.zeros(n, np.int64)
    for i in np.argsort(want, kind="stable"):
        c = int(chan[i])
        start[i] = max(int(want[i]), int(free[c]))
        end = start[i] + int(nsamp[i])
        if end > last_ok:
            raise ValueError(f"mix overfills the span: burst {i} ends at "
                             f"{end} > {last_ok}")
        free[c] = end + gap
    srt = np.argsort(start, kind="stable")
    offset = np.array([freqs[c] - center for c in chan], float) + ferr
    return Scene(freqs=freqs, fs=fs, oversample=os_, center=center,
                 n_samples=int(n_samples), start=start[srt],
                 end=(start + nsamp - 1)[srt], channel=chan[srt],
                 amplitude=amps[srt],
                 offset_hz=offset[srt], carrier0=carrier0[srt],
                 bursts=[bursts[i] for i in srt],
                 noise_rms=float(mix["noise_rms"]))


def render(scene: Scene, seed: int, device) -> torch.Tensor:
    """The scene's planar (2, n_samples) float32 samples on ``device``:
    the noise from a generator on the device, then every burst."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, "noise"))
    sig = torch.randn((2, scene.n_samples), generator=gen, device=device)
    sig.mul_(scene.noise_rms)
    synth.render(sig, scene.start,
                 [synth.symbol_phases(b.bits) for b in scene.bursts],
                 scene.amplitude, scene.offset_hz, scene.carrier0,
                 float(scene.fs), scene.oversample)
    return sig
