"""GPU smoke test of the PyTorch/CUDA port (dumpvdl2_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each must pass; any failure exits non-zero):

1. build: compile every kernel in dumpvdl2_tpu_torch/csrc (one nvcc per
   source, in parallel) and print the card's name and power limit;
2. K1 (the sync-metric CUDA kernel) against its plain PyTorch version on
   the card, at the wideband main-path shape (256, 108 844) and at a
   ragged (5, 4321): identical inf masks, |d err| < 1e-3, |d freq| < 1e-5;
   kernel and plain timings, the bound, the launch count;
3. correctness vector: 8 channels at oversample 20 (2.1 Msps), a strong,
   a marginal and a near-cap (1990-octet) burst, fed through
   VDL2Pipeline(device="cuda").feed(..., eof=True); every frame must come
   back byte for byte on its channel (run twice, the second run timed);
4. wideband main path: 256 channels at oversample 80 (8.4 Msps), six
   device-resident blocks of 4 194 240 samples with 24 bursts on
   stride-4 channels through feed_planar + finish; all 24 payloads must
   decode and K1 must have launched on that run.  Prints the sustained
   ingest rate, the realtime factor, the per-block step breakdown and
   peak device memory.

The line before the last is the kernels JSON, the last line
{"ok": true, "device": {...}}.  Exits non-zero without a result when
no CUDA device is present.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from dumpvdl2_tpu_torch import kernels
from dumpvdl2_tpu_torch.constants import SPS, SYMBOL_RATE
from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
from dumpvdl2_tpu_torch.dsp import sync_kernel
from dumpvdl2_tpu_torch.dsp.frontend import to_planar
from dumpvdl2_tpu_torch.sim import frame_with_fcs, synthesize_iq_raw

CENTER = 136.975e6
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
# K1 float operations per output sample: 16 ramp subtractions, 15
# differences, 30 unwrap compares, 45 adds (adjustment, running sum,
# unwrapped value), 16 adds + 1 divide (mean), 16 subtractions
# (de-mean), 32 multiply-adds + 1 divide (slope), 64 for the residual
# (multiply, subtract, square, add).
K1_FLOPS_PER_SAMPLE = 16 + 15 + 30 + 45 + 17 + 16 + 33 + 64
WIDEBAND_BLOCK = 52428 * 80     # multiple of 80 nearest 2**22
WIDEBAND_BLOCKS = 6             # the EOF flush is paid once per stream


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_k1(C: int, M: int, seed: int) -> dict:
    """K1 against its plain version on one (C, M) input on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ph = (torch.rand((C, M), generator=gen, device="cuda") * 2 - 1) * np.pi
    e_k, f_k = sync_kernel.sync_error_metric_cuda(ph)
    e_p, f_p = sync_kernel.sync_error_metric_plain(ph)
    torch.cuda.synchronize()
    inf_k, inf_p = torch.isinf(e_k), torch.isinf(e_p)
    if not torch.equal(inf_k, inf_p):
        raise AssertionError(f"K1 inf mask differs at {(C, M)}")
    fin = ~inf_p
    d_err = (e_k[fin] - e_p[fin]).abs().max().item() if fin.any() else 0.0
    d_freq = (f_k - f_p).abs().max().item()
    log(f"K1 {(C, M)}: max|d err| {d_err:.3e} (< 1e-3), "
        f"max|d freq| {d_freq:.3e} (< 1e-5)")
    if not (d_err < 1e-3 and d_freq < 1e-5):
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"{(C, M)}")
    ms = cuda_ms(lambda: sync_kernel.sync_error_metric_cuda(ph), 50)
    plain_ms = cuda_ms(lambda: sync_kernel.sync_error_metric_plain(ph), 5)
    nbytes = 12 * C * M                  # read phases, write err + freq
    flops = K1_FLOPS_PER_SAMPLE * C * max(M - sync_kernel.LOOKBACK, 0)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    return {"shape": [C, M], "max_abs_err": d_err, "max_abs_freq_err": d_freq,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def correctness_vector() -> dict:
    """Three-burst vector (strong / marginal / near-cap), 8 channels at
    oversample 20, through the port's pipeline on the card."""
    os_, C = 20, 8
    fs = SYMBOL_RATE * SPS * os_
    rng = np.random.default_rng(1)
    nfloor = 0.01
    vector = [  # (name, payload, amplitude, carrier offset)
        ("strong", b"bench correctness gate \x01\x02", 0.5, -25e3),
        ("marginal", b"bench marginal-snr burst", nfloor, -25e3),
        ("near-cap", bytes(rng.integers(0, 256, 1990, dtype=np.uint8)),
         0.5, 0.0),
    ]
    gap = 60000
    bursts = [synthesize_iq_raw([p], oversample=os_, carrier_offset_hz=off,
                                seed=7 + i)
              for i, (_, p, _, off) in enumerate(vector)]
    total = sum(b.size for b in bursts) + gap * (len(bursts) + 1)
    sig = (rng.standard_normal(total) + 1j * rng.standard_normal(total)) \
        .astype(np.complex64) * (nfloor / np.sqrt(2))
    pos = gap
    for b, (_, _, amp, _) in zip(bursts, vector):
        sig[pos:pos + b.size] += b * amp
        pos += b.size + gap
    # the first pass also pays one-time set-up (cuBLAS handles, the
    # allocator's pools); the second is timed
    for attempt in range(2):
        pipe = VDL2Pipeline([int(CENTER - 25e3 * i) for i in range(C)],
                            int(CENTER), int(fs), os_, device="cuda")
        t0 = time.perf_counter()
        frames = pipe.feed(sig, eof=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = [(bytes(f.frame), f.metadata.freq) for f in frames]
        for name, payload, _, off in vector:
            if (frame_with_fcs(payload), int(CENTER + off)) not in got:
                raise AssertionError(f"correctness vector failed [{name}]: "
                                     f"{[(g[:24], fr) for g, fr in got]}")
    msps = sig.size / dt / 1e6
    log(f"correctness vector OK: strong + marginal + near-cap "
        f"({len(frames)} frames); {sig.size} samples in {dt:.4f} s -> "
        f"{msps:.3f} Msamples/s, realtime factor {msps / (fs / 1e6):.3f} "
        f"against {fs / 1e6} Msps")
    return {"msamples_per_s": msps, "realtime_factor": msps / (fs / 1e6)}


def wideband_scene(seed: int = 7):
    """256-channel, 8.4 Msps span on the card: noise plus 24 bursts on
    stride-4 channels, staggered over WIDEBAND_BLOCKS blocks."""
    os_, C = 80, 256
    fs = SYMBOL_RATE * SPS * os_
    freqs = [int(CENTER - 25e3 * (i - C // 2)) for i in range(C)]
    total = WIDEBAND_BLOCK * WIDEBAND_BLOCKS
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sig = torch.randn((2, total), generator=gen, device="cuda") * 0.02
    n_active = 24
    active = rng.choice(np.arange(0, C, 4), size=n_active, replace=False)
    payloads = [b"wideband e2e burst ch%03d payload " % ch * 4
                for ch in active]
    for k, (ch, payload) in enumerate(zip(active, payloads)):
        burst = synthesize_iq_raw([payload], oversample=os_,
                                  carrier_offset_hz=freqs[ch] - CENTER,
                                  seed=int(ch))
        off = 60000 + (k * (total - 2 * 60000 - burst.size)) // n_active
        sig[:, off:off + burst.size] += torch.as_tensor(
            to_planar(burst * 0.5), device="cuda")
    want = [(frame_with_fcs(p), freqs[ch]) for ch, p in zip(active, payloads)]
    return freqs, int(fs), os_, sig, want


def run_wideband(freqs, fs, os_, sig, step_ms=None):
    pipe = VDL2Pipeline(freqs, int(CENTER), fs, os_, device="cuda")
    pipe.step_ms = step_ms
    frames = []
    for b in range(WIDEBAND_BLOCKS):
        frames += pipe.feed_planar(
            sig[:, b * WIDEBAND_BLOCK:(b + 1) * WIDEBAND_BLOCK])
    t0 = time.perf_counter()
    frames += pipe.finish()
    torch.cuda.synchronize()
    if step_ms is not None:
        # the EOF flush runs once per stream, not per block
        step_ms["finish_once"] = (time.perf_counter() - t0) * 1e3
    return frames


def wideband_main_path() -> tuple[int, dict]:
    freqs, fs, os_, sig, want = wideband_scene()
    # warm-up on a fresh pipeline: library handles, allocator pools
    run_wideband(freqs, fs, os_, sig[:, :WIDEBAND_BLOCK].contiguous()
                 .repeat(1, WIDEBAND_BLOCKS))

    torch.cuda.reset_peak_memory_stats()
    sync_kernel.launches = 0
    t0 = time.perf_counter()
    frames = run_wideband(freqs, fs, os_, sig)
    dt = time.perf_counter() - t0
    k1_launches = sync_kernel.launches
    peak = torch.cuda.max_memory_allocated()

    got = {(bytes(f.frame), f.metadata.freq) for f in frames}
    missing = [w for w in want if w not in got]
    if missing:
        raise AssertionError(f"wideband: {len(missing)} of {len(want)} "
                             f"payloads missing, e.g. {missing[0]}")
    if k1_launches < 1:
        raise AssertionError("wideband main path never launched K1")
    n = WIDEBAND_BLOCK * WIDEBAND_BLOCKS
    msps = n / dt / 1e6
    log(f"wideband: {len(want)}/{len(want)} payloads decoded "
        f"({len(frames)} frames), K1 launches on the main path: "
        f"{k1_launches}")
    log(f"wideband: {n} samples in {dt:.4f} s -> {msps:.3f} Msamples/s "
        f"sustained, realtime factor {msps / (fs / 1e6):.3f} "
        f"against {fs / 1e6} Msps")
    log(f"wideband: peak device memory {peak / 2**30:.3f} GiB")

    step_ms: dict = {}
    run_wideband(freqs, fs, os_, sig, step_ms)
    finish_ms = step_ms.pop("finish_once")
    per_block = {k: v / WIDEBAND_BLOCKS for k, v in step_ms.items()}
    log("wideband per-block ms (synchronized breakdown run): " +
        ", ".join(f"{k} {v:.3f}" for k, v in per_block.items()) +
        f"; EOF finish() once {finish_ms:.3f}")
    return k1_launches, {"msamples_per_s": msps,
                         "realtime_factor": msps / (fs / 1e6),
                         "peak_bytes": peak, "per_block_ms": per_block,
                         "finish_ms": finish_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    built = kernels.build_all()
    for name, info in built.items():
        log(f"build {name}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            log(f"  {line}")
    card = card_line()
    log(card)

    k1_main = check_k1(256, 108844, seed=0)
    k1_ragged = check_k1(5, 4321, seed=1)
    log(f"K1 at {k1_main['shape']}: kernel {k1_main['ms']:.4f} ms, plain "
        f"{k1_main['plain_ms']:.4f} ms, bound {k1_main['bound_ms']:.4f} ms "
        f"({k1_main['bound_by']})")
    log(f"K1 at {k1_ragged['shape']}: kernel {k1_ragged['ms']:.4f} ms, "
        f"plain {k1_ragged['plain_ms']:.4f} ms")

    vec = correctness_vector()
    k1_launches, wb = wideband_main_path()

    kernels_line = {"kernels": [{
        "name": "sync_error_metric",
        "route": "cuda",
        "source": "dumpvdl2_tpu_torch/csrc/sync_metric.cu",
        "replaces": "dumpvdl2_tpu/dsp/sync_pallas.py:117",
        "launches": k1_launches,
        "max_abs_err": max(k1_main["max_abs_err"], k1_ragged["max_abs_err"]),
        "ms": k1_main["ms"],
        "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"],
        "bound_by": k1_main["bound_by"],
        "library_ms": None,
    }]}
    log(json.dumps({"wideband": wb, "vector": vec, "card": card}))
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
