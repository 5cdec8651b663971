"""GPU smoke test of the PyTorch/CUDA port (dumpvdl2_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each must pass; any failure exits non-zero):

1. build: compile every kernel in dumpvdl2_tpu_torch/csrc (one nvcc per
   source, in parallel) and the native host library
   (dumpvdl2_tpu_torch/native/l2host.c, with the system C compiler),
   and print the card's name and power limit;
2. K1 (the sync-metric CUDA kernel) against its plain PyTorch version on
   the card: random phases at the wideband main-path shape (256, 108 844)
   and at ragged shapes (rows of every length mod 4, tile edges, 70 000
   channels), identical inf masks, |d err| < 1e-3, |d freq| < 1e-5; the
   real phases of the wideband scene's first block, identical detection
   masks; kernel and plain timings and the bound at the main shape;
3. G1 and G2 (the gate kernels, csrc/gate.cu) against their plain
   PyTorch versions on the card.  G1 (verdicts, gate state and the hold
   decisions) on random grids at the wideband shape (C = 256, K = 64
   slots), edge cases (one channel, ragged channel counts, no L2 rows,
   indices that wrap int32, negative bit counts) and the real gate
   inputs of a wideband block: every output equal.  G2 (nf_track, the
   noise-floor tracker) on random grids at the wideband shape (W =
   17 476 columns, a ring of 32 768, K = 64), with ring replay, with
   persisting holds, at W = 0, with no crossings, with inverted windows,
   at ragged shapes, and on the real inputs of a wideband block: the
   count and the crossing columns equal, the floats within rtol 1e-5,
   atol 1e-7.  Device (profiler) and wrapper-call times, the plain
   versions' times and the bounds;
4. correctness vector: 8 channels at oversample 20 (2.1 Msps), a strong,
   a marginal and a near-cap (1990-octet) burst, fed through
   VDL2Pipeline(device="cuda").feed(..., eof=True); every frame must come
   back byte for byte on its channel (run twice, the second run timed);
5. wideband main path, device-gated (the default): 256 channels at
   oversample 80 (8.4 Msps), six device-resident blocks of 4 194 240
   samples with 24 bursts on stride-4 channels through feed_planar +
   finish; all 24 payloads must decode; K1, G1 and G2 must each have
   launched 7 times on that run (6 blocks + EOF), and no plain version
   of a gate kernel may have run; the native library's unstuffing must
   have been called on that run and the Python spec (_frames_py) never.
   Prints the sustained ingest rate, the realtime
   factor, the per-block step breakdown, the finish() time and peak
   device memory;
6. the host-gated path (device_gate=False) on the same scene: all its
   payloads must decode and its frames equal the gated run's (bytes and
   freq exact, nf_pwr_dbfs within 1e-4 dB); its realtime factor and
   breakdown beside the gated ones;
7. the CLI on the card: the correctness vector written as an S16_LE file
   and decoded by ``python3 -m dumpvdl2_tpu_torch`` (default platform,
   the GPU) in a subprocess; it must exit 0 and give one JSON record
   per burst on its frequency;
8. host L2 (device_l2=False, host-gated): the correctness vector and the
   first two blocks of the wideband scene; the frames must equal the
   device-L2 host-gated run's on the same span (bytes, freq and idx
   exact, nf_pwr_dbfs within 1e-4 dB) and every payload in the span must
   decode; wall times of both;
9. G1 against its plain version on random merged slot grids,
   K' = Tn*K = 128, 256 and 512; for each mesh shape, K1 against its
   plain version on every shard's phase plane of a real block ((256,
   H + Ml + F) at (1, 2), (128, H + Ml + F) at (2, 2); identical
   detection masks) and G1 on that block's real merged (C, Tn*K) grid;
   then the mesh path (MeshPipeline,
   device-gated) on the whole wideband scene at mesh shapes (1, 2) and
   (2, 2), the shards on distinct GPUs where there are enough, else on
   cuda:0 repeated: 24/24 payloads, the
   frames equal to the single-device gated run's (bytes, freq and idx
   exact, nf_pwr_dbfs within 1e-4 dB); K1 launched once per shard a
   block plus once at EOF, G1 and G2 once a block plus once at EOF, no
   plain version run.  Realtime factor, peak memory, the blocks re-read
   from the raw tail and the shards' devices are printed;
10. the multi-process path (parallel/multihost.py): ``init_distributed()``
   is a no-op without WORLD_SIZE; two ranks of
   dumpvdl2_tpu_torch/tools/multihost_worker.py --scene wideband, each
   on cuda:0 twice, join a gloo group on a localhost port and each runs
   one (1, 2) row of the global (2, 2) mesh on 128 of the 256 channels
   over the first two wideband blocks with carried state; each rank's
   count, det_idx, sync_idx and sym_valid must equal its channel columns
   of a single-process (2, 2) sharded step on cuda:0 repeated, exactly,
   and its K1 launches must be Tn = 2 a block with no plain version run.
   Each rank's peak device memory is printed.  A rank that fails, hangs
   or exits non-zero fails the run;
11. the stage profile (dumpvdl2_tpu_torch/tools/profile_wideband_e2e.py):
   the gated single-device block staged three times (dispatch, device,
   fetch with its bytes, host) and traced once (device busy and idle
   share, kernel launches, top ops, idle gaps), its frames equal to
   feed_planar's; a steady feed_planar block traced as it runs; the
   mesh (1, 2) block's per-step split and trace;
12. the host library (dumpvdl2_tpu_torch/native): on every burst
   stream the gated wideband run unstuffs, and on 2 000 seeded fuzz
   streams, the C unstuffing and FCS equal the Python spec's exactly
   (frames, error, order, CRC); the gated run's frames written as a
   raw-frame archive decode to equal DecodedFrames through the C parser
   and the Python spec; the unstuff + FCS milliseconds a block with
   each; the library's call counts.

The line before the last is the kernels JSON, the last line
{"ok": true, "device": {...}}.  Exits non-zero without a result when
no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dumpvdl2_tpu_torch import burst, kernels, native
from dumpvdl2_tpu_torch.constants import SPS, SYMBOL_RATE, SYNC_THRESHOLD
from dumpvdl2_tpu_torch.core import gate_kernel
from dumpvdl2_tpu_torch.core.device import process_block_detect
from dumpvdl2_tpu_torch.core.pipeline import DEFAULT_HALO, VDL2Pipeline
from dumpvdl2_tpu_torch.dsp import sync_kernel
from dumpvdl2_tpu_torch.io import rawframes
from dumpvdl2_tpu_torch.link import crc, unstuff
from dumpvdl2_tpu_torch.sim import (WIDEBAND_BLOCK, WIDEBAND_BLOCKS,
                                    frame_with_fcs, synthesize_iq_raw,
                                    wideband_scene)

# The mesh is imported where it is used, so that the single-device
# helpers here also drive a checkout of the port from before the mesh
# (dumpvdl2_tpu_torch/tools/e2e_turns.py).

CENTER = 136.975e6
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
ISSUE_LANES_PER_SM = 128        # 4 schedulers x 32 lanes, 1 instruction/clock
# K1's least instructions per output sample (n >= 150), by kind.  A
# multiply-add counts once only where it can fuse; compares, selects and
# lone adds count 1 each.  Subtracting the three zero preamble phases
# needs no instruction.  An unwrap step takes three: one compare of |d|
# with pi (the absolute value is an operand modifier), copysign(2 pi, d)
# as one logic op, and cum - that under the compare's predicate; like
# the plain version, |d| == pi and NaN add nothing.
K1_OPS_PER_OUTPUT = {
    # de-ramp 13, differences 15, unwrapped values 15, mean sum 15,
    # de-mean 16
    "add": 13 + 15 + 15 + 15 + 16,
    "compare": 15,              # |d| > pi per unwrap step
    "copysign": 15,             # +-2 pi with the sign of d
    "conditional add": 15,      # the running unwrap sum
    "multiply": 2,              # mean (x 1/16) and slope (x 1/340)
    "fma": 16 + 16 + 16,        # slope, residual, residual sum of squares
}
# Ragged K1 shapes: rows of every length mod 4 (unaligned row starts),
# the first output at n = 150, one and two tiles plus one output, and
# more channels than a grid dimension holds.
K1_RAGGED = [(5, 4321), (1, 150), (1, 151), (1, 2198), (1, 2199),
             (1, 2721), (2, 2870), (2, 2871), (3, 5441), (70000, 200)]
# Gate kernels' least instructions.  G1: per candidate slot (the
# compares of the decision chain, the row gather, the ppm product and
# quotient, the busy and watermark updates) and per channel (the hold
# decisions).  G2: per stream column it reads (the range and window
# tests, the EMA's two multiplies and an add, the count), per floor
# update (two multiplies, a min, two adds) and per candidate (its
# window's two searches and the search of its reading, ~6 steps each).
# Both move more bytes than they issue instructions, so their bound is
# set by bytes.
G1_OPS_PER_SLOT = 20
G1_OPS_PER_CHANNEL = 15
G2_OPS_PER_COLUMN = 6
G2_OPS_PER_CROSSING = 5
G2_OPS_PER_READ = 18
REPO = os.path.dirname(os.path.abspath(__file__))


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


def device_ms(fn, reps: int, kernel: str) -> float | None:
    """Mean device milliseconds a call of the CUDA kernels whose name
    contains ``kernel``, over ``reps`` calls of ``fn()``, from the
    torch.profiler's kernel records; None when it records none.  Unlike
    cuda_ms, host time between launches does not count."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
    return total_us / reps / 1e3 if total_us > 0 else None


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def k1_bound(C: int, M: int, sms: int, clock_hz: float) -> dict:
    """Least time for K1 on a (C, M) input: the larger of its bytes
    (read the phases, write err and freq) over the memory rate and its
    least instructions (K1_OPS_PER_OUTPUT per output with n >= 150) over
    the card's issue rate."""
    outputs = C * max(M - sync_kernel.LOOKBACK, 0)
    bytes_ms = 12 * C * M / HBM_BYTES_PER_S * 1e3
    ops = sum(K1_OPS_PER_OUTPUT.values()) * outputs
    ops_ms = ops / (ISSUE_LANES_PER_SM * sms * clock_hz) * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def compare_k1(ph: torch.Tensor, label: str,
               kernel=sync_kernel.sync_error_metric_cuda
               ) -> tuple[dict, tuple]:
    """``kernel`` (K1, or a build of a variant of its source) against the
    plain version on the card's ``ph``: identical inf masks,
    |d err| < 1e-3, |d freq| < 1e-5."""
    e_k, f_k = kernel(ph)
    e_p, f_p = sync_kernel.sync_error_metric_plain(ph)
    torch.cuda.synchronize()
    inf_k, inf_p = torch.isinf(e_k), torch.isinf(e_p)
    if not torch.equal(inf_k, inf_p):
        raise AssertionError(f"K1 inf mask differs on {label}")
    fin = ~inf_p
    d_err = (e_k[fin] - e_p[fin]).abs().max().item() if fin.any() else 0.0
    d_freq = (f_k - f_p).abs().max().item()
    log(f"K1 {label}: max|d err| {d_err:.3e} (< 1e-3), "
        f"max|d freq| {d_freq:.3e} (< 1e-5)")
    if not (d_err < 1e-3 and d_freq < 1e-5):
        raise AssertionError(f"K1 disagrees with its plain version on "
                             f"{label}")
    return {"max_abs_err": d_err, "max_abs_freq_err": d_freq}, (e_k, e_p)


def random_phases(C: int, M: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.rand((C, M), generator=gen, device="cuda") * 2 - 1) * np.pi


def check_k1(C: int, M: int, seed: int) -> dict:
    """K1 against its plain version on random phases of shape (C, M)."""
    return compare_k1(random_phases(C, M, seed), str((C, M)))[0]


def time_k1(C: int, M: int, seed: int) -> dict:
    """Kernel and plain-version times on random (C, M) phases, and the
    bound on this card."""
    ph = random_phases(C, M, seed)
    ms = cuda_ms(lambda: sync_kernel.sync_error_metric_cuda(ph), 50)
    prof_ms = device_ms(lambda: sync_kernel.sync_error_metric_cuda(ph), 20,
                        "sync_metric_kernel")
    plain_ms = cuda_ms(lambda: sync_kernel.sync_error_metric_plain(ph), 5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    bound = k1_bound(C, M, sms, clock)
    log(f"K1 at {(C, M)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; bytes "
        f"{bound['bytes_ms']:.4f}, issue {bound['ops_ms']:.4f} at "
        f"{sum(K1_OPS_PER_OUTPUT.values())} instructions/output, {sms} "
        f"SMs, {clock / 1e6:.0f} MHz); {ms / bound['bound_ms']:.2f}x the "
        f"bound; profiler device time {prof_ms} ms")
    return {"shape": [C, M], "ms": ms, "profiler_ms": prof_ms,
            "plain_ms": plain_ms, **bound}


def check_k1_real(freqs, fs, os_, sig) -> dict:
    """K1 against its plain version on the phase plane of the wideband
    scene's first block (real preambles): identical detection masks."""
    pipe = VDL2Pipeline(freqs, int(CENTER), fs, os_, device="cuda")
    _, phases, *_ = process_block_detect(
        sig[:, :WIDEBAND_BLOCK], pipe.taps, pipe.dphi, 0, pipe.carry,
        pipe.hist, os_, DEFAULT_HALO)
    res, (e_k, e_p) = compare_k1(phases.contiguous(), "wideband block 0 "
                                 f"{tuple(phases.shape)}")

    def detections(err):
        return (err[:, :-1] < SYNC_THRESHOLD) & (err[:, 1:] > err[:, :-1])

    m_k, m_p = detections(e_k), detections(e_p)
    if not torch.equal(m_k, m_p):
        raise AssertionError(f"K1 detection mask differs on the wideband "
                             f"block: {(m_k != m_p).sum().item()} samples")
    log(f"K1 wideband block 0: detection masks identical, "
        f"{int(m_k.sum().item())} detections")
    return res


def gate_grid(C: int, K: int, seed: int, B: int | None = None,
              base: int = 0, no_rows: bool = False,
              negative_bits: bool = False) -> tuple:
    """Random G1 inputs on the card (argument order of gate_kernel.gate
    without max_ppm, eof and end_rel): candidates in time order per
    channel, some with too few symbols, failed headers, L2 rows of -1
    and ppm far past 5, holds active or not, re-covered or not;
    ``base`` offsets every index (int32 wrap near 2^31)."""
    rng = np.random.default_rng(seed)
    B = C * K if B is None else B
    count = rng.integers(0, K + 1, C).astype(np.int32)
    det = np.full((C, K), -1, np.int64)
    for c in range(C):
        n = int(count[c])
        det[c, :n] = np.sort(rng.choice(np.arange(60, 3000 + 50 * K),
                                        size=n, replace=False))
    sync = np.where(det >= 0, det - rng.integers(1, 4, (C, K)), -1)
    det = ((det + base + 2**31) % 2**32 - 2**31).astype(np.int32)
    sync = ((sync + base + 2**31) % 2**32 - 2**31).astype(np.int32)
    sym_valid = np.where(rng.random((C, K)) < 0.2, rng.integers(0, 12, (C, K)),
                         rng.integers(0, 600, (C, K))).astype(np.int32)
    hdr_rows = rng.random(B) >= 0.3
    bits_rows = (3 * rng.integers(12, 500, B)
                 - rng.integers(0, 3, B)).astype(np.int32)
    if negative_bits:
        bits_rows = -bits_rows
    dphi = rng.normal(0.0, 0.004, (C, K))
    hot = rng.random((C, K)) < 0.15
    dphi = np.where(hot, rng.choice([-1.0, 1.0], (C, K))
                    * rng.uniform(0.65, 1.2, (C, K)), dphi).astype(np.float32)
    l2_row = np.where(rng.random((C, K)) < 0.05, -1,
                      rng.integers(0, B, (C, K))).astype(np.int32)
    if no_rows:
        l2_row[:] = -1
    busy = (rng.integers(0, 500, C) + base).astype(np.int64)
    busy = ((busy + 2**31) % 2**32 - 2**31).astype(np.int32)
    nxt = rng.integers(0, 500, C).astype(np.int32)
    hold = (rng.integers(-300, 3000 + 50 * K, C) + base).astype(np.int64)
    hold = ((hold + 2**31) % 2**32 - 2**31).astype(np.int32)
    hold_active = rng.random(C) < 0.5
    freqs = (CENTER + 25e3 * (np.arange(C) - C // 2)).astype(np.float32)
    return tuple(torch.as_tensor(x, device="cuda") for x in (
        count, det, sync, sym_valid, dphi, l2_row, hdr_rows, bits_rows,
        busy, nxt, hold, hold_active, freqs))


def compare_g1(args: tuple, max_ppm: float, eof: bool, end_rel: int,
               label: str) -> None:
    """G1 against its plain version: every output equal, the hold
    decisions and the tracker's bounds included."""
    g_k, bits_k, dec_k = gate_kernel.gate_cuda(*args, max_ppm, eof, end_rel)
    g_p, bits_p, dec_p = gate_kernel.gate_plain(*args, max_ppm, eof,
                                                end_rel)
    torch.cuda.synchronize()
    for name, k, p in [(key, g_k[key], g_p[key]) for key in g_p] \
            + [("bits", bits_k, bits_p)] \
            + [(key, dec_k[key], dec_p[key]) for key in dec_p]:
        if k.dtype != p.dtype or not torch.equal(k, p):
            n = (k != p).sum().item() if k.shape == p.shape else "all"
            raise AssertionError(f"G1 {name} differs on {label}: {n} values")


def track_grid(C: int, W: int, K: int, R: int, seed: int,
               replay: float = 0.0, persist: float = 0.0,
               negative_bits: bool = False, nfcnt_max: int = 1000) -> dict:
    """Random G2 inputs as numpy arrays: the block's f16-rounded
    magnitudes at positions H, H + 3, ...; candidates in time order
    (header rejects and accepts claim windows); the carried tracker and
    ring; the hold decisions that G1 hands over.  A share ``replay`` of
    the channels releases a hold and replays its ring through a filter,
    a share ``persist`` keeps its hold (no block column is tracked)."""
    rng = np.random.default_rng(seed)
    H = int(rng.integers(0, 200))
    end_rel = H + 3 * W
    span = max(end_rel, 600)

    def mag(shape):
        p = rng.exponential(0.02, shape) \
            * np.where(rng.random(shape) < 0.01, 400.0, 1.0)
        return np.sqrt(p).astype(np.float16).astype(np.float32)

    codes = np.array([0, 1, 2, 3, 5, 7, 8, 8, 5, 9, 10], np.int8)
    count = rng.integers(0, K + 1, C)
    verdicts = codes[rng.integers(0, codes.size, (C, K))]
    sync = np.sort(rng.integers(-300, span + 300, (C, K)), axis=1)
    empty = np.arange(K)[None, :] >= count[:, None]
    verdicts[empty] = 0
    sync = np.where(empty, -1, sync).astype(np.int32)
    bits = (3 * rng.integers(12, 400, (C, K))
            - rng.integers(0, 3, (C, K))).astype(np.int32)
    if negative_bits:
        bits = -bits
    persist_f = rng.random(C) < persist
    released = ~persist_f & (rng.random(C) < replay)
    ring_n = np.where(released | persist_f, rng.integers(1, R + 1, C),
                      rng.integers(0, R + 1, C)).astype(np.int32)
    ring_pos = np.sort(rng.integers(-6 * R - 2000, span, (C, R)), axis=1)
    live = np.arange(R)[None, :] < ring_n[:, None]
    ring_pos = np.where(live, ring_pos, -(1 << 30)).astype(np.int32)
    ring_val = np.where(live, mag((C, R)), 0.0).astype(np.float32)
    pick = ring_pos[np.arange(C), rng.integers(0, np.maximum(ring_n, 1))]
    ring_filter = np.where(rng.random(C) < 0.8, pick,
                           rng.integers(-500, 500, C)).astype(np.int32)
    return {
        "mags": mag((C, W)),
        "col_pos": (H + 3 * np.arange(W)).astype(np.int32),
        "verdicts": verdicts, "sync_idx": sync, "bits": bits,
        "busy0": rng.integers(-500, span // 2, C).astype(np.int32),
        "drop_end": np.where(rng.random(C) < 0.3,
                             rng.integers(-100, span // 2, C),
                             -(1 << 30)).astype(np.int32),
        "persist": persist_f, "released": released,
        "deferred": np.where(rng.random(C) < 0.3, rng.integers(0, span, C),
                             -1).astype(np.int32),
        "end_rel": end_rel, "ring_filter": ring_filter,
        "ring_pos": ring_pos, "ring_val": ring_val, "ring_n": ring_n,
        "mag_lp0": rng.uniform(0.0, 0.5, C).astype(np.float32),
        "mag_nf0": rng.uniform(0.01, 2.0, C).astype(np.float32),
        "nfcnt0": rng.integers(0, nfcnt_max, C).astype(np.int32)}


def track_args(grid: dict, device) -> tuple:
    """A track_grid as tensors on ``device``, in the argument order of
    gate_kernel.nf_track (low and f_track computed as G1 computes
    them)."""
    low = np.maximum(grid["busy0"], grid["drop_end"])
    f_track = np.where(grid["persist"], -(1 << 30),
                       np.where(grid["deferred"] >= 0, grid["deferred"],
                                grid["end_rel"])).astype(np.int32)
    return tuple(torch.as_tensor(x, device=device) for x in (
        grid["mags"], grid["col_pos"], grid["verdicts"], grid["sync_idx"],
        grid["bits"], low, f_track, grid["released"], grid["ring_filter"],
        grid["ring_pos"], grid["ring_val"], grid["ring_n"], grid["mag_lp0"],
        grid["mag_nf0"], grid["nfcnt0"]))


TRACK_OUT = ("mag_lp1", "mag_nf1", "nfcnt1", "nf_read", "jc")


def compare_track(args: tuple, label: str) -> dict:
    """G2 against its plain version: the count and the crossing columns
    equal, the floats within rtol 1e-5, atol 1e-7.  Returns the largest
    float differences and how many floor updates the grid reached."""
    out_k = gate_kernel.nf_track_cuda(*args)
    out_p = gate_kernel.nf_track_plain(*args)
    torch.cuda.synchronize()
    res = {"crossings": int((out_p[4] >= 0).sum().item())}
    for name, k, p in zip(TRACK_OUT, out_k, out_p):
        if k.dtype != p.dtype or k.shape != p.shape:
            raise AssertionError(f"G2 {name} on {label}: {k.dtype} "
                                 f"{tuple(k.shape)}, plain {p.dtype} "
                                 f"{tuple(p.shape)}")
        if not k.dtype.is_floating_point:
            if not torch.equal(k, p):
                raise AssertionError(f"G2 {name} differs on {label}: "
                                     f"{(k != p).sum().item()} values")
            continue
        if not torch.allclose(k, p, rtol=1e-5, atol=1e-7):
            bad = ((k - p).abs() > 1e-7 + 1e-5 * p.abs()).sum().item()
            raise AssertionError(f"G2 {name} differs on {label}: {bad} "
                                 f"values past rtol 1e-5")
        d = (k - p).abs()
        res[f"{name}_max_abs_err"] = d.max().item() if d.numel() else 0.0
        res[f"{name}_max_rel_err"] = (d / p.abs().clamp(min=1e-30)).max() \
            .item() if d.numel() else 0.0
    return res


def g1_bound(C: int, K: int, B: int, sms: int, clock_hz: float) -> dict:
    """Least time for G1: each input read once, each output written
    once, or its least instructions at the card's issue rate.  In:
    count, busy, next, hold, freqs (4 bytes) and hold_active (1) a
    channel; det, sync, sym_valid, l2_row, dphi (4) a slot; the (B,)
    header flags (1) and bit counts (4).  Out: verdicts (1) and bits (4)
    a slot; busy, next, deferred, drop_end, ring_filter, hold, low,
    f_track (4) and released, persist, hold_active (1) a channel."""
    nbytes = (5 * 4 + 1) * C + 5 * 4 * C * K + 5 * B \
        + 5 * C * K + (8 * 4 + 3) * C
    ops = G1_OPS_PER_SLOT * C * K + G1_OPS_PER_CHANNEL * C
    return _bound(nbytes, ops, sms, clock_hz)


def g2_bound(args: tuple, crossings: int, sms: int, clock_hz: float
             ) -> dict:
    """Least time for G2 on these inputs: the bytes it must move, each
    read or written once, or its least instructions at the card's issue
    rate.  Bytes: the (C, W) magnitudes; 8 a replayed ring slot
    (position and value, for released channels' slots < ring_n); 9 a
    candidate (verdict, sync, bits); per channel low, f_track, released,
    ring_filter, ring_n, mag_lp0, mag_nf0, nfcnt0 (29); out, mag_lp1,
    mag_nf1, nfcnt1 (12 a channel), nf_read (4 a candidate) and the
    floor updates' columns (4 a crossing slot, cap a channel).
    col_pos is read only by binary searches.  Operations: per column
    read, per floor update (``crossings``, the updates these inputs
    reach), per candidate."""
    (mags, _cp, verdicts, _s, _b, _lo, _ft, released, _rf, ring_pos, _rv,
     ring_n, _lp, _nf, nfcnt0) = args
    C, W = mags.shape
    K = verdicts.shape[1]
    R = ring_pos.shape[1]
    cap = (R + W) // gate_kernel.NF_EVERY + 1
    replayed = int(torch.where(released, ring_n, 0).sum().item())
    nbytes = 4 * C * W + 8 * replayed + 9 * C * K + 29 * C + 12 * C \
        + 4 * C * K + 4 * C * cap
    ops = G2_OPS_PER_COLUMN * (C * W + replayed) \
        + G2_OPS_PER_CROSSING * crossings + G2_OPS_PER_READ * C * K
    return _bound(nbytes, ops, sms, clock_hz)


def _bound(nbytes: int, ops: int, sms: int, clock_hz: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / (ISSUE_LANES_PER_SM * sms * clock_hz) * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def capture_gate_inputs(freqs, fs, os_, sig) -> tuple:
    """The arguments G1 and G2 get on the second wideband block of the
    gated pipeline (real candidates, L2 rows, magnitudes and floor
    crossings)."""
    calls = {"gate": [], "nf_track": []}
    orig = {k: getattr(gate_kernel, k) for k in calls}

    def spy(name):
        def fn(*a, **kw):
            calls[name].append((a, kw))
            return orig[name](*a, **kw)
        return fn

    pipe = VDL2Pipeline(freqs, int(CENTER), fs, os_, device="cuda")
    try:
        for k in calls:
            setattr(gate_kernel, k, spy(k))
        for b in range(2):
            pipe.feed_planar(sig[:, b * WIDEBAND_BLOCK:
                                 (b + 1) * WIDEBAND_BLOCK])
    finally:
        for k, fn in orig.items():
            setattr(gate_kernel, k, fn)
    pipe.finish()
    return calls["gate"][-1][0], calls["nf_track"][-1][0]


def check_gates(scene) -> tuple[dict, dict]:
    """G1 and G2 against their plain versions on random grids, edge
    cases and a real wideband block; their timings and bounds."""
    C, K, W, R = 256, 64, 17476, 32768
    cases = [("wideband (256, 64)", gate_grid(C, K, 1), 5.0, False),
             ("wideband (256, 64) eof", gate_grid(C, K, 2), 0.0, True),
             ("(1, 1)", gate_grid(1, 1, 3), 5.0, False),
             ("(300, 8) one L2 row", gate_grid(300, 8, 4, B=1), 5.0, False),
             ("(256, 64) no L2 rows", gate_grid(C, K, 5, no_rows=True),
              0.0, False),
             ("(256, 64) wrapping int32", gate_grid(C, K, 6, base=2**31 - 900),
              5.0, False),
             ("(129, 64) negative bits", gate_grid(129, K, 7,
                                                   negative_bits=True),
              5.0, True),
             ("(256, 100) two chain passes", gate_grid(C, 100, 8), 5.0,
              False)]
    for i, (label, args, max_ppm, eof) in enumerate(cases):
        compare_g1(args, max_ppm, eof, 3 * 17476 + 7 * i, label)
    ga, na = capture_gate_inputs(*scene[:4])
    compare_g1(ga[:13], *ga[13:], "real wideband block")
    log(f"G1: equal to its plain version on {len(cases) + 1} grids, "
        f"verdicts, state and hold decisions")

    grids = [
        ("wideband (256, 17 476, 64, ring 32 768)",
         track_grid(C, W, K, R, 10)),
        ("ring replay", track_grid(C, W, K, R, 11, replay=0.6)),
        ("persisting holds", track_grid(C, W, K, R, 12, persist=0.5,
                                        replay=0.3)),
        ("W = 0, ring replay", track_grid(C, 0, K, R, 13, replay=0.7)),
        ("no crossings", track_grid(C, 300, K, 512, 14, nfcnt_max=400)),
        ("inverted windows", track_grid(C, W, K, 4096, 15,
                                        negative_bits=True, replay=0.5)),
        ("(1, 1, 1, ring 1)", track_grid(1, 1, 1, 1, 16, replay=1.0)),
        ("(300, 5 000, 8, ring 48)", track_grid(300, 5000, 8, 48, 17,
                                                replay=0.5, persist=0.2)),
        ("(3, 9 000, 130, ring 9 000)", track_grid(3, 9000, 130, 9000, 18,
                                                   replay=1.0))]
    g2 = [compare_track(track_args(g, "cuda"), label) for label, g in grids]
    g2.append(compare_track(na, "real wideband block"))
    g2_err = max(v for r in g2 for k, v in r.items() if "abs_err" in k)
    g2_rel = max(v for r in g2 for k, v in r.items() if "rel_err" in k)
    log(f"G2: count and crossing columns equal to its plain version on "
        f"{len(g2)} grids, floats within rtol 1e-5 (max abs err "
        f"{g2_err:.3e}, max rel err {g2_rel:.3e}); floor updates per grid "
        f"{[r['crossings'] for r in g2]}")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    args = gate_grid(C, K, 1)
    targs = track_args(grids[0][1], "cuda")
    end_rel = 3 * W
    g1 = {**time_gate(lambda: gate_kernel.gate_cuda(*args, 5.0, False,
                                                    end_rel),
                      lambda: gate_kernel.gate_plain(*args, 5.0, False,
                                                     end_rel),
                      "gate_kernel"),
          **g1_bound(C, K, C * K, sms, clock), "max_abs_err": 0,
          "real_rows": ga[6].shape[0]}
    g2t = {**time_gate(lambda: gate_kernel.nf_track_cuda(*targs),
                       lambda: gate_kernel.nf_track_plain(*targs),
                       "nf_track_kernel"),
           **g2_bound(targs, g2[0]["crossings"], sms, clock),
           "max_abs_err": g2_err, "max_rel_err": g2_rel,
           "real": {"shape": list(na[0].shape), **g2[-1],
                    **time_gate(lambda: gate_kernel.nf_track_cuda(*na),
                                lambda: gate_kernel.nf_track_plain(*na),
                                "nf_track_kernel"),
                    **g2_bound(na, g2[-1]["crossings"], sms, clock)}}
    for name, t, shape in (("G1", g1, (C, K)), ("G2", g2t, (C, W, K, R)),
                           ("G2 real block", g2t["real"], (C, W, K, R))):
        log(f"{name} at {shape}: kernel {t['ms']:.4f} ms ({t['ms_from']}), "
            f"a wrapper call {t['call_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}; bytes {t['bytes_ms']:.6f}, issue "
            f"{t['ops_ms']:.6f}); {t['bound_ms'] / t['ms']:.3f} of the "
            f"bound")
    return g1, g2t


def time_gate(call, plain, kernel: str) -> dict:
    """A gate kernel's device time (profiler; CUDA events over back-to-
    back calls when the profiler records no kernel), the wall time of a
    wrapper call, and the plain version's time."""
    call_ms = cuda_ms(call, 200)
    ms = device_ms(call, 50, kernel)
    return {"ms": call_ms if ms is None else ms,
            "ms_from": "events" if ms is None else "profiler",
            "call_ms": call_ms, "plain_ms": cuda_ms(plain, 5)}


def vector_signal():
    """Three-burst vector (strong / marginal / near-cap) for 8 channels
    at oversample 20: the samples, their rate, the channels and the
    (name, payload, amplitude, offset) of each burst."""
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
    freqs = [int(CENTER - 25e3 * i) for i in range(C)]
    return sig, int(fs), os_, freqs, vector


def correctness_vector() -> dict:
    """The three-burst vector through the port's pipeline on the card."""
    sig, fs, os_, freqs, vector = vector_signal()
    # the first pass also pays one-time set-up (cuBLAS handles, the
    # allocator's pools); the second is timed
    for attempt in range(2):
        pipe = VDL2Pipeline(freqs, int(CENTER), fs, os_, device="cuda")
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


def cli_on_card() -> dict:
    """The correctness vector as an S16_LE file through the CLI in a
    subprocess, on its default platform (the GPU): exit 0 and one JSON
    record per burst on the burst's frequency.  A raw archive written in
    the same run ties each JSON record to its frame bytes."""
    sig, fs, os_, freqs, vector = vector_signal()
    with tempfile.TemporaryDirectory() as tmp:
        iq = os.path.join(tmp, "vector.s16")
        out = os.path.join(tmp, "out.json")
        raw = os.path.join(tmp, "out.frames")
        inter = np.empty(2 * sig.size, np.float32)
        inter[0::2], inter[1::2] = sig.real, sig.imag
        (np.clip(inter, -1, 1) * 32767).astype("<i2").tofile(iq)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "dumpvdl2_tpu_torch", "--iq-file", iq,
               "--sample-format", "S16_LE", "--oversample", str(os_),
               "--centerfreq", str(int(CENTER)),
               "--output", f"decoded:json:file:path={out}",
               "--output", f"raw:binary:file:path={raw}"] + \
            [str(f) for f in freqs]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=300)
        dt = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"CLI exited {r.returncode}: "
                                 f"{r.stderr[-2000:]}")
        with open(out) as f:
            recs = [json.loads(line)["vdl2"] for line in f if line.strip()]
        with open(raw, "rb") as f:
            frames = [(bytes(d.frame), d.metadata.freq)
                      for d in rawframes.read_records(f)]
    if len(recs) != len(frames):
        raise AssertionError(f"CLI: {len(recs)} JSON records for "
                             f"{len(frames)} frames")
    for name, payload, _, off in vector:
        want = (frame_with_fcs(payload), int(CENTER + off))
        hits = [rec for rec, fr in zip(recs, frames)
                if fr == want and rec["freq"] == want[1]]
        if len(hits) != 1:
            raise AssertionError(f"CLI: {len(hits)} JSON records for the "
                                 f"{name} burst on {want[1]} Hz")
    log(f"CLI on the card: exit 0, one JSON record per burst on its "
        f"frequency ({len(recs)} records with the neighbour channels'; "
        f"{dt:.2f} s with start-up)")
    return {"records": len(recs), "seconds": dt}


def run_wideband(freqs, fs, os_, sig, step_ms=None, device_gate=None):
    pipe = VDL2Pipeline(freqs, int(CENTER), fs, os_, device="cuda",
                        device_gate=device_gate)
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


def frames_by_key(frames) -> dict:
    return {(bytes(f.frame), f.metadata.freq, f.metadata.idx): f
            for f in frames}


def host_l2_phase(scene) -> dict:
    """Host L2 against device L2 (both host-gated) on the correctness
    vector and on the first two wideband blocks: equal frames, every
    payload of the span decoded, wall times."""
    out = {}
    sig, fs, os_, freqs, vector = vector_signal()
    runs = {}
    for l2 in (False, True):
        pipe = VDL2Pipeline(freqs, int(CENTER), fs, os_, device="cuda",
                            device_l2=l2, device_gate=False)
        t0 = time.perf_counter()
        frames = pipe.feed(sig, eof=True)
        torch.cuda.synchronize()
        runs[l2] = (frames, time.perf_counter() - t0)
    got = {(bytes(f.frame), f.metadata.freq) for f in runs[False][0]}
    for name, payload, _, off in vector:
        if (frame_with_fcs(payload), int(CENTER + off)) not in got:
            raise AssertionError(f"host L2: vector burst {name} missing")
    out["vector"] = {"d_nf_db": compare_frames(
        runs[True][0], runs[False][0], "host L2 vs device L2 (vector)"),
        "host_l2_s": runs[False][1], "device_l2_s": runs[True][1]}

    freqs, fs, os_, wsig, want, spans = scene
    n_blocks = 2
    span_n = n_blocks * WIDEBAND_BLOCK
    for l2 in (False, True):
        pipe = VDL2Pipeline(freqs, int(CENTER), fs, os_, device="cuda",
                            device_l2=l2, device_gate=False)
        t0 = time.perf_counter()
        frames = []
        for b in range(n_blocks):
            frames += pipe.feed_planar(
                wsig[:, b * WIDEBAND_BLOCK:(b + 1) * WIDEBAND_BLOCK])
        frames += pipe.finish()
        torch.cuda.synchronize()
        runs[l2] = (frames, time.perf_counter() - t0)
    inside = [w for w, (off, n, _) in zip(want, spans) if off + n <= span_n]
    got = {(bytes(f.frame), f.metadata.freq) for f in runs[False][0]}
    missing = [w for w in inside if w not in got]
    if missing or not inside:
        raise AssertionError(f"host L2 wideband: {len(missing)} of "
                             f"{len(inside)} payloads missing")
    d_nf = compare_frames(runs[True][0], runs[False][0],
                          "host L2 vs device L2 (wideband 2 blocks)")
    rt = {l2: span_n / runs[l2][1] / fs for l2 in runs}
    log(f"host L2 wideband (2 blocks, 256 channels): {len(inside)}/"
        f"{len(inside)} payloads of the span decoded; host L2 "
        f"{runs[False][1]:.3f} s (realtime factor {rt[False]:.3f}), device "
        f"L2 host-gated {runs[True][1]:.3f} s (realtime factor "
        f"{rt[True]:.3f}), with first-use set-up")
    out["wideband_2_blocks"] = {
        "payloads": len(inside), "d_nf_db": d_nf,
        "host_l2_s": runs[False][1], "device_l2_s": runs[True][1],
        "host_l2_realtime_factor": rt[False],
        "device_l2_realtime_factor": rt[True]}
    return out


def compare_frames(want: list, got: list, label: str) -> float:
    """Equal (bytes, freq, idx) sets and nf_pwr_dbfs within 1e-4 dB.
    Returns the largest noise-floor difference."""
    w, g = frames_by_key(want), frames_by_key(got)
    if set(w) != set(g):
        def show(keys):
            return sorted((k[1], k[2], len(k[0])) for k in keys)
        raise AssertionError(f"{label}: frames differ: only in the first "
                             f"(freq, idx, octets): {show(set(w) - set(g))}"
                             f", only in the second: {show(set(g) - set(w))}"
                             f", of {len(w)}")
    d_nf = max((abs(w[k].metadata.nf_pwr_dbfs - g[k].metadata.nf_pwr_dbfs)
                for k in w), default=0.0)
    if not d_nf <= 1e-4:
        worst = sorted(((abs(w[k].metadata.nf_pwr_dbfs
                             - g[k].metadata.nf_pwr_dbfs), k[1], k[2],
                         w[k].metadata.nf_pwr_dbfs, g[k].metadata.nf_pwr_dbfs)
                        for k in w), reverse=True)[:6]
        raise AssertionError(f"{label}: noise floors differ by "
                             f"{d_nf:.3e} dB; (|d|, freq, idx, first, "
                             f"second): {worst}")
    log(f"{label}: {len(w)} frames equal, max |d nf_pwr_dbfs| "
        f"{d_nf:.3e} dB (<= 1e-4)")
    return d_nf


def mesh_devices(shape: tuple[int, int]) -> list[str]:
    """Distinct GPUs for the shards where there are enough, else cuda:0
    repeated."""
    n = shape[0] * shape[1]
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * n


def run_mesh(scene, shape) -> tuple[list, list]:
    """The wideband scene through MeshPipeline: its frames and the raw
    starts of the blocks it re-read from its tail."""
    from dumpvdl2_tpu_torch.core.mesh_pipeline import MeshPipeline
    freqs, fs, os_, sig, _, _ = scene
    pipe = MeshPipeline(freqs, int(CENTER), fs, os_, mesh_shape=shape,
                        devices=mesh_devices(shape))
    rereads = []
    rebase = pipe._rebase_state

    def spy(base_raw):
        rereads.append(base_raw)
        return rebase(base_raw)

    pipe._rebase_state = spy
    frames = []
    for b in range(WIDEBAND_BLOCKS):
        frames += pipe.feed_planar(
            sig[:, b * WIDEBAND_BLOCK:(b + 1) * WIDEBAND_BLOCK])
    frames += pipe.finish()
    torch.cuda.synchronize()
    return frames, rereads


def capture_mesh_inputs(scene, shape) -> tuple[list, tuple]:
    """The phase planes K1 gets from each shard, and the arguments G1
    gets on the merged (C, Tn*K) slot grid, on the second wideband block
    of the gated mesh at ``shape``."""
    from dumpvdl2_tpu_torch.core.mesh_pipeline import MeshPipeline
    freqs, fs, os_, sig, _, _ = scene
    planes, gates = [], []
    orig_k1, orig_g1 = sync_kernel.sync_error_metric_cuda, gate_kernel.gate

    def k1(ph):
        planes.append(ph)
        return orig_k1(ph)

    def g1(*a):
        gates.append(a)
        return orig_g1(*a)

    pipe = MeshPipeline(freqs, int(CENTER), fs, os_, mesh_shape=shape,
                        devices=mesh_devices(shape))
    sync_kernel.sync_error_metric_cuda, gate_kernel.gate = k1, g1
    try:
        for b in range(2):
            pipe.feed_planar(sig[:, b * WIDEBAND_BLOCK:
                                 (b + 1) * WIDEBAND_BLOCK])
    finally:
        sync_kernel.sync_error_metric_cuda, gate_kernel.gate = orig_k1, orig_g1
    n = shape[0] * shape[1]
    return planes[n:2 * n], gates[-1]


def check_mesh_kernels(scene, shape) -> float:
    """K1 and G1 against their plain versions at the shapes the mesh
    path gives them: every shard's phase plane of a real block (equal
    inf and detection masks) and the real merged slot grid.  Returns
    K1's largest |d err|."""
    planes, ga = capture_mesh_inputs(scene, shape)
    err = 0.0
    for t, ph in enumerate(planes):
        res, (e_k, e_p) = compare_k1(ph, f"mesh {shape} shard {t} "
                                     f"{tuple(ph.shape)}")
        err = max(err, res["max_abs_err"])
        m_k = (e_k[:, :-1] < SYNC_THRESHOLD) & (e_k[:, 1:] > e_k[:, :-1])
        m_p = (e_p[:, :-1] < SYNC_THRESHOLD) & (e_p[:, 1:] > e_p[:, :-1])
        if not torch.equal(m_k, m_p):
            raise AssertionError(f"K1 detection mask differs on mesh "
                                 f"{shape} shard {t}")
    compare_g1(ga[:13], *ga[13:], f"mesh {shape} merged grid "
               f"{tuple(ga[1].shape)}")
    log(f"mesh {shape}: K1 equal to its plain version on the {len(planes)} "
        f"shard planes {[tuple(p.shape) for p in planes]} of a real block "
        f"(detection masks identical); G1 on the real merged grid "
        f"{tuple(ga[1].shape)}")
    return err


def mesh_phase(scene, single_frames) -> dict:
    """G1 on random merged slot grids (K' = Tn*K = 128, 256 and 512),
    K1 and G1 on the real inputs of each mesh shape, then the gated mesh
    at (1, 2) and (2, 2) against the single-device gated run.  (The
    wide grids' plain G1 runs here, after the single-device phases, so
    that its thousands of small launches and allocations come after the
    single-device timings, as in earlier versions of this script.)"""
    for k in (128, 256, 512):
        compare_g1(gate_grid(256, k, 9 + k), 5.0, False, 3 * 17476,
                   f"(256, {k}) mesh slots")
    log("G1: equal to its plain version at the random (256, 128), "
        "(256, 256) and (256, 512) slot grids")
    freqs, fs, os_, sig, want, _ = scene
    res = {"k1_max_abs_err": 0.0}
    for shape in ((1, 2), (2, 2)):
        res["k1_max_abs_err"] = max(res["k1_max_abs_err"],
                                    check_mesh_kernels(scene, shape))
        n_shards = shape[0] * shape[1]
        devs = mesh_devices(shape)
        run_mesh(scene, shape)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plain_calls: dict = {}
        restore = [count_calls(gate_kernel, GATE_PLAIN, plain_calls),
                   count_calls(sync_kernel, ("sync_error_metric_plain",),
                               plain_calls)]
        try:
            reset_launches()
            t0 = time.perf_counter()
            frames, rereads = run_mesh(scene, shape)
            dt = time.perf_counter() - t0
            launches = {"sync_error_metric": sync_kernel.launches,
                        **gate_kernel.launches}
        finally:
            for r in restore:
                r()
        peak = torch.cuda.max_memory_allocated()
        label = f"mesh {shape[0]}x{shape[1]}"
        if any(plain_calls.values()):
            raise AssertionError(f"{label}: plain versions ran on the card: "
                                 f"{plain_calls}")
        expect = {"sync_error_metric": n_shards * WIDEBAND_BLOCKS + 1,
                  "gate": WIDEBAND_BLOCKS + 1,
                  "nf_track": WIDEBAND_BLOCKS + 1}
        if launches != expect:
            raise AssertionError(f"{label} launched {launches}, expected "
                                 f"{expect}")
        got = {(bytes(f.frame), f.metadata.freq) for f in frames}
        missing = [w for w in want if w not in got]
        if missing:
            raise AssertionError(f"{label}: {len(missing)} of {len(want)} "
                                 f"payloads missing")
        log(f"{label}: blocks re-read from raw samples {rereads}")
        d_nf = compare_frames(single_frames, frames,
                              f"{label} vs single-device gated")
        n = WIDEBAND_BLOCK * WIDEBAND_BLOCKS
        rt = n / dt / fs
        log(f"{label} on {devs}: {len(want)}/{len(want)} payloads decoded "
            f"({len(frames)} frames), kernel launches {launches}; {dt:.4f} s "
            f"-> realtime factor {rt:.3f} against {fs / 1e6} Msps; peak "
            f"device memory {peak / 2**30:.3f} GiB; {len(rereads)} blocks "
            f"re-read from the raw tail")
        res[label] = {"devices": devs, "launches": launches, "seconds": dt,
                      "realtime_factor": rt, "peak_bytes": peak,
                      "rereads": len(rereads), "d_nf_db": d_nf}
    return res


def run_ranks(args: list[str], world: int, timeout: float) -> list[dict]:
    """``world`` ranks of the multi-process worker with ``args``, joined
    in a gloo group on a free localhost port: each rank's RESULT.  Any
    rank that exits non-zero, prints no RESULT or outlives ``timeout``
    fails the phase; every rank is stopped before this returns."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(REPO, "dumpvdl2_tpu_torch", "tools",
                          "multihost_worker.py")
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, worker, *args], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        deadline = time.monotonic() + timeout
        results = []
        for rank, p in enumerate(procs):
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            if p.returncode != 0 or not line:
                raise AssertionError(f"rank {rank} exited {p.returncode}: "
                                     f"{err[-3000:]}")
            results.append(json.loads(line[0][len("RESULT "):]))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def multihost_phase(scene) -> dict:
    """Two ranks on cuda:0, one (1, 2) row each of the (2, 2) mesh,
    against the single-process (2, 2) sharded step over the same two
    blocks: the integer candidate fields equal, K1 Tn times a block."""
    from dumpvdl2_tpu_torch.core.mesh_pipeline import FWD_HALO
    from dumpvdl2_tpu_torch.core.pipeline import MAX_BURST_SYMS
    from dumpvdl2_tpu_torch.dsp.chebyshev import fir_taps
    from dumpvdl2_tpu_torch.dsp.frontend import nco_dphi, prepare_taps
    from dumpvdl2_tpu_torch.parallel import multihost
    from dumpvdl2_tpu_torch.parallel.mesh import make_mesh
    from dumpvdl2_tpu_torch.parallel.sharded import (init_sharded_state,
                                                     make_sharded_step)
    if multihost.init_distributed() is not False:
        raise AssertionError("init_distributed() in one process did not "
                             "return False")
    freqs, fs, os_, sig, _, _ = scene
    cn, tn, n_blocks = 2, 2, 2
    t0 = time.perf_counter()
    ranks = run_ranks(["--scene", "wideband", "--device", "cuda",
                       "--local-devices", "cuda:0,cuda:0"], 2, 600)
    dt = time.perf_counter() - t0

    mesh = make_mesh(cn, tn, ["cuda:0"] * (cn * tn))
    taps = torch.as_tensor(prepare_taps(fir_taps(fs), os_), device="cuda")
    dphi = torch.as_tensor(np.array([nco_dphi(CENTER, f, fs) for f in freqs],
                                    np.uint32).astype(np.int64),
                           device="cuda")
    step = make_sharded_step(mesh, oversample=os_, fwd_halo=FWD_HALO,
                             max_candidates=64, max_symbols=MAX_BURST_SYMS)
    state = init_sharded_state(mesh, len(freqs), taps.shape[0])
    full = []
    for b in range(n_blocks):
        # contiguous, as each rank's distribute_block gives it
        block = sig[:, b * WIDEBAND_BLOCK:(b + 1) * WIDEBAND_BLOCK]
        cands, _, state = step(block.contiguous(), taps, dphi, state)
        full.append(multihost.gather_candidates(cands))
    res = {"seconds": dt, "ranks": []}
    for r in ranks:
        lo, hi = r["channels"]
        label = f"multihost rank {r['process_index']}"
        if (r["process_count"], r["rows"], hi - lo) != (2, 1, 128):
            raise AssertionError(f"{label}: world {r['process_count']}, "
                                 f"rows {r['rows']}, channels {lo}..{hi}")
        for f in ("count", "det_idx", "sync_idx", "sym_valid"):
            got = np.asarray(r[f])
            want = np.stack([blk[f][:, lo:hi] for blk in full])
            if got.shape != want.shape or not np.array_equal(got, want):
                bad = (got != want).sum() if got.shape == want.shape \
                    else f"shape {got.shape} against {want.shape}"
                raise AssertionError(f"{label}: {f} differs from the "
                                     f"single-process (2, 2) run: {bad}")
        if r["k1_launches"] != tn * n_blocks or r["k1_plain_calls"]:
            raise AssertionError(f"{label}: K1 launched {r['k1_launches']} "
                                 f"times (expected {tn * n_blocks}), plain "
                                 f"version {r['k1_plain_calls']} times")
        log(f"{label}: channels {lo}..{hi - 1} on a (1, {tn}) row of the "
            f"({cn}, {tn}) mesh, count/det_idx/sync_idx/sym_valid equal to "
            f"the single-process run over {n_blocks} blocks "
            f"({int(np.asarray(r['count']).sum())} candidates); K1 "
            f"launches {r['k1_launches']}, plain 0; peak device memory "
            f"{r['peak_bytes'] / 2**30:.3f} GiB; {r['seconds']:.2f} s "
            f"in the rank")
        res["ranks"].append({k: r[k] for k in (
            "process_index", "channels", "k1_launches", "peak_bytes",
            "seconds")})
    log(f"multihost: 2 gloo ranks on cuda:0 in {dt:.2f} s with start-up")
    return res


def profile_phase() -> dict:
    """The stage profile of the gated single-device block and the mesh
    (1, 2) block on the card (it raises if its staged frames differ from
    feed_planar's)."""
    spec = importlib.util.spec_from_file_location(
        "profile_wideband_e2e", os.path.join(
            REPO, "dumpvdl2_tpu_torch", "tools", "profile_wideband_e2e.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    recs = tool.run("cuda", blocks=3, mesh_devices=mesh_devices((1, 2)))
    for line in tool.summary(recs):
        log(f"profile: {line}")
    return {"records": recs}


def reset_launches() -> None:
    sync_kernel.launches = 0
    for k in gate_kernel.launches:
        gate_kernel.launches[k] = 0
    for k in native.calls:
        native.calls[k] = 0


# The gate kernels' plain versions and their stages: none may run on
# the card's main path.
GATE_PLAIN = ("gate_plain", "nf_track_plain", "affine_scan",
              "nf_floor_plain")


def count_calls(module, names: tuple[str, ...], counts: dict):
    """Wrap ``module``'s functions ``names`` so that each call adds one
    to ``counts[name]``; returns a function that restores them."""
    orig = {n: getattr(module, n) for n in names}

    def counted(n):
        def fn(*a, **kw):
            counts[n] = counts.get(n, 0) + 1
            return orig[n](*a, **kw)
        return fn

    for n in names:
        counts[n] = 0
        setattr(module, n, counted(n))

    def restore():
        for n, fn in orig.items():
            setattr(module, n, fn)
    return restore


def wideband_path(scene, device_gate: bool) -> tuple[dict, list, dict]:
    """One mode of the wideband path: a warm-up, the counted and timed
    run, and a synchronized breakdown run.  Returns the kernel launches
    of the timed run, its frames and its numbers."""
    freqs, fs, os_, sig, want, _ = scene
    mode = "gated" if device_gate else "host-gated"
    # warm-up on a fresh pipeline: library handles, allocator pools
    run_wideband(freqs, fs, os_, sig[:, :WIDEBAND_BLOCK].contiguous()
                 .repeat(1, WIDEBAND_BLOCKS), device_gate=device_gate)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain_calls: dict = {}
    spec_calls: dict = {}
    restore = count_calls(gate_kernel, GATE_PLAIN, plain_calls)
    restore_spec = count_calls(unstuff, ("_frames_py",), spec_calls)
    try:
        reset_launches()
        t0 = time.perf_counter()
        frames = run_wideband(freqs, fs, os_, sig, device_gate=device_gate)
        dt = time.perf_counter() - t0
        launches = {"sync_error_metric": sync_kernel.launches,
                    **gate_kernel.launches}
        native_calls = dict(native.calls)
    finally:
        restore()
        restore_spec()
    peak = torch.cuda.max_memory_allocated()
    if any(plain_calls.values()):
        raise AssertionError(f"wideband {mode}: plain versions of the gate "
                             f"kernels ran on the card: {plain_calls}")

    got = {(bytes(f.frame), f.metadata.freq) for f in frames}
    missing = [w for w in want if w not in got]
    if missing:
        raise AssertionError(f"wideband {mode}: {len(missing)} of "
                             f"{len(want)} payloads missing, e.g. "
                             f"{missing[0]}")
    n = WIDEBAND_BLOCK * WIDEBAND_BLOCKS
    msps = n / dt / 1e6
    if not native_calls["l2h_unstuff_frames"] or spec_calls["_frames_py"]:
        raise AssertionError(f"wideband {mode}: frames were not unstuffed "
                             f"by the native library alone: {native_calls}, "
                             f"{spec_calls}")
    log(f"wideband {mode}: {len(want)}/{len(want)} payloads decoded "
        f"({len(frames)} frames), kernel launches on this run: {launches}; "
        f"plain gate calls {plain_calls}; native library calls "
        f"{native_calls}, Python spec calls {spec_calls}")
    log(f"wideband {mode}: {n} samples in {dt:.4f} s -> {msps:.3f} "
        f"Msamples/s sustained, realtime factor {msps / (fs / 1e6):.3f} "
        f"against {fs / 1e6} Msps")
    log(f"wideband {mode}: peak device memory {peak / 2**30:.3f} GiB")

    step_ms: dict = {}
    run_wideband(freqs, fs, os_, sig, step_ms, device_gate=device_gate)
    finish_ms = step_ms.pop("finish_once")
    per_block = {k: v / WIDEBAND_BLOCKS for k, v in step_ms.items()}
    log(f"wideband {mode} per-block ms (synchronized breakdown run): " +
        ", ".join(f"{k} {v:.3f}" for k, v in per_block.items()) +
        f"; EOF finish() once {finish_ms:.3f}")
    return launches, frames, {"msamples_per_s": msps,
                              "realtime_factor": msps / (fs / 1e6),
                              "peak_bytes": peak, "per_block_ms": per_block,
                              "finish_ms": finish_ms,
                              "native_calls": native_calls,
                              "spec_calls": spec_calls}


@contextlib.contextmanager
def python_spec():
    """Within the block, the host library's three wrappers (unstuffing,
    the FCS, the raw-frame parse) run their pure-Python spec, as with
    DUMPVDL2_TPU_NATIVE=0, and must not call the library; it is back
    after the block."""
    crc._lib()                  # resolve the wrappers' handles first
    rawframes._native()
    saved = (native._lib, crc._CRC_FN, rawframes._NATIVE_LIB)
    calls = dict(native.calls)
    native._lib = crc._CRC_FN = rawframes._NATIVE_LIB = None
    try:
        yield
    finally:
        native._lib, crc._CRC_FN, rawframes._NATIVE_LIB = saved
    if native.calls != calls:
        raise AssertionError(f"host library: the Python spec called the "
                             f"library: {native.calls} against {calls}")


def unstuff_fcs(streams: list) -> list:
    """Each stream's (frames, "unstuff" or None, CRC of each frame)
    through frames_from_bits and crc16_ccitt."""
    out = []
    for bits in streams:
        frames, err = [], None
        try:
            for f in unstuff.frames_from_bits(bits):
                frames.append(np.packbits(f, bitorder="little").tobytes())
        except unstuff.UnstuffError:
            err = "unstuff"
        out.append((frames, err, [crc.crc16_ccitt(f) for f in frames]))
    return out


def fuzz_streams(n: int, seed: int) -> list:
    """Seeded random bit streams with flags and runs of seven ones
    written in (tests/test_native.py's fuzz)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(0, 300))
        bits = rng.integers(0, 2, m, dtype=np.uint8)
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, max(m - 8, 1)))
            bits[p:p + 7] = rng.choice(
                [np.array([0, 1, 1, 1, 1, 1, 1]),
                 np.array([1, 1, 1, 1, 1, 1, 0])])[:max(0, m - p)]
        out.append(bits)
    return out


def decoded_rows(frames) -> list:
    return [(bytes(f.frame),) + tuple(
        getattr(f.metadata, k) for k in (
            "version", "station_id", "freq", "datalen_octets",
            "synd_weight", "num_fec_corrections", "idx", "frame_pwr_dbfs",
            "nf_pwr_dbfs", "ppm_error", "burst_timestamp"))
        for f in frames]


def host_library_phase(scene, gated_frames, lib_build: dict) -> dict:
    """The native host library against its Python spec on the gated
    wideband run's burst streams, on fuzz streams and on the run's
    frames as a raw-frame archive; unstuff + FCS ms a block with each."""
    freqs, fs, os_, sig, _, _ = scene
    streams: list = []
    orig = burst.frames_from_bits

    def recorded(bits):
        streams.append(np.array(bits, np.uint8))
        return orig(bits)

    burst.frames_from_bits = recorded
    try:
        frames = run_wideband(freqs, fs, os_, sig)
    finally:
        burst.frames_from_bits = orig
    if sorted(bytes(f.frame) for f in frames) != \
            sorted(bytes(f.frame) for f in gated_frames):
        raise AssertionError("host library: the recorded run's frames "
                             "differ from the gated run's")

    res = {"build": lib_build, "streams": len(streams)}
    fuzz = fuzz_streams(2000, seed=12)
    reset_launches()
    c_run, c_fuzz = unstuff_fcs(streams), unstuff_fcs(fuzz)
    with python_spec():
        py_run, py_fuzz = unstuff_fcs(streams), unstuff_fcs(fuzz)
    for label, c, py in (("run", c_run, py_run), ("fuzz", c_fuzz, py_fuzz)):
        bad = [i for i, (a, b) in enumerate(zip(c, py)) if a != b]
        if bad or len(c) != len(py):
            raise AssertionError(f"host library: C and Python differ on "
                                 f"{len(bad)} {label} streams, e.g. #{bad[:3]}")
    n_frames = sum(len(r[0]) for r in c_run)
    good = sum(x == crc.GOOD_FCS for r in c_run for x in r[2])
    res.update(run_frames=n_frames, run_fcs_good=good,
               fuzz_errors=sum(r[1] is not None for r in c_fuzz))
    log(f"host library: {len(streams)} burst streams of the gated run "
        f"({n_frames} frames, {good} with a good FCS) and 2000 fuzz "
        f"streams ({res['fuzz_errors']} unstuffing errors): C and Python "
        f"equal (frames, error, order, CRC)")

    # the run's frames as a raw-frame archive, through both parsers
    archive = b"".join(rawframes.frame_record(f.metadata, bytes(f.frame))
                       for f in frames)
    got = decoded_rows(rawframes.read_records(io.BytesIO(archive)))
    calls = dict(native.calls)
    with python_spec():
        want = decoded_rows(rawframes.read_records(io.BytesIO(archive)))
    if got != want or len(got) != len(frames):
        raise AssertionError("host library: the archive decodes "
                             "differently through C and Python")
    if [r[0] for r in got] != [bytes(f.frame) for f in frames]:
        raise AssertionError("host library: the archive's frames differ "
                             "from the run's")
    res["archive_records"] = len(got)
    log(f"host library: the run's {len(got)} frames as a raw-frame archive "
        f"({len(archive)} bytes) decode to equal DecodedFrames through the "
        f"C parser and the Python spec")

    # unstuff + FCS a block: the run's streams, each way, in turns
    times: dict = {"c": [], "python": []}
    for _ in range(5):
        for way, path in (("c", contextlib.nullcontext),
                          ("python", python_spec)):
            t0 = time.perf_counter()
            with path():
                unstuff_fcs(streams)
            times[way].append((time.perf_counter() - t0) * 1e3
                              / WIDEBAND_BLOCKS)
    res["unstuff_fcs_ms_per_block"] = times
    res["calls"] = calls
    if not all(calls.values()):
        raise AssertionError(f"host library: an entry point was never "
                             f"called: {calls}")
    log(f"host library: unstuff + FCS ms a block ({len(streams)} streams "
        f"over {WIDEBAND_BLOCKS} blocks), 5 turns: C "
        f"{[round(t, 4) for t in times['c']]}, Python "
        f"{[round(t, 4) for t in times['python']]}; library calls in this "
        f"phase {calls}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    built = kernels.build_all()
    for name, info in built.items():
        log(f"build {name}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            log(f"  {line}")
    lib_build = native.build()
    log(f"build l2host: {lib_build['compiler'] or 'built already'}, "
        f"{lib_build['seconds']:.2f} s -> {lib_build['path']}")
    if native.load_l2host() is None:
        raise AssertionError("the native host library is switched off "
                             "(DUMPVDL2_TPU_NATIVE=0)")
    card = card_line()
    log(card)

    checks = [check_k1(256, 108844, seed=0)]
    checks += [check_k1(C, M, seed=i + 1)
               for i, (C, M) in enumerate(K1_RAGGED)]
    scene = wideband_scene()
    checks.append(check_k1_real(*scene[:4]))
    k1_main = time_k1(256, 108844, seed=0)
    g1, g2 = check_gates(scene)

    vec = correctness_vector()
    launches, gated_frames, wb = wideband_path(scene, device_gate=True)
    # each kernel once a block and once at EOF
    want = {"sync_error_metric": WIDEBAND_BLOCKS + 1,
            "gate": WIDEBAND_BLOCKS + 1, "nf_track": WIDEBAND_BLOCKS + 1}
    if launches != want:
        raise AssertionError(f"the gated wideband path launched {launches}, "
                             f"expected {want}")
    _, host_frames, wb_host = wideband_path(scene, device_gate=False)
    d_nf = compare_frames(gated_frames, host_frames, "host-gated vs gated")
    cli = cli_on_card()
    host_l2 = host_l2_phase(scene)
    mesh = mesh_phase(scene, gated_frames)
    multi = multihost_phase(scene)
    prof = profile_phase()
    host_lib = host_library_phase(scene, gated_frames, lib_build)

    def entry(name, source, replaces, t, err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None}

    kernels_line = {"kernels": [
        entry("sync_error_metric", "dumpvdl2_tpu_torch/csrc/sync_metric.cu",
              "dumpvdl2_tpu/dsp/sync_pallas.py:117", k1_main,
              max([c["max_abs_err"] for c in checks]
                  + [mesh["k1_max_abs_err"]])),
        entry("gate", "dumpvdl2_tpu_torch/csrc/gate.cu",
              "dumpvdl2_tpu/core/nf_gate.py:133", g1, g1["max_abs_err"]),
        entry("nf_track", "dumpvdl2_tpu_torch/csrc/gate.cu",
              "dumpvdl2_tpu/core/nf_gate.py:186", g2, g2["max_abs_err"]),
    ]}
    log(json.dumps({"wideband_gated": wb, "wideband_host_gated": wb_host,
                    "modes_max_d_nf_db": d_nf, "vector": vec, "cli": cli,
                    "host_l2": host_l2, "mesh": mesh,
                    "multihost": multi, "profile": prof,
                    "host_library": host_lib,
                    "k1": k1_main, "g1": g1, "g2": g2, "card": card}))
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
