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
4. KC (find_candidates, csrc/candidates.cu), the L2 front, L2H, L2P,
   L2D and RS (the L2 kernels, csrc/l2.cu; the front and L2P, behind
   its hdr-ok compaction prologue, are the main path's L2 step, L2H
   runs on pre-sliced symbols, L2D and RS are the stages' own entry
   points, built on L2P's device functions) against their plain
   PyTorch versions on the card, every integer and byte equal (the
   front's frame_pwr within rtol 1e-6, its > 1.0 decision equal): KC
   on the wideband scene's real metric planes of a block and of the
   EOF flush and on adversarial planes at (256, 108 844) with far more
   leaders than its 64 slots, the front on those slots; the front, L2H
   on its symbols and L2P (behind its compaction prologue, as the path
   runs it) on the real L2 inputs of the sliced block and the flush
   (l2_sliced, the rs cap), L2D on the same rows and RS on L2D's
   tables; the launches of one sliced L2 step on the block's inputs, by
   the wrappers' counters and by a trace of that call alone (1 to 4);
   24 000 RS rows of sim.rs_fuzz (0-20 errors, erasures, zero
   syndromes, fec_octets 0-7 and -1); 384 symbol rows of sim.l2_fuzz
   (bursts of 1-9 RS blocks, damaged bursts, noise) and 256 of
   sim.l2_rs_fuzz (bursts whose RS rows carry the RS fuzz's cases),
   with and without the compaction prologue; L2P with odd and out-of-range
   parity counts (count 6 and -1 through the table); and the vector's
   near-cap burst, which must decode through the kernels;
   l2_decode_batch on the card equal to the CPU's; the card's floor for
   a launch (a one-element fill_); each kernel's device (profiler) and
   wrapper-call times, its plain version's and its bound at the sliced
   block's and the flush's shapes (KC at the block's), L2P beside
   L2D + RS;
5. correctness vector: 8 channels at oversample 20 (2.1 Msps), a strong,
   a marginal and a near-cap (1990-octet) burst, fed through
   VDL2Pipeline(device="cuda").feed(..., eof=True); every frame must come
   back byte for byte on its channel (run twice, the second run timed);
6. wideband main path, device-gated (the default): 256 channels at
   oversample 80 (8.4 Msps), six device-resident blocks of 4 194 240
   samples with 24 bursts on stride-4 channels through feed_planar +
   finish; all 24 payloads must decode; K1, KC, G1, G2, the L2 front
   and L2P must each have launched 7 times on that run (6 blocks +
   EOF, blocks 3-6 as replays of the steps' CUDA graphs, captured
   once), L2H, L2D and RS never, no plain version of a gate or L2
   kernel may have run, and no plain detect or L2-front function
   (candidates_plain, find_and_slice, slice_windows, demod_window,
   l2_front_plain, _slot_compaction, compact_rows, the L2H call); the native
   library's unstuffing must have been called on that run and the
   Python spec (_frames_py) never.  Prints the sustained ingest rate,
   the realtime factor, the per-block step breakdown, the finish() time
   and peak device memory;
7. the host-gated path (device_gate=False) on the same scene: all its
   payloads must decode and its frames equal the gated run's (bytes and
   freq exact, nf_pwr_dbfs within 1e-4 dB), KC, the front and L2P
   must each have launched, L2H, L2D and RS never, and no plain version
   of an L2 kernel or plain detect or L2-front function run; its realtime
   factor and breakdown beside the gated ones;
8. the CLI on the card: the correctness vector written as an S16_LE file
   and decoded by ``python3 -m dumpvdl2_tpu_torch`` (default platform,
   the GPU) in a subprocess; it must exit 0 and give one JSON record
   per burst on its frequency;
9. host L2 (device_l2=False, host-gated): the correctness vector and the
   first two blocks of the wideband scene; the frames must equal the
   device-L2 host-gated run's on the same span (bytes, freq and idx
   exact, nf_pwr_dbfs within 1e-4 dB) and every payload in the span must
   decode; wall times of both;
10. G1 against its plain version on random merged slot grids,
   K' = Tn*K = 128, 256 and 512; for each mesh shape, K1 against its
   plain version on every shard's phase plane of a real block ((256,
   H + Ml + F) at (1, 2), (128, H + Ml + F) at (2, 2); identical
   detection masks), KC on every shard's metric planes with its
   detection window (detect_lo, detect_hi) and G1 on that block's real
   merged (C, Tn*K) grid,
   and L2H, L2P, L2D and RS on the mesh's real L2 inputs (launch_compacted_l2
   over every shard's slots, a block and at EOF); then the mesh path
   (MeshPipeline,
   device-gated) on the whole wideband scene at mesh shapes (1, 2) and
   (2, 2), the shards on distinct GPUs where there are enough, else on
   cuda:0 repeated: 24/24 payloads, the
   frames equal to the single-device gated run's (bytes, freq and idx
   exact, nf_pwr_dbfs within 1e-4 dB); K1 and KC launched once per
   shard a block plus once at EOF, G1, G2, L2H and L2P once a block
   plus once at EOF, the front, L2D and RS never, no plain version run.  Realtime factor, peak memory, the blocks re-read
   from the raw tail and the shards' devices are printed;
11. the multi-process path (parallel/multihost.py): ``init_distributed()``
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
12. the stage profile (dumpvdl2_tpu_torch/tools/profile_wideband_e2e.py):
   the gated single-device block staged three times (dispatch, device,
   fetch with its bytes, host) and traced once (device busy and idle
   share, kernel launches, top ops, idle gaps), its frames equal to
   feed_planar's; a staged block whose steps synchronize, traced for
   each step's kernel launches (split by the kernels' midpoints, so
   printed only; phase 4 counts the L2 step's exactly); a steady
   feed_planar block traced as it runs; the mesh (1, 2) block's
   per-step split and trace;
13. the host library (dumpvdl2_tpu_torch/native): on every burst
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

from dumpvdl2_tpu_torch import burst, kernels, native, sim
from dumpvdl2_tpu_torch.constants import (HEADER_LEN, SPS, SYMBOL_RATE,
                                          SYNC_THRESHOLD)
from dumpvdl2_tpu_torch.core import gate_kernel
from dumpvdl2_tpu_torch.core.device import process_block_detect
from dumpvdl2_tpu_torch.core.pipeline import DEFAULT_HALO, VDL2Pipeline
from dumpvdl2_tpu_torch.dsp import sync_kernel
from dumpvdl2_tpu_torch.io import rawframes
from dumpvdl2_tpu_torch.link import crc, unstuff
from dumpvdl2_tpu_torch.sim import (WIDEBAND_BLOCK, WIDEBAND_BLOCKS,
                                    frame_with_fcs, synthesize_iq_raw,
                                    wideband_scene)

# The mesh and the L2 kernels' modules are imported where they are
# used.

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
# L2 kernels' least instructions.  L2H per burst (25 bit extracts and
# merges, 5 parity folds, the bit reversal and the geometry).  L2D per
# octet it packs (8 bit extracts and merges) and per cell of an accepted
# burst's table (the index arithmetic, a compare, a select, the store).
# RS per syndrome term (a table lookup and an XOR, 6 a position of a row
# with parity) and per Chien and Forney term (7 a position of a row with
# a nonzero syndrome).  L2P does L2D's and RS's.  All move more bytes
# than they issue instructions.
L2H_OPS_PER_BURST = 60
L2D_OPS_PER_OCTET = 16
L2D_OPS_PER_CELL = 6
RS_OPS_PER_TERM = 2
# KC's least instructions per sample of the err plane: the two compares
# of a crossing, the two of the detection window, the bit's shift and
# merge into its word.  The L2 front's per symbol: the two differences,
# the two wraps (compare and select each), the division, the rounding,
# the modulo, the Gray lookup and the store; per summed power term an
# add.  Both move more bytes than they issue instructions.
KC_OPS_PER_SAMPLE = 6
FRONT_OPS_PER_SYMBOL = 10
# The L2 kernels of the single-device main path: the front and L2P
# (behind its compaction prologue); L2H on pre-sliced symbols runs on
# the mesh and in l2_decode_batch; those built on L2P's device functions
# for the stages' own entry points must not launch on either.
L2_KERNELS = ("l2_front", "l2_payload")
L2_MESH_KERNELS = ("l2_header", "l2_payload")
L2_STANDALONE = ("l2_deinterleave", "rs_verify")
# The calls capture_l2_inputs records: core/pipeline.py's front and
# fec/l2.py's kernel calls.
L2_CALLS = {"pipeline": ("l2_front",),
            "l2_step": ("l2_header", "l2_payload", "l2_payload_capped")}
# The L2 kernels' plain versions and their stages: none may run on the
# card's main path.
L2_PLAIN = ("l2_header_plain", "l2_payload_plain", "l2_deinterleave_plain",
            "rs_verify_plain",
            "rs_decode_batch", "_clear_bits")
# The plain detect and L2-front functions: none may run on the card's
# single-device main path (the mesh still slices its candidates with
# find_and_slice and compacts them with _slot_compaction, compact_rows).
FRONT_PLAIN = {"candidates_kernel": ("candidates_plain",),
               "demod": ("find_and_slice", "slice_windows", "demod_window"),
               "pipeline": ("find_and_slice", "l2_front_plain",
                            "_slot_compaction"),
               "l2_kernel": ("compact_rows", "l2_payload_capped_plain"),
               "l2_step": ("l2_header",)}
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


def l2_modules():
    """fec/l2.py and fec/l2_kernel.py of the checkout under test."""
    from dumpvdl2_tpu_torch.fec import l2 as l2_step
    from dumpvdl2_tpu_torch.fec import l2_kernel
    return l2_step, l2_kernel


def l2h_bound(B: int, sms: int, clock_hz: float) -> dict:
    """Least time for L2H on B bursts: it reads each burst's first 9
    symbols and writes 8 int32 results and 4 flags a burst."""
    return _bound((9 + 8 * 4 + 4) * B, L2H_OPS_PER_BURST * B, sms,
                  clock_hz)


def l2d_work(args: tuple) -> tuple[int, int]:
    """L2D's bytes and least instructions on these inputs: each accepted
    burst's symbols up to its last parity octet, the geometry (17 bytes
    a burst, 8 more for the row index), the (Bp, 9, 255) table and
    (Bp, 9) parity counts out; the octets those bursts pack and their
    table cells."""
    _, l2_kernel = l2_modules()
    symbols, sel, hdr_ok, num_blocks, _ll, lf, doct = args
    rows = torch.arange(symbols.shape[0], device=symbols.device) \
        if sel is None else sel
    nb = torch.where(hdr_ok, num_blocks, 0)[rows].to(torch.int64)
    acc = nb > 0
    octets = torch.where(acc, doct[rows] + (nb - 1) * 6 + lf[rows], 0)
    syms = torch.where(acc, (HEADER_LEN + 8 * octets + 2) // 3, 0)
    Bp = rows.shape[0]
    n_acc = int(acc.sum().item())
    nbytes = int(syms.sum().item()) + (17 + (sel is not None) * 8) * Bp \
        + (l2_kernel.MAX_BLOCKS * (255 + 4)) * Bp
    ops = L2D_OPS_PER_OCTET * int(octets.sum().item()) \
        + L2D_OPS_PER_CELL * l2_kernel.MAX_BLOCKS * 255 * n_acc
    return nbytes, ops


def l2d_bound(args: tuple, sms: int, clock_hz: float) -> dict:
    """Least time for L2D on these inputs (l2d_work)."""
    return _bound(*l2d_work(args), sms, clock_hz)


def rs_ops(fec: torch.Tensor, count: torch.Tensor) -> int:
    """RS's least instructions on these rows: 6 syndrome terms a
    position of a row with parity, 7 Chien and Forney terms a position
    of a row with a nonzero syndrome (count != 0)."""
    with_parity = int((fec != 0).sum().item())
    nonzero = int(((fec != 0) & (count != 0)).sum().item())
    return RS_OPS_PER_TERM * 255 * (6 * with_parity + 7 * nonzero)


def rs_bound(fec: torch.Tensor, count: torch.Tensor, sms: int,
             clock_hz: float) -> dict:
    """Least time for RS on these rows: each row in and out (255 bytes
    and its parity count; 255 bytes and its count) and rs_ops."""
    return _bound((2 * 255 + 8) * fec.shape[0], rs_ops(fec, count), sms,
                  clock_hz)


def l2p_bound(args: tuple, fec_row: torch.Tensor, count: torch.Tensor,
              sms: int, clock_hz: float) -> dict:
    """Least time for L2P on these inputs (payload_args' form): L2D's
    bytes on the same rows (its inputs, the table and parity counts
    written once) and the RS counts written once; behind the compaction
    prologue no row index, but hdr_ok read and blocks_row written for
    every burst.  L2D's operations and RS's on the table's rows
    (``fec_row`` and ``count`` L2P's results)."""
    nbytes, ops = l2d_work(l2d_args(args))
    sym, cap = args[:2]
    if cap is not None:
        nbytes += (1 + 4) * sym.shape[0] - (8 + 1) * cap
    return _bound(nbytes + 4 * count.numel(),
                  ops + rs_ops(fec_row.reshape(-1), count.reshape(-1)),
                  sms, clock_hz)


def compare_l2h(symbols: torch.Tensor, label: str) -> dict:
    """L2H against its plain version: every field equal, dtypes too."""
    _, l2_kernel = l2_modules()
    k = l2_kernel.l2_header_cuda(symbols)
    p = l2_kernel.l2_header_plain(symbols)
    torch.cuda.synchronize()
    for key, want in p.items():
        if k[key].dtype != want.dtype or not torch.equal(k[key], want):
            bad = (k[key] != want).sum().item() \
                if k[key].shape == want.shape else "shape"
            raise AssertionError(f"L2H differs from its plain version on "
                                 f"{label}: {key} ({bad} rows)")
    return {"rows": symbols.shape[0],
            "hdr_ok": int(p["hdr_ok"].sum().item())}


def compare_l2d(args: tuple, label: str) -> dict:
    """L2D against its plain version: table and parity counts equal."""
    _, l2_kernel = l2_modules()
    tk, fk = l2_kernel.l2_deinterleave_cuda(*args)
    tp, fp = l2_kernel.l2_deinterleave_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in (("table", tk, tp), ("fec_row", fk, fp)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"L2D differs from its plain version on "
                                 f"{label}: {name}")
    return {"rows": tk.shape[0],
            "rs_rows": int((fp != 0).sum().item())}


def compare_rs(blocks: torch.Tensor, fec: torch.Tensor, label: str
               ) -> dict:
    """RS against its plain version: corrected bytes and counts equal.
    Returns the rows by count (-1 failure, 0 none or skipped, n
    corrected)."""
    _, l2_kernel = l2_modules()
    ok, ck = l2_kernel.rs_verify_cuda(blocks, fec)
    op, cp = l2_kernel.rs_verify_plain(blocks, fec)
    torch.cuda.synchronize()
    if not torch.equal(ck, cp) or not torch.equal(ok, op) \
            or ok.dtype != op.dtype or ck.dtype != cp.dtype:
        bad = (ck != cp) | (ok != op).any(dim=1)
        i = int(bad.nonzero()[0, 0].item()) if bad.any() else -1
        raise AssertionError(
            f"RS differs from its plain version on {label}: "
            f"{int(bad.sum().item())} rows, e.g. row {i} (fec_octets "
            f"{int(fec[i].item())}, count {int(ck[i].item())} against "
            f"{int(cp[i].item())})")
    vals, n = torch.unique(cp, return_counts=True)
    return {"rows": blocks.shape[0],
            "by_count": {int(v): int(c) for v, c in zip(vals, n)}}


def l2p_calls(args: tuple) -> tuple:
    """L2P's kernel and plain calls on ``args`` (symbols, cap, hdr_ok,
    num_blocks, last_len, lf, doct): every burst with cap None, else
    behind the hdr-ok compaction prologue (l2_payload_capped)."""
    _, l2_kernel = l2_modules()
    sym, cap, *geom = args
    if cap is None:
        return (lambda: l2_kernel.l2_payload_cuda(sym, *geom),
                lambda: l2_kernel.l2_payload_plain(sym, *geom))
    return (lambda: l2_kernel.l2_payload_capped_cuda(*args),
            lambda: l2_kernel.l2_payload_capped_plain(*args))


def l2d_args(args: tuple) -> tuple:
    """L2D's arguments for the rows L2P decodes on ``args``: its row
    index is the stable hdr-ok order's first ``cap`` rows (None for
    every burst)."""
    _, l2_kernel = l2_modules()
    sym, cap, hdr_ok, *geom = args
    sel = None if cap is None else l2_kernel.compact_rows(hdr_ok, cap)[0]
    return (sym, sel, hdr_ok, *geom)


def compare_l2p(args: tuple, label: str) -> dict:
    """L2P against its plain version on ``args`` (l2p_calls): corrected
    table, counts, parity counts and (behind the compaction) blocks_row
    equal, dtypes too.  Returns the rows with parity by count."""
    kernel, plain = l2p_calls(args)
    k = kernel()
    p = plain()
    torch.cuda.synchronize()
    for name, a, b in zip(("table", "counts", "fec_row", "blocks_row"),
                          k, p):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            bad = (a != b).reshape(a.shape[0], -1).any(dim=1) \
                if a.shape == b.shape else None
            raise AssertionError(
                f"L2P differs from its plain version on {label}: {name} "
                f"({'shape' if bad is None else int(bad.sum().item())} "
                f"bursts)")
    counts, fec_row = p[1], p[2]
    vals, n = torch.unique(counts[fec_row != 0], return_counts=True)
    return {"rows": counts.shape[0], "bursts": int(args[0].shape[0]),
            "overflow": int((p[3] < 0).sum().item()) if len(p) > 3 else 0,
            "rs_rows": int((fec_row != 0).sum().item()),
            "by_count": {int(v): int(c) for v, c in zip(vals, n)}}


def capture_l2_inputs(scene, mesh_shape=None) -> dict:
    """The arguments KC and fec/l2.py's kernel calls get on the gated
    wideband path, keyed (stage, name): stage "block" the second
    block's (the sliced path: the front, L2P behind its compaction),
    "eof" the flush's (finish(): the same calls on the halo).  With
    ``mesh_shape`` the mesh's (KC on the last shard, L2H and L2P of
    launch_compacted_l2 over every shard's slots)."""
    from dumpvdl2_tpu_torch.core.mesh_pipeline import MeshPipeline
    from dumpvdl2_tpu_torch.core import pipeline
    l2_step, _ = l2_modules()
    kc, _ = front_modules()
    mods = {"pipeline": pipeline, "l2_step": l2_step}
    freqs, fs, os_, sig, _, _ = scene
    got: dict = {}
    stage = ["block"]
    orig = {(m, n): getattr(mods[m], n)
            for m, names in L2_CALLS.items() for n in names}
    orig_kc = kc.candidates_cuda

    def spy(n, fn):
        def call(*a):
            got[(stage[0], n)] = a
            return fn(*a)
        return call

    if mesh_shape is None:
        pipe = VDL2Pipeline(freqs, int(CENTER), fs, os_, device="cuda")
    else:
        pipe = MeshPipeline(freqs, int(CENTER), fs, os_,
                            mesh_shape=mesh_shape,
                            devices=mesh_devices(mesh_shape))
    try:
        for (m, n), fn in orig.items():
            setattr(mods[m], n, spy(n, fn))
        kc.candidates_cuda = spy("find_candidates", orig_kc)
        for b in range(2):
            pipe.feed_planar(sig[:, b * WIDEBAND_BLOCK:
                                 (b + 1) * WIDEBAND_BLOCK])
        stage[0] = "eof"
        pipe.finish()
    finally:
        for (m, n), fn in orig.items():
            setattr(mods[m], n, fn)
        kc.candidates_cuda = orig_kc
    torch.cuda.synchronize()
    return got


def payload_args(got: dict, stage: str) -> tuple:
    """L2P's arguments at ``stage`` in l2p_calls' form: as captured
    behind the compaction prologue, or with cap None for every
    burst."""
    if (stage, "l2_payload_capped") in got:
        return got[(stage, "l2_payload_capped")]
    sym, *geom = got[(stage, "l2_payload")]
    return (sym, None, *geom)


def rs_rows_of(d_args: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """RS's rows and parity counts for L2D's arguments: L2D's tables."""
    _, l2_kernel = l2_modules()
    tab, fec_row = l2_kernel.l2_deinterleave_cuda(*d_args)
    return tab.reshape(-1, 255), fec_row.reshape(-1)


def front_modules():
    """dsp/candidates_kernel.py and fec/l2_kernel.py of the checkout
    under test (KC and the L2 front)."""
    from dumpvdl2_tpu_torch.dsp import candidates_kernel
    from dumpvdl2_tpu_torch.fec import l2_kernel
    return candidates_kernel, l2_kernel


def compare_kc(args: tuple, label: str) -> dict:
    """KC against its plain version on ``args`` (err, freq, threshold,
    K, S, detect_lo, detect_hi): every field equal, dtypes too (the
    floats are gathers or the plain version's arithmetic in its
    order)."""
    kc, _ = front_modules()
    k = kc.candidates_cuda(*args)
    p = kc.candidates_plain(*args)
    torch.cuda.synchronize()
    for name in p._fields:
        a, b = getattr(k, name), getattr(p, name)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            bad = (a != b).reshape(a.shape[0], -1).any(dim=1) \
                if a.shape == b.shape else None
            raise AssertionError(
                f"KC differs from its plain version on {label}: {name} "
                f"({'shape' if bad is None else int(bad.sum().item())} "
                f"rows)")
    return {"shape": list(args[0].shape), "K": args[3],
            "leaders": int(p.count.sum().item()),
            "max_count": int(p.count.max().item()) if p.count.numel()
            else 0, "slots": int((p.det_idx >= 0).sum().item())}


def compare_front(args: tuple, label: str) -> dict:
    """The L2 front against its plain version on ``args`` (phases, pwr,
    count, sync_idx, dphi, K, S): take, inv, the symbols and every
    header field equal, frame_pwr within rtol 1e-6, and its one decision
    (frame_pwr > 1.0, the loud-message counter) equal."""
    from dumpvdl2_tpu_torch.core import pipeline
    _, l2_kernel = front_modules()
    k = l2_kernel.l2_front_cuda(*args)
    p = pipeline.l2_front_plain(*args)
    torch.cuda.synchronize()
    if set(k) != set(p) or (k["inv"] is None) != (p["inv"] is None):
        raise AssertionError(f"L2 front's results differ in kind on {label}")
    for key, want in p.items():
        if key == "frame_pwr" or want is None:
            continue
        got = k[key]
        if got.dtype != want.dtype or got.shape != want.shape \
                or not torch.equal(got, want):
            raise AssertionError(f"L2 front differs from its plain version "
                                 f"on {label}: {key}")
    fk, fp = k["frame_pwr"], p["frame_pwr"]
    rel = ((fk - fp).abs() / fp.abs().clamp_min(1e-30)).max().item() \
        if fp.numel() else 0.0
    if not rel <= 1e-6 or not torch.equal(fk == 0, fp == 0):
        raise AssertionError(f"L2 front's frame_pwr differs on {label}: "
                             f"relative {rel:.3e} (> 1e-6)")
    loud = int(((fk > 1.0) != (fp > 1.0)).sum().item())
    if loud:
        raise AssertionError(f"L2 front's frame_pwr > 1.0 differs from the "
                             f"plain version's on {loud} rows of {label}")
    return {"rows": int(p["take"].shape[0]),
            "hdr_ok": int(p["hdr_ok"].sum().item()),
            "compacted": p["inv"] is not None,
            "frame_pwr_max_rel_err": rel,
            "frame_pwr_max_abs_err": (fk - fp).abs().max().item()
            if fp.numel() else 0.0}


def kc_bound(args: tuple, sms: int, clock_hz: float) -> dict:
    """Least time for KC on these inputs: the err plane read once, the
    four gathers of each valid slot (y1, y2, y3, dphi) and the column-0
    reads of each row with an empty slot, the results written once;
    KC_OPS_PER_SAMPLE a sample of the plane."""
    kc, _ = front_modules()
    err, _freq, _thr, K, *_ = args
    C, M = err.shape
    d = kc.candidates_cuda(*args)
    valid = int((d.det_idx >= 0).sum().item())
    empty_rows = int((d.count < K).sum().item())
    nbytes = 4 * C * M + 16 * valid + 8 * empty_rows + 4 * C + 20 * C * K
    return _bound(nbytes, KC_OPS_PER_SAMPLE * C * M, sms, clock_hz)


def l2_front_bound(args: tuple, sms: int, clock_hz: float) -> dict:
    """Least time for the L2 front on these inputs: the distinct phase
    samples its rows' windows read (below M) and the distinct power
    samples of the accepted rows' frame power, the count and each row's
    slot (sync point and frequency) read once; the symbols, the header
    fields, the frame power, take and inv written once.  Operations:
    FRONT_OPS_PER_SYMBOL a symbol, L2H's a header, an add a power
    term."""
    _, l2_kernel = front_modules()
    phases, _pwr, count, sync_idx, _dphi, K, S = args
    C, M = phases.shape
    f = l2_kernel.l2_front_cuda(*args)
    take = f["take"]
    cap = take.shape[0]
    dev = phases.device
    row_c = torch.div(take, K, rounding_mode="floor")
    start = sync_idx.reshape(-1)[take].to(torch.int64).clamp(0, M)
    idx = start[:, None] + SPS * torch.arange(S + 1, device=dev)
    flat = row_c[:, None] * M + idx
    n_ph = torch.unique(flat[idx < M]).numel()
    total = torch.clamp(-torch.div(-f["bits_consumed"], 3,
                                   rounding_mode="floor"), min=1)
    s_idx = torch.arange(1, S + 1, device=dev)
    use = f["hdr_ok"][:, None] & (s_idx[None, :] <= total[:, None]) \
        & (idx[:, 1:] < M)
    n_terms = int(use.sum().item())
    n_pw = torch.unique(flat[:, 1:][use]).numel()
    nbytes = 4 * (n_ph + n_pw) + 4 * C + 8 * cap + cap * S \
        + cap * (4 * len(l2_kernel.HDR_INT) + len(l2_kernel.HDR_BOOL) + 4) \
        + 8 * cap + (4 * C * K if f["inv"] is not None else 0)
    ops = FRONT_OPS_PER_SYMBOL * cap * S + L2H_OPS_PER_BURST * cap + n_terms
    return _bound(nbytes, ops, sms, clock_hz)


def adversarial_metric(C: int, M: int, seed: int) -> tuple:
    """A K1-like (err, freq) pair with far more leaders than slots:
    err above the threshold but for dips below it at 3 % of the
    samples (+inf for the first LOOKBACK samples), freq normal."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    err = torch.rand((C, M), generator=gen, device="cuda") * 4.5 + 4.5
    dips = torch.rand((C, M), generator=gen, device="cuda") < 0.03
    err = torch.where(dips, torch.rand((C, M), generator=gen,
                                       device="cuda") * SYNC_THRESHOLD, err)
    err[:, :sync_kernel.LOOKBACK] = float("inf")
    freq = torch.randn((C, M), generator=gen, device="cuda") * 0.05
    freq[:, :sync_kernel.LOOKBACK] = 0.0
    return err.contiguous(), freq.contiguous()


def log_time(name: str, label: str, t: dict, floor_ms: float) -> None:
    log(f"{name} at {label} {tuple(t['shape'])}: kernel {t['ms']:.4f} ms "
        f"({t['ms_from']}), a wrapper call {t['call_ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}; bytes {t['bytes_ms']:.6f}, issue "
        f"{t['ops_ms']:.6f}), launch floor {floor_ms:.4f} ms; "
        f"{t['bound_ms'] / t['ms']:.3f} of the bound")


def time_kc(args: tuple, sms: int, clock: float) -> dict:
    """KC's device and wrapper-call times, its plain version's and its
    bound on ``args``."""
    kc, _ = front_modules()
    return {**time_gate(lambda: kc.candidates_cuda(*args),
                        lambda: kc.candidates_plain(*args),
                        "candidates_kernel"),
            **kc_bound(args, sms, clock), "shape": list(args[0].shape)}


def time_front(args: tuple, sms: int, clock: float) -> dict:
    """The L2 front's device and wrapper-call times, its plain
    version's and its bound on ``args``."""
    from dumpvdl2_tpu_torch.core import pipeline
    _, l2_kernel = front_modules()
    return {**time_gate(lambda: l2_kernel.l2_front_cuda(*args),
                        lambda: pipeline.l2_front_plain(*args),
                        "l2_front_kernel"),
            **l2_front_bound(args, sms, clock),
            "shape": [l2_kernel.slot_cap(args[2].shape[0], args[5]),
                      args[6]]}


def check_kc_front(got: dict, sms: int, clock: float,
                   floor_ms: float) -> dict:
    """KC against its plain version on the wideband block's and the
    flush's captured metric planes and on adversarial planes with far
    more leaders than slots, the front on the adversarial slots; KC's
    times and bounds on each, the front's on the adversarial slots.
    (The front on the captured block and flush is held in
    check_l2_captured and timed in time_l2.)"""
    kc, _ = front_modules()
    res = {"times": {}}
    for stage in ("block", "eof"):
        args = got[(stage, "find_candidates")]
        res[stage] = r = compare_kc(args, f"wideband {stage}")
        log(f"KC wideband {stage} {tuple(r['shape'])}, K {r['K']}: "
            f"{r['leaders']} leaders (at most {r['max_count']} a row), "
            f"{r['slots']} slots filled: equal to its plain version")
        res["times"][stage] = time_kc(args, sms, clock)
        log_time("find_candidates (KC)", stage, res["times"][stage],
                 floor_ms)
    C, M = 256, 108844
    err, freq = adversarial_metric(C, M, seed=31)
    adv = (err, freq, SYNC_THRESHOLD, 64, 5616, 0, None)
    r = compare_kc(adv, "adversarial")
    if r["max_count"] <= 4 * 64:
        raise AssertionError(f"the adversarial planes reached only "
                             f"{r['max_count']} leaders a row")
    res["adversarial"] = r
    d = kc.candidates_cuda(*adv)
    gen = torch.Generator(device="cuda").manual_seed(33)
    pwr = torch.rand((C, M), generator=gen, device="cuda") * 2.0
    f_args = (random_phases(C, M, 32), pwr, d.count, d.sync_idx, d.dphi,
              64, 5616)
    f = compare_front(f_args, "adversarial slots")
    res["front_adversarial"] = f
    log(f"KC adversarial {(C, M)}: {r['leaders']} leaders (up to "
        f"{r['max_count']} a row, K = 64): equal to its plain version; "
        f"the front on its slots ({f['rows']} rows, {f['hdr_ok']} headers "
        f"accepted on random phases) equal, frame_pwr within "
        f"{f['frame_pwr_max_rel_err']:.2e} relative")
    res["times"]["adversarial"] = time_kc(adv, sms, clock)
    log_time("find_candidates (KC)", "adversarial",
             res["times"]["adversarial"], floor_ms)
    res["front_times"] = {"adversarial": time_front(f_args, sms, clock)}
    log_time("l2_front", "adversarial slots",
             res["front_times"]["adversarial"], floor_ms)
    return res


def check_payload(p_args: tuple, label: str) -> dict:
    """L2P (l2p_calls' form), L2D on the same rows and RS on L2D's
    tables against their plain versions."""
    p = compare_l2p(p_args, label)
    d_args = l2d_args(p_args)
    d = compare_l2d(d_args, label)
    blocks, fec = rs_rows_of(d_args)
    r = compare_rs(blocks, fec, label)
    return {"l2p": p, "l2d": d, "rs": r, "rs_rows": list(blocks.shape)}


def check_l2_captured(got: dict, label: str) -> dict:
    """The L2 kernels against their plain versions on captured real
    inputs, at each stage's shapes: the front (where the path runs it),
    L2H on the stage's symbols, L2P (with its compaction prologue where
    the path runs it), and L2D and RS on L2P's arguments and L2D's
    tables."""
    res = {}
    for stage in ("block", "eof"):
        p_args = payload_args(got, stage)
        sym = p_args[0]
        front = compare_front(got[(stage, "l2_front")], f"{label} {stage}") \
            if (stage, "l2_front") in got else None
        h = compare_l2h(sym, f"{label} {stage}")
        c = check_payload(p_args, f"{label} {stage}")
        res[stage] = {"front": front, "l2h": h, **c,
                      "symbols": list(sym.shape),
                      "table_rows": c["l2p"]["rows"]}
        log(f"L2 {label} {stage}: "
            + (f"front on {front['rows']} rows ({front['hdr_ok']} headers "
               f"accepted, frame_pwr within "
               f"{front['frame_pwr_max_rel_err']:.2e} relative), "
               if front else "")
            + f"L2H on {tuple(sym.shape)} symbols ({h['hdr_ok']} headers "
            f"accepted), L2P on {c['l2p']['rows']} bursts "
            + (f"(its prologue compacting {c['l2p']['bursts']} rows, "
               f"{c['l2p']['overflow']} over) " if p_args[1] is not None
               else "")
            + f"({c['l2p']['rs_rows']} RS rows with parity, by count "
            f"{c['l2p']['by_count']}), L2D on the same and RS on its "
            f"{tuple(c['rs_rows'])} rows: all equal to their plain "
            f"versions")
    return res


def l2_step_launches(got: dict) -> dict:
    """The launches of one sliced L2 step (core/pipeline.l2_sliced) on
    the wideband block's captured front inputs: the L2 wrappers'
    counters around the call, and the device kernels a torch.profiler
    trace of that call alone records (the card idle before and after).
    Both must be 1 to 4 (the trace's where it records any)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dumpvdl2_tpu_torch.core import pipeline
    _, l2_kernel = l2_modules()
    args = got[("block", "l2_front")]
    pipeline.l2_sliced(*args)
    torch.cuda.synchronize()
    before = dict(l2_kernel.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipeline.l2_sliced(*args)
        torch.cuda.synchronize()
    counted = {k: v - before[k] for k, v in l2_kernel.launches.items()
               if v != before[k]}
    traced = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    n = sum(counted.values())
    if not 0 < n <= 4 or len(traced) > 4:
        raise AssertionError(f"the sliced L2 step launched {counted} by the "
                             f"wrappers' counters and {traced} by the "
                             f"trace, expected 1 to 4")
    return {"counted": counted, "launches": n,
            "traced": traced if traced else None}


def launch_floor() -> dict:
    """The card's floor for a launch: a one-element fill_, timed as the
    kernels are (profiler; CUDA events over back-to-back calls when it
    records none)."""
    x = torch.zeros(1, device="cuda")
    call_ms = cuda_ms(lambda: x.fill_(1.0), 200)
    ms = device_ms(lambda: x.fill_(1.0), 50, "FillFunctor")
    return {"ms": call_ms if ms is None else ms,
            "ms_from": "events" if ms is None else "profiler",
            "call_ms": call_ms}


def time_l2(got: dict, stage: str, sms: int, clock: float) -> dict:
    """Device (profiler) and wrapper-call times, plain times and bounds
    of L2P (as the path runs it, behind its compaction prologue where it
    does), L2D on the same rows and RS on L2D's tables (and the front
    where the path runs it, L2H at the sliced block) on the captured
    inputs of ``stage``."""
    _, l2_kernel = l2_modules()
    p_args = payload_args(got, stage)
    d_args = l2d_args(p_args)
    sym = p_args[0]
    blocks, fec = rs_rows_of(d_args)
    kernel, plain = l2p_calls(p_args)
    _, count, fec_row, *_ = kernel()
    Bp = fec_row.shape[0]
    times = {
        "l2_payload": {**time_gate(kernel, plain, "l2_payload_kernel"),
                       **l2p_bound(p_args, fec_row, count, sms, clock),
                       "shape": [Bp, 9, 255],
                       "rows_with_parity": int((fec_row != 0).sum().item())},
        "l2_deinterleave": {**time_gate(
            lambda: l2_kernel.l2_deinterleave_cuda(*d_args),
            lambda: l2_kernel.l2_deinterleave_plain(*d_args),
            "l2_deinterleave_kernel"), **l2d_bound(d_args, sms, clock),
            "shape": [Bp, 9, 255]},
        "rs_verify": {**time_gate(
            lambda: l2_kernel.rs_verify_cuda(blocks, fec),
            lambda: l2_kernel.rs_verify_plain(blocks, fec),
            "rs_verify_kernel"),
            **rs_bound(fec, count.reshape(-1), sms, clock),
            "shape": list(blocks.shape),
            "rows_with_parity": int((fec != 0).sum().item())}}
    if (stage, "l2_front") in got:
        times["l2_front"] = time_front(got[(stage, "l2_front")], sms, clock)
    if stage == "block":
        times["l2_header"] = {**time_gate(
            lambda: l2_kernel.l2_header_cuda(sym),
            lambda: l2_kernel.l2_header_plain(sym), "l2_header_kernel"),
            **l2h_bound(sym.shape[0], sms, clock),
            "shape": list(sym.shape)}
    return times


def check_l2(scene) -> dict:
    """KC, the L2 front, L2H, L2P, L2D and RS against their plain
    versions on the card: the wideband scene's real detection and L2
    inputs (sliced block and EOF), KC and the front on adversarial
    planes with far more leaders than slots, a fuzz of RS
    rows over every case of rs_verify, symbol rows of synthesized bursts
    and noise (sim.l2_fuzz) and of bursts whose rows carry the RS cases
    (sim.l2_rs_fuzz), both with the sliced path's compaction, odd parity
    counts through L2P, and the near-cap burst; then each kernel's
    device time, its plain version's and its bound at the sliced and
    EOF shapes, beside the card's floor for a launch."""
    l2_step, l2_kernel = l2_modules()
    got = capture_l2_inputs(scene)
    res = {"real": check_l2_captured(got, "wideband")}
    res["l2_step"] = step = l2_step_launches(got)
    log(f"the sliced L2 step on the block's inputs: {step['launches']} "
        f"launches by the wrappers' counters {step['counted']}; the "
        f"trace of the call alone: "
        + (f"{len(step['traced'])} kernels {step['traced']}"
           if step["traced"] else "no device records"))

    rows, fec = sim.rs_fuzz(24000, seed=21)
    fuzz = compare_rs(torch.as_tensor(rows, device="cuda"),
                      torch.as_tensor(fec, device="cuda"), "RS fuzz")
    res["rs_fuzz"] = fuzz
    log(f"RS fuzz: {fuzz['rows']} rows (fec_octets 0-7 and -1; 0-20 "
        f"errors), by count {fuzz['by_count']}: equal to its plain "
        f"version")

    for name, rows in (("L2 fuzz", sim.l2_fuzz(384, seed=22)),
                       ("L2 RS fuzz", sim.l2_rs_fuzz(256, seed=24))):
        sym = torch.as_tensor(rows, device="cuda")
        compare_l2h(sym, name)
        hdr = l2_kernel.l2_header_plain(sym)
        for cap in (None, 96):
            p_args = (sym, cap, hdr["hdr_ok"], hdr["num_blocks"],
                      hdr["last_len"], hdr["lf"], hdr["datalen_octets"])
            c = check_payload(p_args, f"{name}, cap {cap}")
            log(f"{name} ({tuple(sym.shape)} symbols, cap {cap}): "
                f"L2H, L2P, L2D and RS equal to their plain "
                f"versions; RS rows with parity by count "
                f"{c['l2p']['by_count']}")
            out = l2_step.l2_decode_batch(sym, sym.shape[1],
                                          rs_burst_cap=cap)
            want = l2_step.l2_decode_batch(sym.cpu(), sym.shape[1],
                                           rs_burst_cap=cap)
            for key, v in want.items():
                if not torch.equal(out[key].cpu(), v):
                    raise AssertionError(f"l2_decode_batch on the card "
                                         f"differs from the CPU's: {key}")
            res[f"{name}, {cap}"] = c
        if name == "L2 RS fuzz":
            # odd and out-of-range parity counts (RS_FUZZ_CASES[7])
            odd = torch.as_tensor(np.random.default_rng(25).choice(
                np.array([1, 3, 5, 7, -1], np.int32), size=sym.shape[0]),
                device="cuda")
            p = compare_l2p((sym, None, hdr["hdr_ok"], hdr["num_blocks"],
                             hdr["last_len"], odd, hdr["datalen_octets"]),
                            f"{name}, odd parity counts")
            if 6 not in p["by_count"] or -1 not in p["by_count"]:
                raise AssertionError(f"odd parity counts reached "
                                     f"{p['by_count']}, not 6 and -1")
            log(f"{name}, odd parity counts (1, 3, 5, 7, -1): L2P equal "
                f"to its plain version; rows by count {p['by_count']}")
            res[f"{name}, odd"] = p

    # the correctness vector's near-cap (1990-octet) burst
    _, _, _, _, vector = vector_signal()
    rng = np.random.default_rng(23)
    near = torch.as_tensor(sim.bits_to_symbol_row(
        sim.build_burst_bits([vector[2][1]]), sym.shape[1], rng)[None, :],
        device="cuda")
    compare_l2h(near, "near-cap burst")
    hdr = l2_kernel.l2_header_plain(near)
    p_args = (near, None, hdr["hdr_ok"], hdr["num_blocks"],
              hdr["last_len"], hdr["lf"], hdr["datalen_octets"])
    c = check_payload(p_args, "near-cap burst")
    out = l2_step.l2_decode_batch(near, near.shape[1])
    res_b = burst._result_from_batch(
        {k: v.cpu().numpy() for k, v in out.items()}, 0)
    if not res_b.ok or [bytes(f) for f in res_b.frames] != \
            [frame_with_fcs(vector[2][1])]:
        raise AssertionError(f"near-cap burst: {res_b.reason}")
    log(f"L2 near-cap burst: {int(hdr['num_blocks'][0])} RS blocks, "
        f"L2H, L2P, L2D and RS equal to their plain versions (RS rows "
        f"with parity by count {c['l2p']['by_count']}), the frame "
        f"decodes through the kernels")
    res["near_cap"] = {"num_blocks": int(hdr["num_blocks"][0]), **c}

    # times and bounds at the main path's shapes: the sliced block's and
    # the flush's, beside the card's floor for a launch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    floor = launch_floor()
    log(f"launch floor (a one-element fill_): {floor['ms']:.4f} ms "
        f"({floor['ms_from']}), a call {floor['call_ms']:.4f} ms")
    res["launch_floor"] = floor
    res["kc"] = check_kc_front(got, sms, clock, floor["ms"])
    for stage in ("block", "eof"):
        times = time_l2(got, stage, sms, clock)
        for name, t in times.items():
            log_time(name, stage, t, floor["ms"])
        parts = times["l2_deinterleave"]["ms"] + times["rs_verify"]["ms"]
        log(f"L2P at {stage}: {times['l2_payload']['ms']:.4f} ms against "
            f"L2D + RS {parts:.4f} ms in this call "
            f"({times['l2_payload']['ms'] / parts:.3f} of it)")
        res["times" if stage == "block" else "times_eof"] = times
    return res


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
    # the gated main path replays its steps as CUDA graphs from the
    # first block with the full halo (the third): one key, one capture
    want = int(pipe.use_device_gate and WIDEBAND_BLOCKS > 2)
    if pipe.graph_captures != want:
        raise AssertionError(f"the wideband pipeline captured its steps "
                             f"{pipe.graph_captures} times, expected {want}")
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
    kc, _ = front_modules()
    freqs, fs, os_, sig, _, _ = scene
    planes, gates, dets = [], [], []
    orig_k1, orig_g1 = sync_kernel.sync_error_metric_cuda, gate_kernel.gate
    orig_kc = kc.candidates_cuda

    def k1(ph):
        planes.append(ph)
        return orig_k1(ph)

    def g1(*a):
        gates.append(a)
        return orig_g1(*a)

    def kc_spy(*a):
        dets.append(a)
        return orig_kc(*a)

    pipe = MeshPipeline(freqs, int(CENTER), fs, os_, mesh_shape=shape,
                        devices=mesh_devices(shape))
    sync_kernel.sync_error_metric_cuda, gate_kernel.gate = k1, g1
    kc.candidates_cuda = kc_spy
    try:
        for b in range(2):
            pipe.feed_planar(sig[:, b * WIDEBAND_BLOCK:
                                 (b + 1) * WIDEBAND_BLOCK])
    finally:
        sync_kernel.sync_error_metric_cuda, gate_kernel.gate = orig_k1, orig_g1
        kc.candidates_cuda = orig_kc
    n = shape[0] * shape[1]
    return planes[n:2 * n], gates[-1], dets[n:2 * n]


def check_mesh_kernels(scene, shape) -> float:
    """K1, KC and G1 against their plain versions at the shapes the mesh
    path gives them: every shard's phase plane of a real block (equal
    inf and detection masks), every shard's metric planes with its
    detection window (detect_lo = the halo, detect_hi), and the real
    merged slot grid.  Returns K1's largest |d err|."""
    planes, ga, kc_args = capture_mesh_inputs(scene, shape)
    for t, a in enumerate(kc_args):
        r = compare_kc(a, f"mesh {shape} shard {t}")
        log(f"KC mesh {shape} shard {t} {tuple(r['shape'])}, detect "
            f"window [{a[5]}, {a[6]}): {r['leaders']} leaders, equal to "
            f"its plain version")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log_time("find_candidates (KC)", f"mesh {shape} shard 0",
             time_kc(kc_args[0], sms, max_sm_clock_hz()),
             launch_floor()["ms"])
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
    _, l2_kernel = l2_modules()
    kc, _ = front_modules()
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
        res[f"l2 {shape}"] = check_l2_captured(
            capture_l2_inputs(scene, shape), f"mesh {shape}")
        n_shards = shape[0] * shape[1]
        devs = mesh_devices(shape)
        run_mesh(scene, shape)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plain_calls: dict = {}
        restore = [count_calls(gate_kernel, GATE_PLAIN, plain_calls),
                   count_calls(l2_kernel, L2_PLAIN, plain_calls),
                   count_calls(sync_kernel, ("sync_error_metric_plain",),
                               plain_calls),
                   count_calls(kc, ("candidates_plain",), plain_calls)]
        try:
            reset_launches()
            t0 = time.perf_counter()
            frames, rereads = run_mesh(scene, shape)
            dt = time.perf_counter() - t0
            launches = {"sync_error_metric": sync_kernel.launches,
                        "find_candidates": kc.launches,
                        **gate_kernel.launches, **l2_kernel.launches}
        finally:
            for r in restore:
                r()
        peak = torch.cuda.max_memory_allocated()
        label = f"mesh {shape[0]}x{shape[1]}"
        if any(plain_calls.values()):
            raise AssertionError(f"{label}: plain versions ran on the card: "
                                 f"{plain_calls}")
        expect = {"sync_error_metric": n_shards * WIDEBAND_BLOCKS + 1,
                  "find_candidates": n_shards * WIDEBAND_BLOCKS + 1,
                  "gate": WIDEBAND_BLOCKS + 1,
                  "nf_track": WIDEBAND_BLOCKS + 1, "l2_front": 0,
                  **{k: WIDEBAND_BLOCKS + 1 for k in L2_MESH_KERNELS},
                  **{k: 0 for k in L2_STANDALONE}}
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
    single = next(r for r in recs if r.get("record") == "trace"
                  and r.get("scene") == "single")
    # information only: kernels are split by their midpoints between the
    # steps' annotations, so a short kernel at a step's edge can land in
    # its neighbour (check_l2's l2_step_launches counts the L2 step)
    by_stage = single["trace"]["kernels_by_stage"]
    log(f"profile: kernels a block by stage (steps synchronized, split by "
        f"the kernels' midpoints): {by_stage}")
    return {"records": recs, "kernels_by_stage": by_stage}


def reset_launches() -> None:
    _, l2_kernel = l2_modules()
    kc, _ = front_modules()
    sync_kernel.launches = 0
    kc.launches = 0
    for k in gate_kernel.launches:
        gate_kernel.launches[k] = 0
    for k in l2_kernel.launches:
        l2_kernel.launches[k] = 0
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
    l2_step, l2_kernel = l2_modules()
    kc, _ = front_modules()
    from dumpvdl2_tpu_torch.core import pipeline
    from dumpvdl2_tpu_torch.dsp import demod
    front_mods = {"candidates_kernel": kc, "demod": demod,
                  "pipeline": pipeline, "l2_kernel": l2_kernel,
                  "l2_step": l2_step}
    freqs, fs, os_, sig, want, _ = scene
    mode = "gated" if device_gate else "host-gated"
    # warm-up on a fresh pipeline: library handles, allocator pools
    run_wideband(freqs, fs, os_, sig[:, :WIDEBAND_BLOCK].contiguous()
                 .repeat(1, WIDEBAND_BLOCKS), device_gate=device_gate)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain_calls: dict = {}
    front_calls: dict = {}
    spec_calls: dict = {}
    restore = [count_calls(gate_kernel, GATE_PLAIN, plain_calls),
               count_calls(l2_kernel, L2_PLAIN, plain_calls),
               count_calls(unstuff, ("_frames_py",), spec_calls)]
    restore += [count_calls(front_mods[m], names, front_calls)
                for m, names in FRONT_PLAIN.items()]
    try:
        reset_launches()
        t0 = time.perf_counter()
        frames = run_wideband(freqs, fs, os_, sig, device_gate=device_gate)
        dt = time.perf_counter() - t0
        launches = {"sync_error_metric": sync_kernel.launches,
                    "find_candidates": kc.launches,
                    **gate_kernel.launches, **l2_kernel.launches}
        native_calls = dict(native.calls)
    finally:
        for r in restore:
            r()
    peak = torch.cuda.max_memory_allocated()
    if any(plain_calls.values()):
        raise AssertionError(f"wideband {mode}: plain versions of the gate "
                             f"or L2 kernels ran on the card: {plain_calls}")
    if any(front_calls.values()):
        raise AssertionError(f"wideband {mode}: plain detect or L2-front "
                             f"functions ran on the card: {front_calls}")
    if not all(launches[k] for k in L2_KERNELS + ("find_candidates",)) \
            or any(launches[k] for k in L2_STANDALONE + ("l2_header",)):
        raise AssertionError(f"wideband {mode}: a kernel of the main "
                             f"path never launched, or another did: "
                             f"{launches}")

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
        f"plain gate and L2 calls {plain_calls}, plain detect and L2-front "
        f"calls {front_calls}; native library calls "
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
    l2 = check_l2(scene)
    floor = l2["launch_floor"]["ms"]
    for name, t in (("K1", k1_main), ("G1", g1), ("G2", g2)):
        log(f"{name}: kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.6f} "
            f"ms, launch floor {floor:.4f} ms")

    vec = correctness_vector()
    launches, gated_frames, wb = wideband_path(scene, device_gate=True)
    # each kernel once a block and once at EOF
    want = {"sync_error_metric": WIDEBAND_BLOCKS + 1,
            "find_candidates": WIDEBAND_BLOCKS + 1,
            "gate": WIDEBAND_BLOCKS + 1, "nf_track": WIDEBAND_BLOCKS + 1,
            **{k: WIDEBAND_BLOCKS + 1 for k in L2_KERNELS},
            "l2_header": 0, **{k: 0 for k in L2_STANDALONE}}
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
        entry("find_candidates", "dumpvdl2_tpu_torch/csrc/candidates.cu",
              "dumpvdl2_tpu/dsp/demod.py:159", l2["kc"]["times"]["block"],
              0),
        entry("l2_front", "dumpvdl2_tpu_torch/csrc/l2.cu",
              "dumpvdl2_tpu/core/pipeline.py:121",
              l2["times"]["l2_front"], max(
                  r["front"]["frame_pwr_max_abs_err"]
                  for r in l2["real"].values())),
        entry("l2_header", "dumpvdl2_tpu_torch/csrc/l2.cu",
              "dumpvdl2_tpu/fec/l2_tpu.py:63", l2["times"]["l2_header"], 0),
        # the main path's L2P runs behind its compaction prologue
        entry("l2_payload", "dumpvdl2_tpu_torch/csrc/l2.cu",
              "dumpvdl2_tpu/fec/l2_tpu.py:63",
              l2["times"]["l2_payload"], 0),
        entry("l2_deinterleave", "dumpvdl2_tpu_torch/csrc/l2.cu",
              "dumpvdl2_tpu/fec/l2_tpu.py:63",
              l2["times"]["l2_deinterleave"], 0),
        entry("rs_verify", "dumpvdl2_tpu_torch/csrc/l2.cu",
              "dumpvdl2_tpu/fec/rs_tpu.py:252", l2["times"]["rs_verify"],
              0),
    ]}
    log(json.dumps({"wideband_gated": wb, "wideband_host_gated": wb_host,
                    "modes_max_d_nf_db": d_nf, "vector": vec, "cli": cli,
                    "host_l2": host_l2, "mesh": mesh,
                    "multihost": multi, "profile": prof,
                    "host_library": host_lib,
                    "k1": k1_main, "g1": g1, "g2": g2, "l2": l2,
                    "card": card}))
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
