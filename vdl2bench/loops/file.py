"""File input: the scene recorded as an interleaved S16_LE capture file
and read back through the port's file path, as a station reprocesses a
capture with ``--iq-file``, as fast as the program takes it.

``make_stream`` renders the closed loop's pool, quantizes it as a
recorder does (round half to even, saturating at full scale) and writes
it as one file under the run's directory (removed with it); the check's
pool is what ``reference/capture.py`` reads back from that file.  The
window drives the timed pipeline through ``io/iqfile.py::feed_iq_file``,
the function the CLI's ``--iq-file`` calls, in reads of the config's
``read_bytes`` (one block each), seeking back to the file's start at its
end so that the stream cycles the pool; after ``seconds`` it stops on a
block boundary and calls ``finish()``.  Every returned frame goes
through the protocol stack and the JSON output.

With ``trace``, as in the closed loop, the window holds two stretches:
the first STEP_BLOCKS blocks with the pipeline's ``step_ms`` on (each
step synchronized; they also capture the graphs and fill the halo),
then PROFILE_BLOCKS blocks under the profiler with it off; the rest
runs as without ``trace``.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import trace as tracing

STEP_BLOCKS = 24          # blocks with step_ms on (trace runs)
PROFILE_BLOCKS = 8        # blocks under the profiler (trace runs)


def quantize(sig: torch.Tensor, full_scale: float) -> np.ndarray:
    """Planar (2, n) float samples -> interleaved S16_LE values, as a
    recorder writes them: scaled so that ``full_scale`` is 32 768,
    rounded half to even and saturated at [-32 768, 32 767]."""
    q = torch.round(sig * (32768.0 / full_scale)).clamp_(-32768, 32767)
    return q.to(torch.int16).t().contiguous().cpu().numpy() \
        .astype("<i2").reshape(-1)


class Capture:
    """The capture file read as an endless stream: at its end, back to
    its start.  ``served`` counts the bytes read."""

    def __init__(self, path: str):
        self.f = open(path, "rb", buffering=0)
        self.served = 0

    def readinto(self, b) -> int:
        n = self.f.readinto(b)
        if not n:
            self.f.seek(0)
            n = self.f.readinto(b)
        self.served += n
        return n

    def close(self) -> None:
        self.f.close()


def make_stream(run) -> None:
    """The capture of ``pool_blocks`` blocks, and the check's pool read
    back from it."""
    from ..reference import capture
    from ..traffic import scene as S
    N = int(run.cfg["block_samples"])
    P = int(run.mix["pool_blocks"])
    if int(run.cfg["read_bytes"]) != 4 * N \
            or run.cfg["sample_format"] != "S16_LE":
        raise ValueError("the file loop reads one S16_LE block a read")
    run.scene = S.schedule(run.cfg, run.mix, run.seed, P * N)
    sig = S.render(run.scene, run.seed, run.device)
    run.capture = os.path.join(run.out_dir, "capture.cs16")
    quantize(sig, float(run.cfg["full_scale"])).tofile(run.capture)
    del sig
    full = capture.read(run.capture, run.device)
    run.pool = [full[:, b * N:(b + 1) * N].contiguous() for b in range(P)]
    del full
    run.block = N


def _feed(run, pipe, decoder, cap, stop) -> None:
    from dumpvdl2_tpu_torch.io.iqfile import feed_iq_file
    feed_iq_file(pipe, decoder, cap, run.cfg["sample_format"],
                 read_bytes=int(run.cfg["read_bytes"]), stop=stop,
                 finish=False)


def _blocks_read(run, cap) -> int:
    return cap.served // int(run.cfg["read_bytes"])


def warm_up(run) -> None:
    """The cell's shapes through the file path on a throwaway pipeline:
    its first three blocks (no halo, a growing halo, the full halo), its
    flush and the stack; with ``trace`` the synchronized steps and the
    profiler too."""
    pipe = run.new_pipeline()
    dec = run.new_decoder()
    cap = Capture(run.capture)
    if run.trace:
        pipe.step_ms = {}
    try:
        _feed(run, pipe, dec, cap, lambda: _blocks_read(run, cap) >= 3)
        if run.trace:
            pipe.step_ms = None
            tracing.profiled(lambda: _feed(
                run, pipe, dec, cap, lambda: _blocks_read(run, cap) >= 4))
    finally:
        cap.close()
    dec.process_all(pipe.finish())
    dec.shutdown()
    torch.cuda.synchronize(run.device) if run.device.type == "cuda" \
        else None


class _Recorder:
    """The decoder as feed_iq_file sees it: each call's frames recorded
    as (block, return time, frame) and sent through the stack, whose
    time counts outside the profiled stretch; ``block_s`` each block's
    wall from the end of the previous call (its read and feed_raw)."""

    def __init__(self, dec, cap, run):
        self.dec, self.cap, self.run = dec, cap, run
        self.emitted, self.block_s = [], []
        self.stack_s, self.n_stack = 0.0, 0
        self.timed = True
        self.last = time.perf_counter()

    def process_all(self, frames, block=None) -> None:
        s = time.perf_counter()
        if block is None:
            block = _blocks_read(self.run, self.cap) - 1
            if self.timed:
                self.block_s.append(s - self.last)
        self.emitted.extend((block, s, f) for f in frames)
        self.dec.process_all(frames)
        self.last = time.perf_counter()
        if self.timed:
            self.stack_s += self.last - s
            self.n_stack += len(frames)


def window(run, seconds: float) -> dict:
    """The timed window; returns what the check and the metrics read."""
    pipe, dec = run.pipe, run.decoder
    cap = Capture(run.capture)
    rec = _Recorder(dec, cap, run)
    prof = None
    limit = getattr(run, "max_blocks", None)
    try:
        t0 = rec.last = time.perf_counter()
        if run.trace:
            pipe.step_ms = {}
            _feed(run, pipe, rec, cap,
                  lambda: _blocks_read(run, cap) >= STEP_BLOCKS)
            run.step_ms, pipe.step_ms = dict(pipe.step_ms), None
            run.step_blocks = STEP_BLOCKS
            rec.timed = False
            prof = tracing.profiled(lambda: _feed(
                run, pipe, rec, cap, lambda: _blocks_read(run, cap)
                >= STEP_BLOCKS + PROFILE_BLOCKS))
            rec.timed = True
            rec.last = time.perf_counter()
        _feed(run, pipe, rec, cap, lambda: (
            time.perf_counter() - t0 >= seconds
            or (limit is not None and _blocks_read(run, cap) >= limit)))
        blocks = _blocks_read(run, cap)
        rec.process_all(pipe.finish(), block=blocks)
        dec.shutdown()
        t1 = time.perf_counter()
        rec.stack_s += t1 - rec.last
    finally:
        cap.close()
    return {"blocks": blocks, "raw_fed": blocks * run.block, "t0": t0,
            "t1": t1, "emitted": rec.emitted, "stack_s": rec.stack_s,
            "stack_frames": rec.n_stack, "block_s": rec.block_s,
            "profile": prof}
