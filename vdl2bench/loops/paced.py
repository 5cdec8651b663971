"""Paced loop: blocks released at the radio's rate, as a live station
receives them.

The scene is the whole window's stream, made on the device and held as
host complex64 blocks of the config's block size (the CLI's input loop
reads such blocks).  Block b is released when its last sample is due:
at the stream's start on the wall clock plus (b + 1) blocks over the
sample rate.  Each block goes through ``feed`` and its
frames through the protocol stack and the JSON output, as in the CLI's
input loop; after the last block, ``finish()``.

With ``trace``, a stretch of the window runs under the profiler.
"""
from __future__ import annotations

import math
import time

import numpy as np

from .. import trace as tracing

LEAD_S = 0.05             # the stream's start, after the window opens
PROFILE_FROM = 4          # first block under the profiler (trace runs)
PROFILE_BLOCKS = 8


def make_stream(run) -> None:
    from ..traffic import scene as S
    N = int(run.cfg["block_samples"])
    fs = S.sample_rate(run.cfg)
    n_blocks = math.ceil(run.seconds * fs / N)
    run.scene = S.schedule(run.cfg, run.mix, run.seed, n_blocks * N)
    sig = S.render(run.scene, run.seed, run.device)
    host = sig.cpu().numpy()
    del sig
    iq = np.empty(host.shape[1], np.complex64)
    iq.real, iq.imag = host[0], host[1]
    run.blocks = [iq[b * N:(b + 1) * N] for b in range(n_blocks)]
    run.block = N


def warm_up(run) -> None:
    """The cell's shapes on a throwaway pipeline: the first blocks (the
    halo grows over two), the flush, the stack; with ``trace`` the
    profiler."""
    pipe = run.new_pipeline()
    dec = run.new_decoder()
    for b in range(min(4, len(run.blocks))):
        dec.process_all(pipe.feed(run.blocks[b]))
    if run.trace:
        tracing.profiled(lambda: dec.process_all(pipe.feed(run.blocks[0])))
    dec.process_all(pipe.finish())
    dec.shutdown()


def window(run, seconds: float) -> dict:
    pipe, dec = run.pipe, run.decoder
    from ..traffic import scene as S
    fs = S.sample_rate(run.cfg)
    period = run.block / fs
    emitted, released, feed_s = [], [], []
    prof = None
    t0 = time.perf_counter()
    start = t0 + LEAD_S

    def one(b: int) -> None:
        due = start + (b + 1) * period
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        t_rel = time.perf_counter()
        got = pipe.feed(run.blocks[b])
        t_ret = time.perf_counter()
        released.append(t_rel)
        feed_s.append(t_ret - t_rel)
        emitted.extend((b, t_ret, f) for f in got)
        dec.process_all(got)

    b = 0
    while b < len(run.blocks):
        if run.trace and b == PROFILE_FROM:
            last = min(b + PROFILE_BLOCKS, len(run.blocks))

            def stretch(lo=b, hi=last):
                for k in range(lo, hi):
                    one(k)
            prof = tracing.profiled(stretch)
            b = last
            continue
        one(b)
        b += 1
    got = pipe.finish()
    t_fin = time.perf_counter()
    emitted.extend((len(run.blocks), t_fin, f) for f in got)
    dec.process_all(got)
    dec.shutdown()
    t1 = time.perf_counter()
    return {"blocks": len(run.blocks), "raw_fed": len(run.blocks) * run.block,
            "t0": t0, "t1": t1, "start": start, "period": period,
            "block": run.block,
            "emitted": emitted, "released": released, "feed_s": feed_s,
            "profile": prof}
