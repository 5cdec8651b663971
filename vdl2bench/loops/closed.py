"""Closed loop: the next block goes in as soon as ``feed_planar``
returns, as when a station catches up on a capture or a backlog.

The scene is a pool of device-resident planar blocks, cycled; no burst
straddles the pool's wrap.  The window runs whole blocks until
``seconds`` have passed, then ``finish()``; every returned frame goes
through the protocol stack and the JSON output.

With ``trace``, the window holds two stretches: the first blocks with
the pipeline's ``step_ms`` on (each step synchronized), then a stretch
under the profiler with it off; the rest runs as without ``trace``.
"""
from __future__ import annotations

import time

import torch

from .. import trace as tracing

STEP_BLOCKS = 24          # blocks with step_ms on (trace runs)
PROFILE_BLOCKS = 8        # blocks under the profiler (trace runs)


def make_stream(run) -> None:
    """The pool: ``pool_blocks`` blocks of the config's block size."""
    from ..traffic import scene as S
    N = int(run.cfg["block_samples"])
    P = int(run.mix["pool_blocks"])
    run.scene = S.schedule(run.cfg, run.mix, run.seed, P * N)
    sig = S.render(run.scene, run.seed, run.device)
    run.pool = [sig[:, b * N:(b + 1) * N].contiguous() for b in range(P)]
    del sig
    run.block = N


def warm_up(run) -> None:
    """The cell's shapes: a pipeline's first three blocks (no halo, a
    growing halo, the full halo), its flush, and the stack, on a
    throwaway pipeline; with ``trace`` the synchronized steps and the
    profiler too."""
    pipe = run.new_pipeline()
    dec = run.new_decoder()
    if run.trace:
        pipe.step_ms = {}
    for b in range(3):
        dec.process_all(pipe.feed_planar(run.pool[b % len(run.pool)]))
    if run.trace:
        pipe.step_ms = None
        tracing.profiled(lambda: dec.process_all(
            pipe.feed_planar(run.pool[3 % len(run.pool)])))
    dec.process_all(pipe.finish())
    dec.shutdown()
    torch.cuda.synchronize(run.device) if run.device.type == "cuda" \
        else None


def window(run, seconds: float) -> dict:
    """The timed window; returns what the check and the metrics read."""
    pipe, dec, P = run.pipe, run.decoder, len(run.pool)
    emitted = []            # (call index, return time, frame)
    block_s = []            # each timed feed_planar call's wall seconds
    stack_s = 0.0
    n_stack = 0
    prof = None
    i = 0
    t0 = time.perf_counter()
    while True:
        if run.trace and i == 0:
            pipe.step_ms = {}
        if run.trace and i == STEP_BLOCKS:
            run.step_ms, pipe.step_ms = dict(pipe.step_ms), None
            run.step_blocks = STEP_BLOCKS

            def stretch():
                nonlocal i, stack_s, n_stack
                for _ in range(PROFILE_BLOCKS):
                    got = pipe.feed_planar(run.pool[i % P])
                    t = time.perf_counter()
                    emitted.extend((i, t, f) for f in got)
                    dec.process_all(got)
                    i += 1
            prof = tracing.profiled(stretch)
            continue
        b0 = time.perf_counter()
        got = pipe.feed_planar(run.pool[i % P])
        s = time.perf_counter()
        block_s.append(s - b0)
        emitted.extend((i, s, f) for f in got)
        dec.process_all(got)
        stack_s += time.perf_counter() - s
        n_stack += len(got)
        i += 1
        if (time.perf_counter() - t0 >= seconds and
                (not run.trace or i > STEP_BLOCKS)) or \
                i >= getattr(run, "max_blocks", i + 1):
            break
    got = pipe.finish()
    s = time.perf_counter()
    emitted.extend((i, s, f) for f in got)
    dec.process_all(got)
    dec.shutdown()
    t1 = time.perf_counter()
    stack_s += t1 - s
    n_stack += len(got)
    return {"blocks": i, "raw_fed": i * run.block, "t0": t0, "t1": t1,
            "emitted": emitted, "stack_s": stack_s, "stack_frames": n_stack,
            "block_s": block_s, "profile": prof}
