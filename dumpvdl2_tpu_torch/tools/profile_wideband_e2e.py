"""Stage profile of a wideband block of the port (a measurement aid).

Counterpart of the JAX package's ``tools/profile_wideband_e2e.py``, on
its scene: 256 channels at oversample 80 (8.4 Msps), noise from seed 7
and 24 bursts on stride-4 channels in one block of 52 428 decimated
samples (4 194 240 raw, the multiple of 80 nearest 2**22), fed again
and again.  Two scenes:

* ``single``: VDL2Pipeline with device L2 and device gating.  After
  three warm-up feeds each staged block is a ``feed_planar`` call with
  the pipeline's ``step_ms`` on: each step waits for the device and the
  block is fetched and drained in the same call.  Its times come from
  the pipeline's own span log (core/spans.py): ``feed_planar``,
  ``dispatch`` and its steps ``detect``, ``l2``, ``gate`` (each holding
  its device work), ``fetch_host`` (the fetch and the drain), ``fetch``
  on the fetch thread, ``drain`` with its ``drain.wait`` and
  ``drain.verdicts`` (_process_verdicts), its frames, and on CUDA the
  device ms of each step from the pipeline's events.  These staged
  blocks are serialized: the device waits through the fetch and the
  host step.  The staged blocks' frames, with finish()'s, must equal
  those of feed_planar on a fresh pipeline of as many blocks; that
  run's steady blocks give feed_planar's own ms a block (dispatch
  overlapped with the drain of a block two behind) and their spans as
  they run, and one more of its blocks is traced as it runs, after a
  lead-in block: the idle share of the receive path.
* ``mesh``: the same block through MeshPipeline at mesh (1, 2) on
  ``--mesh-devices`` (the device twice by default).  Synchronized
  blocks give each shard's channelizer and detection ms, the rest of
  the sharded step as ``gather`` (the block's copies to the shards, the
  halos, the gather, the carried state), the L2 launch, the gate, the
  drain, the raw tail's upkeep and the rest of feed_planar as ``host``
  (the block's copy to the host, its concatenations); an
  unsynchronized block gives its wall.

For each scene one more block runs under torch.profiler (for
``single`` a staged block, whose steps' kernels lie in their spans, and
the feed_planar block above); the profiler records every thread, so the
traces carry the pipeline's ``vdl2.*`` spans on both of its threads as
stage annotations.  A trace is reduced to the block's wall ms, the
union of the device's kernel, copy and set intervals, the device idle
share 1 - union / wall, the kernel launches (in all and by stage
annotation), the 10 device ops with the most time, the host ms and the
device's idle ms inside each stage annotation, and the 5 longest idle
gaps with the stage and host op running in each.  The profiler slows
the host, so the traced block's wall stands beside an untraced one's.
On the CPU the fields that need the card are null.  The steady traced
blocks' device times by step, which the pipeline takes between timing
events, stand beside the kernel time that the trace shows launched in
each step's span (``events_vs_kernels``).  Last, the span log's own
cost on the pipeline's feed_planar of the block: microseconds a block
inside the log's methods on the main thread and on the fetch thread,
as the blocks run and with each drained in its own call
(``span_log_cost``).

JSON lines go to stdout, a summary to stderr.  From the repository root:

    python3 dumpvdl2_tpu_torch/tools/profile_wideband_e2e.py
    python3 dumpvdl2_tpu_torch/tools/profile_wideband_e2e.py \\
        --device cpu --channels 8 --oversample 20 --blocks 2
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from torch.profiler import (ProfilerActivity, _ExperimentalConfig, profile,
                            record_function)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from dumpvdl2_tpu_torch.constants import SPS, SYMBOL_RATE  # noqa: E402
from dumpvdl2_tpu_torch.core import nf_gate  # noqa: E402
from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline  # noqa: E402
from dumpvdl2_tpu_torch.core.spans import FETCH, STEPS  # noqa: E402
from dumpvdl2_tpu_torch.dsp.frontend import to_planar  # noqa: E402
from dumpvdl2_tpu_torch.parallel import sharded  # noqa: E402
from dumpvdl2_tpu_torch.sim import synthesize_iq_raw  # noqa: E402
from dumpvdl2_tpu_torch.utils.devices import resolve_device  # noqa: E402

CENTER = 136975000
BLOCK_DEC = (1 << 22) // 80          # decimated samples a block
SPANS = ("feed_planar", "dispatch", "detect", "l2", "gate", "fetch_host",
         "drain", "drain.wait", "drain.verdicts")
FETCH_PARTS = ("gout", "cand", "l2", "map")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LOG_METHODS = ("new_block", "open", "close", "add", "fetched")
HOST_CATS = ("cpu_op", "cuda_runtime")
WARM_BLOCKS = 2


def make_scene(channels: int, oversample: int, seed: int = 7,
               block_dec: int = BLOCK_DEC):
    """The JAX tool's scene at ``channels`` and ``oversample``: noise and
    up to 24 bursts on stride-4 channels in one planar block of
    ``block_dec * oversample`` samples.  Returns (freqs, fs, planar)."""
    fs = SYMBOL_RATE * SPS * oversample
    freqs = [int(CENTER - 25e3 * (i - channels // 2))
             for i in range(channels)]
    n = block_dec * oversample
    rng = np.random.default_rng(seed)
    sig = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64) * 0.02
    stride4 = np.arange(0, channels, 4)
    n_active = min(24, stride4.size)
    active = rng.choice(stride4, size=n_active, replace=False)
    for k, ch in enumerate(active):
        burst = synthesize_iq_raw(
            [b"wideband e2e burst ch%03d payload " % ch * 4],
            oversample=oversample, carrier_offset_hz=freqs[ch] - CENTER,
            seed=int(ch)).astype(np.complex64)
        off = 60000 + (k * (n - 2 * 60000 - burst.size)) // n_active
        sig[off:off + burst.size] += burst * 0.5
    return freqs, int(fs), to_planar(sig)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def block_stages(blk) -> dict:
    """A block record's span ms (``<span>_ms``, dots as underscores;
    ``fetch_ms`` on the fetch thread), device ms by step
    (``<step>_dev_ms``, None off CUDA), the bytes its fetch copied by
    part and frames."""
    st = {f"{name.replace('.', '_')}_ms": blk.ms(name) for name in SPANS}
    st["fetch_ms"] = blk.ms("fetch", FETCH)
    for key in STEPS + ("fetch_lag",):
        st[f"{key}_dev_ms"] = getattr(blk, f"{key}_dev")
    st["fetch_bytes"] = None if blk.fetch_bytes is None else \
        dict(zip(FETCH_PARTS, blk.fetch_bytes))
    st["frames"] = blk.frames
    return st


def staged_block(pipe: VDL2Pipeline, planar: torch.Tensor):
    """One block through feed_planar with the pipeline's ``step_ms`` on
    (each step synchronized, the block drained in the call).  Returns
    (its stages from the pipeline's span log, frames)."""
    pipe.step_ms = {}
    try:
        frames = pipe.feed_planar(planar)
    finally:
        pipe.step_ms = None
    return block_stages(pipe.span_log.blocks[-1]), frames


def traced(fn, devices):
    """Run ``fn()`` under torch.profiler; ``fn`` marks one ``block``
    annotation.  Returns its result and the trace's summary
    (summarize_trace)."""
    acts = [ProfilerActivity.CPU]
    cuda = any(d.type == "cuda" for d in devices)
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=acts, experimental_config=every_thread) as prof:
        out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, summarize_trace(events, cuda)


def synced_block(fn, devices):
    """``fn`` as a traced ``block`` that starts with the devices idle and
    ends when their work is done."""
    def block():
        for d in devices:
            _sync(d)
        with record_function("block"):
            out = fn()
            for d in devices:
                _sync(d)
        return out
    return block


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(events, t: float):
    """Name of the shortest event that spans time ``t``, or None."""
    hits = [e for e in events if e["ts"] <= t <= e["ts"] + e["dur"]]
    return min(hits, key=lambda e: e["dur"])["name"] if hits else None


def kernel_ms_by_span(xs: list) -> dict:
    """For each instance of a step annotation (``vdl2.detect``,
    ``vdl2.l2``, ``vdl2.gate``), in time order: the device ms of the
    kernels, copies and sets launched inside it on its thread (each
    matched to its launch by correlation id), their count, and the ms
    from the first one's start to the last one's end."""
    launches = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launches[c] = (e["tid"], e["ts"])
    dev = [(launches.get(e.get("args", {}).get("correlation")), e)
           for e in xs if e.get("cat") in DEVICE_CATS]
    out = {}
    for step in STEPS:
        rows = []
        for a in sorted((e for e in xs if e.get("cat") == "user_annotation"
                         and e["name"] == "vdl2." + step),
                        key=lambda e: e["ts"]):
            a0, a1 = a["ts"], a["ts"] + a["dur"]
            ops = [e for at, e in dev if at is not None
                   and at[0] == a["tid"] and a0 <= at[1] <= a1]
            rows.append({
                "kernel_ms": sum(e["dur"] for e in ops) / 1e3,
                "ops": len(ops),
                "first_to_last_ms": (max(e["ts"] + e["dur"] for e in ops)
                                     - min(e["ts"] for e in ops)) / 1e3
                if ops else 0.0})
        out[step] = rows
    return out


def events_vs_kernels(blocks: list, by_span: dict) -> list:
    """The last dispatch records of ``blocks``, as many as the trace
    has step annotations and in order, beside their steps' kernels: for
    each step the record's event interval (``event_ms``) and the
    trace's kernel ms, count and first-to-last ms of its annotation."""
    n = min(len(rows) for rows in by_span.values())
    out = []
    for i, blk in enumerate(blocks[len(blocks) - n:]):
        rec = {"seq": blk.seq}
        for step in STEPS:
            rec[step] = {"event_ms": getattr(blk, f"{step}_dev"),
                         **by_span[step][len(by_span[step]) - n + i]}
        out.append(rec)
    return out


def summarize_trace(events: list, device_trace: bool) -> dict:
    """Reduce a chrome trace holding one ``block`` annotation: the
    block's wall ms; with ``device_trace`` also the union of device
    intervals inside it, the idle share, the kernel launches and copies,
    the top 10 device ops by total time, the device's idle ms inside
    each stage annotation (nested ones count in each), the 5 longest
    idle gaps (the stage annotation and innermost host op spanning each
    gap's middle), the kernels whose middle lies in each stage
    annotation (the stage's own launches where its annotations
    synchronize the device before and after), and the kernel time
    launched in each step annotation of the whole trace
    (kernel_ms_by_span).  Without a device trace those fields are None.
    ``stage_ms`` is the host wall of each stage annotation inside the
    block, summed over its calls."""
    xs = [e for e in events if isinstance(e, dict) and e.get("ph") == "X"
          and "dur" in e]
    block = max((e for e in xs if e.get("cat") == "user_annotation"
                 and e["name"] == "block"), key=lambda e: e["dur"])
    t0, t1 = block["ts"], block["ts"] + block["dur"]
    stages = [e for e in xs if e.get("cat") == "user_annotation"
              and e["name"] != "block" and e["ts"] < t1
              and e["ts"] + e["dur"] > t0]
    stage_ms: dict = {}
    for e in stages:
        stage_ms[e["name"]] = stage_ms.get(e["name"], 0.0) + e["dur"] / 1e3
    out = {"wall_ms": block["dur"] / 1e3, "stage_ms": stage_ms,
           "device_busy_ms": None,
           "idle_share": None, "kernel_launches": None, "copies": None,
           "kernels_by_stage": None, "kernel_ms_by_span": None,
           "top_ops": None, "idle_ms_by_stage": None, "idle_gaps": None}
    if not device_trace:
        return out
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    merged = _merge([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                     for e in dev])
    busy = sum(e - s for s, e in merged)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(((e - s, s) for s, e in idle),
                  key=lambda g: (-g[0], g[1]))[:5]
    idle_by_stage: dict = {}
    for e in stages:
        a, b = e["ts"], e["ts"] + e["dur"]
        idle_by_stage[e["name"]] = idle_by_stage.get(e["name"], 0.0) + sum(
            max(0.0, min(b, ie) - max(a, is_)) for is_, ie in idle) / 1e3
    host = [e for e in xs if e.get("cat") in HOST_CATS]
    ops: dict = {}
    for e in dev:
        tot, n = ops.get(e["name"], (0.0, 0))
        ops[e["name"]] = (tot + e["dur"], n + 1)
    kernels_by_stage: dict = {}
    for e in stages:
        a, b = e["ts"], e["ts"] + e["dur"]
        kernels_by_stage[e["name"]] = kernels_by_stage.get(
            e["name"], 0) + sum(a <= k["ts"] + k["dur"] / 2 <= b
                                for k in dev if k["cat"] == "kernel")
    out.update(
        device_busy_ms=busy / 1e3, idle_share=1.0 - busy / block["dur"],
        kernel_launches=sum(e["cat"] == "kernel" for e in dev),
        kernels_by_stage=kernels_by_stage,
        kernel_ms_by_span=kernel_ms_by_span(xs),
        copies=sum(e["cat"] != "kernel" for e in dev),
        top_ops=[{"name": k, "ms": v[0] / 1e3, "count": v[1]}
                 for k, v in sorted(ops.items(), key=lambda kv: -kv[1][0])
                 [:10]],
        idle_ms_by_stage=idle_by_stage,
        idle_gaps=[{"ms": g / 1e3, "at_ms": (s - t0) / 1e3,
                    "stage": _innermost(stages, s + g / 2),
                    "host_op": _innermost(host, s + g / 2)}
                   for g, s in gaps])
    return out


def frame_rows(frames) -> list:
    """(bytes, freq, idx, datalen, syndrome weight, FEC corrections,
    ppm error, frame power, noise floor) of each frame."""
    return [(bytes(f.frame), f.metadata.freq, f.metadata.idx,
             f.metadata.datalen_octets, f.metadata.synd_weight,
             f.metadata.num_fec_corrections, f.metadata.ppm_error,
             f.metadata.frame_pwr_dbfs, f.metadata.nf_pwr_dbfs)
            for f in frames]


def profile_single(freqs, fs, oversample, planar, device, blocks: int
                   ) -> dict:
    """The single-device scene: ``blocks`` staged blocks and a traced
    one after the warm-up, then a fresh pipeline's feed_planar on as
    many blocks, ``blocks`` of them timed (with their spans) and a
    steady one traced; raises when the staged frames are not
    feed_planar's."""
    pipe = VDL2Pipeline(freqs, CENTER, fs, oversample, device=device)
    if not (pipe.use_device_l2 and pipe.use_device_gate):
        raise RuntimeError("the staged profile needs device L2 and device "
                           "gating (DUMPVDL2_TPU_L2 / DUMPVDL2_TPU_GATE)")
    frames = []
    for _ in range(WARM_BLOCKS):
        frames += pipe.feed_planar(planar)
    frames += pipe._drain_pending()
    stats = []
    for _ in range(blocks):
        st, fr = staged_block(pipe, planar)
        stats.append(st)
        frames += fr
    (st, fr), trace = traced(synced_block(
        lambda: staged_block(pipe, planar), [device]), [device])
    # one block more as feed_planar runs it: as many blocks in all as
    # the run below, whose lead-in and traced blocks these two stand for
    frames += fr + pipe.feed_planar(planar) + pipe.finish()

    ref = VDL2Pipeline(freqs, CENTER, fs, oversample, device=device)
    want = []
    for _ in range(WARM_BLOCKS):
        want += ref.feed_planar(planar)
    _sync(ref.device)
    t0 = time.perf_counter()
    for _ in range(blocks):
        want += ref.feed_planar(planar)
    _sync(ref.device)
    feed_ms = (time.perf_counter() - t0) * 1e3 / blocks

    def steady_block():
        # the lead-in block's device work, still running when the
        # traced block starts, is in the trace too
        out = ref.feed_planar(planar)
        with record_function("block"):
            out += ref.feed_planar(planar)
        return out

    fr, feed_trace = traced(steady_block, [device])
    want += fr + ref.finish()
    records = list(ref.span_log.blocks)
    steady = [block_stages(b) for b in
              records[WARM_BLOCKS:WARM_BLOCKS + blocks]]
    by_span = feed_trace["kernel_ms_by_span"]
    checked = None if by_span is None else events_vs_kernels(
        [b for b in records if b.span("dispatch")], by_span)
    got_rows, want_rows = frame_rows(frames), frame_rows(want)
    if [r[:6] for r in got_rows] != [r[:6] for r in want_rows]:
        raise AssertionError(f"staged frames differ from feed_planar's: "
                             f"{len(got_rows)} against {len(want_rows)}")
    d_float = max((abs(a - b) for g, w in zip(got_rows, want_rows)
                   for a, b in zip(g[6:], w[6:])), default=0.0)
    if not d_float <= 1e-4:
        raise AssertionError(f"staged frames' ppm, power or noise floor "
                             f"differ from feed_planar's by {d_float}")
    return {"blocks": stats, "traced_block": st, "trace": trace,
            "feed_planar_block_ms": feed_ms,
            "feed_planar_blocks": steady,
            "feed_planar_trace": feed_trace,
            "events_vs_kernels": checked,
            "frames": len(frames), "frames_equal_feed_planar": True,
            "max_float_diff": d_float}


class _Timers:
    """Wrap callables so that each call is timed, synchronized on the
    devices before and after (``sync``), and annotated for the
    profiler; ``restore()`` puts the originals back."""

    def __init__(self, devices, sync: bool):
        self.devices, self.sync = devices, sync
        self.ms: dict = {}
        self._undo = []

    def _wait(self):
        if self.sync:
            for d in self.devices:
                _sync(d)

    def wrap(self, owner, attr: str, key: str):
        orig = getattr(owner, attr)

        def fn(*a, **kw):
            self._wait()
            t0 = time.perf_counter()
            with record_function(key):
                out = orig(*a, **kw)
                self._wait()        # the step's device work inside it
            self.ms.setdefault(key, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out

        had = attr in vars(owner)
        setattr(owner, attr, fn)
        self._undo.append((owner, attr, orig, had))

    def restore(self):
        for owner, attr, orig, had in reversed(self._undo):
            if had:
                setattr(owner, attr, orig)
            else:            # a bound method: the class's again
                delattr(owner, attr)
        self._undo = []


def _mesh_timers(pipe, sync: bool) -> _Timers:
    t = _Timers(sorted(set(pipe.mesh.devices), key=str), sync)
    t.wrap(sharded, "bandpass_channelize", "channelize")
    t.wrap(sharded, "find_and_slice", "detect")
    t.wrap(pipe, "step", "step")
    t.wrap(pipe, "_launch_l2_flat", "l2")
    t.wrap(nf_gate, "gate_nf_mesh", "gate")
    t.wrap(pipe, "_drain_pending", "drain")
    t.wrap(pipe, "_push_tail", "tail")
    return t


def profile_mesh(freqs, fs, oversample, planar, devices, blocks: int
                 ) -> dict:
    """The mesh (1, 2) scene: ``blocks`` synchronized blocks with the
    per-step split, an unsynchronized block and a traced one."""
    from dumpvdl2_tpu_torch.core.mesh_pipeline import MeshPipeline
    pipe = MeshPipeline(freqs, CENTER, fs, oversample, mesh_shape=(1, 2),
                        devices=devices)
    devs = sorted(set(pipe.mesh.devices), key=str)

    def wait():
        for d in devs:
            _sync(d)

    for _ in range(WARM_BLOCKS):
        pipe.feed_planar(planar)
    stats = []
    for _ in range(blocks):
        timers = _mesh_timers(pipe, sync=True)
        try:
            wait()
            t0 = time.perf_counter()
            frames = pipe.feed_planar(planar)
            wait()
            block_ms = (time.perf_counter() - t0) * 1e3
        finally:
            timers.restore()
        ms = timers.ms
        step = sum(ms["step"])
        parts = {k: sum(ms.get(k, []))
                 for k in ("l2", "gate", "drain", "tail")}
        stats.append({
            "channelize_ms": ms["channelize"], "detect_ms": ms["detect"],
            "step_ms": step,
            "gather_ms": step - sum(ms["channelize"]) - sum(ms["detect"]),
            **{f"{k}_ms": v for k, v in parts.items()},
            "host_ms": block_ms - step - sum(parts.values()),
            "block_ms": block_ms, "frames": len(frames)})
    wait()
    t0 = time.perf_counter()
    pipe.feed_planar(planar)
    wait()
    untraced = (time.perf_counter() - t0) * 1e3

    def annotated_block():
        timers = _mesh_timers(pipe, sync=False)
        try:
            return pipe.feed_planar(planar)
        finally:
            timers.restore()

    _, trace = traced(synced_block(annotated_block, devs), devs)
    frames = pipe.finish()
    return {"devices": [str(d) for d in pipe.mesh.devices],
            "blocks": stats, "untraced_block_ms": untraced, "trace": trace,
            "finish_frames": len(frames)}


def span_log_cost(freqs, fs, oversample, planar, device, blocks: int
                  ) -> dict:
    """What the span log costs the pipeline's own feed_planar calls: a
    pipeline fed ``planar`` (after a warm-up) with each method of its
    log (LOG_METHODS) timed on the thread that calls it, wall less the
    timer's own cost a call, over ``blocks`` blocks run two ways:
    ``steady``, as feed_planar runs them (a block's calls overlap the
    fetch of the one before, and a call that hands over the GIL or
    enters the driver may wait for the other thread), and ``drained``,
    each block drained in its own call, so that the threads do not
    overlap and each call costs its own work.  Gives for each way
    microseconds a block on the main thread and on the fetch thread,
    the calls a block on each, and microseconds a call of each method
    and span (``by_call``, e.g. ``close.detect``)."""
    n = 20000
    t = 0
    for _ in range(n):
        t0 = time.perf_counter_ns()
        t += time.perf_counter_ns() - t0
    timer_ns = t / n
    pipe = VDL2Pipeline(freqs, CENTER, fs, oversample, device=device)
    log = pipe.span_log
    for _ in range(WARM_BLOCKS):
        pipe.feed_planar(planar)
    main = threading.get_ident()
    out = {"timer_ns": timer_ns, "blocks": blocks}
    for way in ("steady", "drained"):
        pipe._drain_pending()
        spent: dict = {}
        calls: dict = {}

        def timed(method, fn):
            def call(*args):
                t0 = time.perf_counter_ns()
                ret = fn(*args)
                dt = time.perf_counter_ns() - t0 - timer_ns
                key = (threading.get_ident() == main,
                       method + ("." + args[1] if method in ("open", "close")
                                 else ""))
                spent[key] = spent.get(key, 0) + dt
                calls[key] = calls.get(key, 0) + 1
                return ret
            return call

        for name in LOG_METHODS:
            setattr(log, name, timed(name, getattr(log, name)))
        try:
            for _ in range(blocks):
                pipe.feed_planar(planar)
                if way == "drained":
                    pipe._drain_pending()
            pipe._drain_pending()
        finally:
            for name in LOG_METHODS:
                delattr(log, name)
        rec = {}
        for thread, is_main in (("main", True), ("fetch", False)):
            keys = [k for k in spent if k[0] == is_main]
            rec[f"{thread}_us_per_block"] = sum(
                spent[k] for k in keys) / 1e3 / blocks
            rec[f"{thread}_calls_per_block"] = sum(
                calls[k] for k in keys) / blocks
        rec["by_call"] = {k[1]: spent[k] / calls[k] / 1e3 for k in
                          sorted(spent, key=lambda k: -spent[k])}
        out[way] = rec
    pipe.finish()
    return out


def card_line() -> str | None:
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def run(device: str = "cuda", channels: int = 256, oversample: int = 80,
        blocks: int = 3, mesh_devices=None, block_dec: int = BLOCK_DEC
        ) -> list[dict]:
    """Both scenes; returns the JSON records the tool prints.  (Tests
    shorten the block with ``block_dec``.)"""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    freqs, fs, planar = make_scene(channels, oversample,
                                   block_dec=block_dec)
    block = torch.as_tensor(planar, device=dev)
    head = {"record": "setup", "device": str(dev),
            "kind": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "card": card_line() if dev.type == "cuda" else None,
            "channels": channels, "oversample": oversample,
            "block_samples": planar.shape[1], "fs": fs}
    single = profile_single(freqs, fs, oversample, block, dev, blocks)
    recs = [head]
    recs += [{"record": "block", "scene": "single", "block": i, **st}
             for i, st in enumerate(single.pop("blocks"))]
    recs.append({"record": "trace", "scene": "single", **single})
    mesh = profile_mesh(freqs, fs, oversample, block,
                        mesh_devices or [str(dev)] * 2, blocks)
    recs += [{"record": "block", "scene": "mesh", "block": i, **st}
             for i, st in enumerate(mesh.pop("blocks"))]
    recs.append({"record": "trace", "scene": "mesh", **mesh})
    recs.append({"record": "span_log", **span_log_cost(
        freqs, fs, oversample, block, dev,
        100 if dev.type == "cuda" else blocks)})
    return recs


def summary(recs: list[dict]) -> list[str]:
    """Human-readable lines of the records."""
    lines = []
    for r in recs:
        if r["record"] == "setup":
            lines.append(f"{r['kind']} ({r['card']}): {r['channels']} "
                         f"channels, oversample {r['oversample']}, blocks "
                         f"of {r['block_samples']} samples")
        elif r["record"] == "block":
            lines.append(_stage_line(f"{r['scene']} block {r['block']}", r))
        elif r["record"] == "span_log":
            lines.append("span log, us a block in its methods: " + "; ".join(
                f"{way} main {r[way]['main_us_per_block']:.2f} "
                f"({r[way]['main_calls_per_block']:.0f} calls), fetch "
                f"{r[way]['fetch_us_per_block']:.2f} "
                f"({r[way]['fetch_calls_per_block']:.0f})"
                for way in ("steady", "drained"))
                + f"; {r['blocks']} blocks")
        else:
            for key in ("feed_planar_block_ms", "untraced_block_ms"):
                if key in r:
                    lines.append(f"{r['scene']} {key[:-3]} {r[key]:.3f} ms")
            staged = "staged " if r["scene"] == "single" else ""
            lines += _trace_lines(f"{r['scene']} {staged}traced block",
                                  r["trace"])
            for i, st in enumerate(r.get("feed_planar_blocks", [])):
                lines.append(_stage_line(f"{r['scene']} feed_planar block "
                                         f"{i}", st))
            if "feed_planar_trace" in r:
                lines += _trace_lines(f"{r['scene']} feed_planar traced "
                                      f"block", r["feed_planar_trace"])
            for rec in r.get("events_vs_kernels") or []:
                lines.append(f"  block {rec['seq']} events against kernels: "
                             + ", ".join(
                                 f"{k} {_fmt(rec[k]['event_ms'])} / "
                                 f"{rec[k]['kernel_ms']:.3f} ms "
                                 f"(x{rec[k]['ops']}, first to last "
                                 f"{rec[k]['first_to_last_ms']:.3f})"
                                 for k in STEPS))
    return lines


def _stage_line(label: str, st: dict) -> str:
    return (f"{label}: " + ", ".join(f"{k[:-3]} {_fmt(v)}"
                                     for k, v in st.items()
                                     if k.endswith("_ms"))
            + (f"; fetch bytes {st['fetch_bytes']}"
               if st.get("fetch_bytes") else "")
            + f"; frames {st['frames']}")


def _trace_lines(label: str, t: dict) -> list[str]:
    lines = [f"{label}: wall {t['wall_ms']:.3f} ms, device busy "
             f"{_fmt(t['device_busy_ms'])} ms, idle share "
             f"{_fmt(t['idle_share'])}, kernels {t['kernel_launches']}, "
             f"copies {t['copies']}"]
    if t["kernels_by_stage"]:
        lines.append("  kernels by stage: " + ", ".join(
            f"{k} {v}" for k, v in t["kernels_by_stage"].items()))
    lines.append("  host ms by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in t["stage_ms"].items()))
    if t["idle_ms_by_stage"]:
        lines.append("  idle ms by stage: " + ", ".join(
            f"{k} {v:.3f}" for k, v in t["idle_ms_by_stage"].items()))
    for op in t["top_ops"] or []:
        lines.append(f"  {op['ms']:.3f} ms x{op['count']} "
                     f"{op['name'][:90]}")
    for g in t["idle_gaps"] or []:
        lines.append(f"  idle {g['ms']:.3f} ms at {g['at_ms']:.3f} "
                     f"in {g['stage']} / {g['host_op']}")
    return lines


def _fmt(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, list):
        return "[" + ", ".join(f"{x:.3f}" for x in v) + "]"
    return f"{v:.3f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--oversample", type=int, default=80)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--mesh-devices",
                    help="the mesh's two devices, comma-separated "
                    "(default: --device twice)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    recs = run(args.device, args.channels, args.oversample, args.blocks,
               args.mesh_devices.split(",") if args.mesh_devices else None)
    for r in recs:
        print(json.dumps(r), flush=True)
    for line in summary(recs):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
