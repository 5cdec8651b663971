"""Stage profile of a wideband block of the port (a measurement aid).

Counterpart of the JAX package's ``tools/profile_wideband_e2e.py``, on
its scene: 256 channels at oversample 80 (8.4 Msps), noise from seed 7
and 24 bursts on stride-4 channels in one block of 52 428 decimated
samples (4 194 240 raw, the multiple of 80 nearest 2**22), fed again
and again.  Two scenes:

* ``single``: VDL2Pipeline with device L2 and device gating.  After
  three warm-up feeds each block runs the pipeline's own steps one
  after another (``_dispatch_block``: detection, L2, the gate and the
  carried state, as feed_planar dispatches them; ``coalesced_get`` of
  its tree; ``_process_verdicts``) and times
    dispatch  host ms to enqueue detect, L2 and the gate, no sync
    device    the torch.cuda.synchronize() wait after the dispatch
    fetch     coalesced_get, with its bytes a part (gout, cand, l2, map)
    host      _process_verdicts, split into
      frame_build  its calls of burst._result_from_batch (RS rows to
                   octets, HDLC unstuffing through the native library),
      host_rest    the rest (the loop over the channels' state mirrors
                   and slots, the counters, the DecodedFrames)
  and counts its frames and frame builds.  These staged blocks are
  serialized: the device waits through the fetch and the host step.  The staged
  blocks' frames, with finish()'s, must equal those of feed_planar on
  a fresh pipeline of as many blocks; that run's steady blocks give
  feed_planar's own ms a block (dispatch overlapped with the drain of
  a block two behind), and one more of its blocks is traced as it
  runs, after a lead-in block: the idle share of the receive path.
* ``mesh``: the same block through MeshPipeline at mesh (1, 2) on
  ``--mesh-devices`` (the device twice by default).  Synchronized
  blocks give each shard's channelizer and detection ms, the rest of
  the sharded step as ``gather`` (the block's copies to the shards, the
  halos, the gather, the carried state), the L2 launch, the gate, the
  drain, the raw tail's upkeep and the rest of feed_planar as ``host``
  (the block's copy to the host, its concatenations); an
  unsynchronized block gives its wall.

For each scene one more block runs under torch.profiler (and, for
``single``, the feed_planar block above and a staged block whose
detect, L2 and gate steps each synchronize before and after, so that
each step's kernel launches can be counted); its trace is
reduced to the block's wall ms, the union of the device's kernel, copy
and set intervals, the device idle share 1 - union / wall, the kernel
launches (in all and by stage annotation), the 10 device ops with the most time, the host ms and the
device's idle ms inside each stage annotation, and the 5 longest idle
gaps with the stage and host op running in each.  The profiler slows
the host, so the traced block's wall stands beside an untraced one's.
On the CPU the fields that need the card are null.

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
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from dumpvdl2_tpu_torch.constants import SPS, SYMBOL_RATE  # noqa: E402
from dumpvdl2_tpu_torch.core import nf_gate, pipeline  # noqa: E402
from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline  # noqa: E402
from dumpvdl2_tpu_torch.dsp.frontend import to_planar  # noqa: E402
from dumpvdl2_tpu_torch.parallel import sharded  # noqa: E402
from dumpvdl2_tpu_torch.sim import synthesize_iq_raw  # noqa: E402
from dumpvdl2_tpu_torch.utils.devices import resolve_device  # noqa: E402
from dumpvdl2_tpu_torch.utils.fetch import coalesced_get  # noqa: E402

CENTER = 136975000
BLOCK_DEC = (1 << 22) // 80          # decimated samples a block
FETCH_PARTS = ("gout", "cand", "l2", "map")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
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


def _nbytes(tree) -> int:
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_nbytes(t) for t in tree.values())
    return int(getattr(tree, "nbytes", 0))


def staged_block(pipe: VDL2Pipeline, planar: torch.Tensor):
    """One block through the device-gated pipeline's own steps, one
    after another: ``_dispatch_block`` (detection, L2, the gate, the
    carried state), the wait, ``coalesced_get`` of its tree and
    ``_process_verdicts``.  Returns (stage ms and fetch bytes, frames)."""
    t0 = time.perf_counter()
    with record_function("dispatch"):
        tree, base, _ = pipe._dispatch_block(planar)
    t1 = time.perf_counter()
    with record_function("device"):
        _sync(pipe.device)
    t2 = time.perf_counter()
    with record_function("fetch"):
        fetched = coalesced_get(tree)
    t3 = time.perf_counter()
    # a bare clock around each frame build: a profiler annotation would
    # add its own cost to each of the ~220 calls a wideband block
    build = []
    orig = pipeline._result_from_batch

    def timed_build(*args):
        tb = time.perf_counter()
        try:
            return orig(*args)
        finally:
            build.append((time.perf_counter() - tb) * 1e3)

    pipeline._result_from_batch = timed_build
    try:
        with record_function("host"):
            frames = pipe._process_verdicts(*fetched, base)
        t4 = time.perf_counter()
    finally:
        pipeline._result_from_batch = orig
    host_ms = (t4 - t3) * 1e3
    return {"dispatch_ms": (t1 - t0) * 1e3, "device_ms": (t2 - t1) * 1e3,
            "fetch_ms": (t3 - t2) * 1e3, "host_ms": host_ms,
            "frame_build_ms": sum(build),
            "host_rest_ms": host_ms - sum(build),
            "block_ms": (t4 - t0) * 1e3,
            "fetch_bytes": {p: _nbytes(a)
                            for p, a in zip(FETCH_PARTS, fetched)},
            "frames": len(frames), "frame_builds": len(build)}, frames


def traced(fn, devices):
    """Run ``fn()`` under torch.profiler; ``fn`` marks one ``block``
    annotation.  Returns its result and the trace's summary
    (summarize_trace)."""
    acts = [ProfilerActivity.CPU]
    cuda = any(d.type == "cuda" for d in devices)
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
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


def summarize_trace(events: list, device_trace: bool) -> dict:
    """Reduce a chrome trace holding one ``block`` annotation: the
    block's wall ms; with ``device_trace`` also the union of device
    intervals inside it, the idle share, the kernel launches and copies,
    the top 10 device ops by total time, the device's idle ms inside
    each stage annotation (nested ones count in each), and the 5
    longest idle gaps (the stage annotation and innermost host op
    spanning each gap's middle), and the kernels whose middle lies in
    each stage annotation (the stage's own launches where its
    annotations synchronize the device before and after).  Without a
    device trace those fields are None.  ``stage_ms`` is the host wall of each stage annotation
    inside the block, summed over its calls."""
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
           "kernels_by_stage": None,
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
    many blocks, ``blocks`` of them timed and a steady one traced;
    raises when the staged frames are not feed_planar's."""
    pipe = VDL2Pipeline(freqs, CENTER, fs, oversample, device=device)
    if not (pipe.use_device_l2 and pipe.use_device_gate):
        raise RuntimeError("the staged profile needs device L2 and device "
                           "gating (DUMPVDL2_TPU_L2 / DUMPVDL2_TPU_GATE)")
    frames = []
    # as many blocks in all as feed_planar's run below: the two traced
    # staged blocks stand for its lead-in and traced blocks
    for _ in range(WARM_BLOCKS):
        frames += pipe.feed_planar(planar)
    frames += pipe._drain_pending()
    stats = []
    for _ in range(blocks):
        st, fr = staged_block(pipe, planar)
        stats.append(st)
        frames += fr
    timers = _single_timers(pipe, feed=False)
    try:
        (st, fr), trace = traced(synced_block(
            lambda: staged_block(pipe, planar), [device]), [device])
    finally:
        timers.restore()
    frames += fr
    # a staged block whose detect, L2 and gate steps each wait for the
    # device before and after: each step's kernels lie in its annotation
    timers = _single_timers(pipe, feed=False, sync=True)
    try:
        (_, fr), stage_trace = traced(synced_block(
            lambda: staged_block(pipe, planar), [device]), [device])
    finally:
        timers.restore()
    frames += fr + pipe.finish()

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
        feed_timers = _single_timers(ref, feed=True)
        try:
            with record_function("block"):
                out += ref.feed_planar(planar)
        finally:
            feed_timers.restore()
        return out

    fr, feed_trace = traced(steady_block, [device])
    want += fr + ref.finish()
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
            "synced_stage_trace": stage_trace,
            "feed_planar_block_ms": feed_ms,
            "feed_planar_trace": feed_trace,
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


def _single_timers(pipe: VDL2Pipeline, feed: bool,
                   sync: bool = False) -> _Timers:
    """Annotate the single-device pipeline's steps for the profiler
    (with ``sync`` each waits for the device before and after):
    detection, L2 and the gate; with ``feed`` also feed_planar's
    dispatch, fetch (on the fetch thread), drain, host and frame-building
    steps."""
    t = _Timers([pipe.device], sync=sync)
    t.wrap(pipeline, "process_block_detect", "detect")
    t.wrap(pipeline, "l2_sliced", "l2")
    t.wrap(pipe, "_dispatch_gate", "gate")
    if feed:
        t.wrap(pipe, "_dispatch_block", "dispatch")
        t.wrap(pipeline, "coalesced_get", "fetch")
        t.wrap(pipe, "_drain_oldest", "drain")
        t.wrap(pipe, "_process_verdicts", "host")
        t.wrap(pipeline, "_result_from_batch", "frame_build")
    return t


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
            keys = [k for k in r if k.endswith("_ms")]
            lines.append(f"{r['scene']} block {r['block']}: " + ", ".join(
                f"{k[:-3]} {_fmt(r[k])}" for k in keys)
                + (f"; fetch bytes {r['fetch_bytes']}"
                   if "fetch_bytes" in r else "")
                + f"; frames {r['frames']}"
                + (f", frame builds {r['frame_builds']}"
                   if "frame_builds" in r else ""))
        else:
            for key in ("feed_planar_block_ms", "untraced_block_ms"):
                if key in r:
                    lines.append(f"{r['scene']} {key[:-3]} {r[key]:.3f} ms")
            staged = "staged " if r["scene"] == "single" else ""
            lines += _trace_lines(f"{r['scene']} {staged}traced block",
                                  r["trace"])
            if "synced_stage_trace" in r:
                lines += _trace_lines(f"{r['scene']} staged block, steps "
                                      f"synchronized", r["synced_stage_trace"])
            if "feed_planar_trace" in r:
                lines += _trace_lines(f"{r['scene']} feed_planar traced "
                                      f"block", r["feed_planar_trace"])
    return lines


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
