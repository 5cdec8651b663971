"""Device trace of a stretch of the window, and its reduction.

``profiled`` runs a callable under ``torch.profiler`` inside a
``vdl2bench.stretch`` annotation and reduces the trace to: the
stretch's wall seconds, the union of device intervals inside it (busy
seconds), the device operations that took most time, the longest idle
gaps with the host operation that spans each, and each kernel's calls
and device seconds.

The interval arithmetic (``merge``, the busy union and the idle gaps)
is a frozen copy, at commit 3d62869, of
``dumpvdl2_tpu_torch/tools/profile_wideband_e2e.py::summarize_trace``
(with ``_merge`` and ``_innermost``).

``k1_bound`` is a frozen copy of ``chip_smoke.py::k1_bound`` and of the
card constants and operation counts it uses, at the same commit: the
least time of the sync metric on a (C, M) phase plane, counted from
the metric's definition (read the phases, write err and freq; the
least instructions per output), whatever computes it.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")
ANNOTATION = "vdl2bench.stretch"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
ISSUE_LANES_PER_SM = 128        # 4 schedulers x 32 lanes, 1 instruction/clock
LOOKBACK = 150                  # the metric's first output sample
K1_OPS_PER_OUTPUT = {
    "add": 13 + 15 + 15 + 15 + 16,
    "compare": 15,
    "copysign": 15,
    "conditional add": 15,
    "multiply": 2,
    "fma": 16 + 16 + 16,
}


def k1_bound(C: int, M: int, sms: int, clock_hz: float) -> dict:
    """Least time for the sync metric on a (C, M) input: the larger of
    its bytes over the memory rate and its least instructions over the
    card's issue rate."""
    outputs = C * max(M - LOOKBACK, 0)
    bytes_ms = 12 * C * M / HBM_BYTES_PER_S * 1e3
    ops = sum(K1_OPS_PER_OUTPUT.values()) * outputs
    ops_ms = ops / (ISSUE_LANES_PER_SM * sms * clock_hz) * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def innermost(events, t: float):
    """Name of the shortest event that spans time ``t``, or None."""
    hits = [e for e in events if e["ts"] <= t <= e["ts"] + e["dur"]]
    return min(hits, key=lambda e: e["dur"])["name"] if hits else None


def summarize(events: list) -> dict:
    """Reduce a chrome trace holding one stretch annotation."""
    xs = [e for e in events if isinstance(e, dict) and e.get("ph") == "X"
          and "dur" in e]
    span = max((e for e in xs if e.get("cat") == "user_annotation"
                and e["name"] == ANNOTATION), key=lambda e: e["dur"])
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    merged = merge([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                    for e in dev])
    busy = sum(e - s for s, e in merged)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(((e - s, s) for s, e in idle),
                  key=lambda g: (-g[0], g[1]))[:10]
    host = [e for e in xs if e.get("cat") in HOST_CATS
            and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    ops: dict = {}
    for e in dev:
        tot, n = ops.get(e["name"], (0.0, 0))
        ops[e["name"]] = (tot + e["dur"], n + 1)
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": span["dur"] / 1e6,
        "busy_s": busy / 1e6,
        "kernels": {k: {"calls": v[1], "seconds": v[0] / 1e6}
                    for k, v in ops.items()},
        "device_ops": [[k, v[0] / 1e6] for k, v in top[:10]],
        "idle_gaps": [[innermost(host, s + g / 2) or "none", g / 1e6]
                      for g, s in gaps],
    }


def profiled(fn) -> dict:
    """Run ``fn()`` under the profiler in one stretch annotation; the
    trace goes to a file under TMPDIR, which is removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(ANNOTATION):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events)
