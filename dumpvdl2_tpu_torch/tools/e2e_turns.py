"""Single-device end-to-end times of two checkouts of the port, in turns.

Each turn is a fresh process that imports one checkout's package (the
checkout goes first on ``sys.path``) and times on the card, with the
helpers of this checkout's ``chip_smoke.py``:

* the 3-burst correctness vector (8 channels, 2.1 Msps) through
  ``VDL2Pipeline.feed(..., eof=True)``, device-gated, ``--vector-reps``
  times;
* the six-block 256-channel 8.4 Msps wideband scene through
  ``feed_planar`` and ``finish()``, gated and host-gated in alternation,
  ``--wide-reps`` times each.

Every run must decode all of its payloads.  Turns run in the order
A B B A A B B A ..., so that a drift of the card or of the host falls on
both checkouts alike.  Run from the root of a checkout, on one GPU:

    python3 dumpvdl2_tpu_torch/tools/e2e_turns.py \\
        --roots PARENT_DIR,. --pairs 4 --out chiprun_out/turns.json

Prints one line a turn and, for each checkout and metric, the median
realtime factor over all its runs.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
METRICS = ("vector", "gated", "host_gated")


def child(root: str, vector_reps: int, wide_reps: int) -> dict:
    """One turn: ``root``'s package timed with this checkout's helpers."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import dumpvdl2_tpu_torch
    from dumpvdl2_tpu_torch import kernels
    from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
    from dumpvdl2_tpu_torch.sim import frame_with_fcs
    pkg = os.path.dirname(os.path.abspath(dumpvdl2_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    kernels.build_all()
    sig, fs, os_, freqs, vector = cs.vector_signal()
    want_vec = {(frame_with_fcs(p), int(cs.CENTER + off))
                for _, p, _, off in vector}
    wfreqs, wfs, wos, wsig, want, _ = cs.wideband_scene()
    n_wide = cs.WIDEBAND_BLOCK * cs.WIDEBAND_BLOCKS

    def vector_once() -> float:
        pipe = VDL2Pipeline(freqs, int(cs.CENTER), fs, os_, device="cuda")
        t0 = time.perf_counter()
        frames = pipe.feed(sig, eof=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not want_vec <= {(bytes(f.frame), f.metadata.freq)
                            for f in frames}:
            raise AssertionError("vector: a payload is missing")
        return sig.size / dt / fs

    def wide_once(gate: bool) -> float:
        t0 = time.perf_counter()
        frames = cs.run_wideband(wfreqs, wfs, wos, wsig, device_gate=gate)
        dt = time.perf_counter() - t0
        got = {(bytes(f.frame), f.metadata.freq) for f in frames}
        if any(w not in got for w in want):
            raise AssertionError(f"wideband (gated {gate}): a payload is "
                                 f"missing")
        return n_wide / dt / wfs

    # first use: library handles, the allocator's pools
    vector_once()
    wide_once(True)
    wide_once(False)
    res = {m: [] for m in METRICS}
    for _ in range(vector_reps):
        res["vector"].append(vector_once())
    for _ in range(wide_reps):
        res["gated"].append(wide_once(True))
        res["host_gated"].append(wide_once(False))
    return {"root": root, "card": cs.card_line(), **res}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", help="two checkouts, comma-separated (A,B)")
    ap.add_argument("--pairs", type=int, default=4,
                    help="A B or B A pairs of turns")
    ap.add_argument("--vector-reps", type=int, default=20)
    ap.add_argument("--wide-reps", type=int, default=3)
    ap.add_argument("--out", help="write every run's numbers here (JSON)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.vector_reps,
                               args.wide_reps)), flush=True)
        return 0
    if not args.roots or args.roots.count(",") != 1:
        ap.error("--roots takes two checkouts, A,B")

    a, b = args.roots.split(",")
    order = []
    for p in range(args.pairs):
        order += [a, b] if p % 2 == 0 else [b, a]
    turns = []
    for i, root in enumerate(order):
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--vector-reps", str(args.vector_reps),
             "--wide-reps", str(args.wide_reps)],
            capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        t = json.loads(r.stdout.strip().splitlines()[-1])
        turns.append(t)
        print(f"turn {i} {root} ({t['card']}): " + "; ".join(
            f"{m} " + ", ".join(f"{v:.3f}" for v in t[m]) for m in METRICS),
            flush=True)
    summary = {}
    for root in (a, b):
        summary[root] = {m: statistics.median(
            v for t in turns if t["root"] == root for v in t[m])
            for m in METRICS}
        print(f"median realtime factor, {root}: " + ", ".join(
            f"{m} {v:.3f}" for m, v in summary[root].items()), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"order": order, "turns": turns, "median": summary},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
