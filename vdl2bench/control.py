"""Readings that set a cell's limits: the program's and the control's.

    python3 -m vdl2bench.control --workload <name> --seeds 1,2,3 \\
        --seconds <s>

For each seed, in one process: a whole run of the cell (set-up, window,
check), whose compared numbers are the program's readings; then the
control on the same scene: the reference put in the program's place and
computed in the nearest precision below the configuration's float32,
that is with TF32 matrix products in its channelizer.  The control's
frames (with the power, frequency error and noise floor it reads) and
its planes and detections on the run's kept blocks go through
``check.judge`` as the program's do, against the same float64
reference and the cell's limits.  One JSON line a seed; the exit code is
1 if the control came out correct on any seed (or the program not).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check
from . import run as harness


def control_verdict(run, win, shapes: list, ref: check.Reference) -> dict:
    """``check.judge`` of the control on ``run``'s scene: the reference's
    receiver with TF32 channelizer operands, its frames for the window's
    and its blocks for the kept ``shapes`` [(block, base, M, K)]."""
    ctrl = check.Reference(run, win, precision="tf32")
    emitted = check.emissions(ctrl)
    records = check.block_records(ctrl, shapes)
    del ctrl
    out = check.judge(run, dict(win, emitted=emitted), records, run.limits,
                      ref=ref)
    out.pop("reference")
    return out


def program_and_control(run, execute=harness.execute) -> tuple:
    """A whole run of the program (its result) and the control's verdict
    on the same scene and reference."""
    keep = {}
    orig = check.judge

    def judge(run_, win, records, limits):
        res = orig(run_, win, records, limits)
        keep.update(win=win, ref=res["reference"], shapes=[
            (r["block"], r["base"], r["phases"].shape[1],
             r["dets"].det_idx.shape[1]) for r in records])
        return res
    check.judge = judge
    try:
        result = execute(run)
    finally:
        check.judge = orig
    return result, control_verdict(run, keep["win"], keep["shapes"],
                                   keep["ref"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    bad = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell, seed, args.seconds, False,
                          torch.device("cuda", 0))
        result, ctrl = program_and_control(run)
        line = {"seed": seed,
                "program": {"correct": result["correct"],
                            **{k: v["value"]
                               for k, v in result["metrics"].items()},
                            **result["info"]["uncompared"],
                            **{k: v["value"]
                               for k, v in result["check"].items()}},
                "control": {"correct": ctrl["correct"],
                            **ctrl["numbers"]},
                "info": {k: result["info"][k] for k in
                         ("reference_lost", "matched_frames", "check_s")}
                | {"control_matched_frames":
                   ctrl["info"]["matched_frames"]}}
        print(json.dumps(line), flush=True)
        if ctrl["correct"] or not result["correct"]:
            bad.append(seed)
        del run, result, ctrl
        torch.cuda.empty_cache()
    if bad:
        print(f"error: seeds {bad}: the control came out correct or the "
              f"program not", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
