"""A whole run on the CPU at a tiny size (the harness's look for a chip
skipped): sound runs come out correct; the control and each fault the
cells can have come out not correct."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vdl2bench import control
from vdl2bench import run as harness
from vdl2bench.traffic import synth

ROOT = Path(__file__).resolve().parents[2]


def execute(run):
    return harness.execute(run, device_info=False)


@pytest.mark.parametrize("kind,seed", [("closed", 31), ("paced", 32)])
def test_sound_run_is_correct(kind, seed, make_run):
    r = make_run(kind, seed)
    res = execute(r)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["info"]["matched_frames"] > 0
    assert list(res)[-1] == "check"
    assert set(res["check"]) == set(r.limits)
    name = "realtime_factor" if kind == "closed" else "latency_p95_ms"
    assert res["metrics"][name]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0


def test_traced_run_reads_the_step_timers(make_run):
    r = make_run("closed", 33, blocks=34)
    r.trace, r.sms, r.clock_hz = True, 132, 1.98e9
    res = execute(r)
    assert res["correct"], res["check"]
    m = res["metrics"]
    for name in ("detect_ms_per_block", "l2_ms_per_block",
                 "gate_ms_per_block", "host_ms_per_block",
                 "stack_ms_per_frame"):
        assert m[name]["value"] > 0
    # no device on the CPU: no trace-derived reading is printed
    assert "k1_roofline" not in m and "device_idle_share" not in m


@pytest.mark.parametrize("kind,seed", [("closed", 34), ("paced", 36)])
def test_control_is_not_correct(kind, seed, make_run):
    """The reference in the program's place with TF32 operands in its
    channelizer, through the same comparison: not correct, while the
    program's run of the same scene is."""
    res, ctrl = control.program_and_control(make_run(kind, seed), execute)
    assert res["correct"], res["check"]
    assert not ctrl["correct"], ctrl["numbers"]
    assert ctrl["info"]["matched_frames"] > 0
    assert set(ctrl["numbers"]) == set(res["info"]["uncompared"]) \
        | set(res["check"])


def state_unchanged(monkeypatch):
    from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
    orig = VDL2Pipeline._dispatch_block

    def step(self, iq):
        saved = (self.hist, self.carry, self.n0, self.hist_base)
        out = orig(self, iq)
        self.hist, self.carry, self.n0, self.hist_base = saved
        return out
    monkeypatch.setattr(VDL2Pipeline, "_dispatch_block", step)


def half_left_out(monkeypatch):
    from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
    orig = VDL2Pipeline._process_verdicts

    def verdicts(self, *args):
        """the frames of the upper half of the channels left out"""
        keep = set(self.freqs[:len(self.freqs) // 2])
        return [f for f in orig(self, *args) if f.metadata.freq in keep]
    monkeypatch.setattr(VDL2Pipeline, "_process_verdicts", verdicts)


def answer_altered(monkeypatch):
    from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
    orig = VDL2Pipeline._emit

    def emit(self, out, *args):
        n = len(out)
        orig(self, out, *args)
        for f in out[n:]:
            body = bytearray(bytes(f.frame)[:-2])
            body[-1] ^= 0x01
            f.frame = np.frombuffer(synth.frame_with_fcs(bytes(body)),
                                    np.uint8)
    monkeypatch.setattr(VDL2Pipeline, "_emit", emit)


@pytest.mark.parametrize("kind", ["closed", "paced"])
@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered])
def test_fault_is_not_correct(fault, kind, monkeypatch, make_run):
    fault(monkeypatch)
    res = execute(make_run(kind, 35))
    assert not res["correct"]


@pytest.mark.cuda
def test_one_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "vdl2bench.run", "--workload", "sdr8.live",
         "--seed", "7", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "vdl2bench.run", "--workload", "sdr8.live",
         "--seed", "7", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
