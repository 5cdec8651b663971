"""The metric arithmetic: the union of device intervals, percentiles
over every frame, due times, the readers, and the frozen K1 bound."""
from __future__ import annotations

import types
from pathlib import Path

import numpy as np
import pytest

from vdl2bench import run as harness
from vdl2bench import trace as tracing
from vdl2bench.metrics import _common

ROOT = Path(__file__).resolve().parents[2]


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_union_of_device_intervals_and_gaps():
    events = [
        ev(tracing.ANNOTATION, "user_annotation", 0, 100),
        ev("k1", "kernel", 10, 20),          # 10..30
        ev("k2", "kernel", 25, 15),          # overlaps: 10..40
        ev("copy", "gpu_memcpy", 60, 10),    # 60..70
        ev("k3", "kernel", 95, 20),          # clipped at 100
        ev("late", "kernel", 200, 5),        # outside the stretch
        ev("host_wait", "cpu_op", 40, 20),   # spans the 40..60 gap
    ]
    s = tracing.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    gaps = dict((round(g * 1e6), n) for n, g in s["idle_gaps"])
    assert set(gaps) == {10, 20, 25}
    assert gaps[20] == "host_wait"
    assert s["kernels"]["k1"] == {"calls": 1, "seconds": 20e-6}
    assert [n for n, _ in s["device_ops"]][:2] == ["k1", "k3"]


def test_merge():
    assert tracing.merge([(5, 7), (1, 3), (2, 4), (7, 8)]) == [[1, 4],
                                                               [5, 8]]


def test_percentile_over_all_values():
    v = np.arange(1, 101, dtype=float)
    assert _common.percentile(v, 95) == pytest.approx(np.percentile(v, 95))
    assert _common.percentile([], 95) is None


def test_due_time_counts_from_the_stream_start():
    win = {"start": 100.0, "period": 0.5, "block": 1000}
    assert _common.due_time(win, 0) == 100.0
    assert _common.due_time(win, 2500) == pytest.approx(101.25)


def fake(scene_end, emitted, **win):
    idx = {b"f%d" % i: i for i in range(len(scene_end))}
    run = types.SimpleNamespace(scene=types.SimpleNamespace(
        end=np.asarray(scene_end), payload_index=lambda: idx, fs=1000))
    frames = [(c, t, types.SimpleNamespace(frame=f)) for c, t, f in emitted]
    return run, dict(win, emitted=frames)


def test_latency_reader_takes_every_known_frame():
    run, win = fake([999, 1999], [(1, 101.0, b"f0"), (2, 101.6, b"f1"),
                                  (2, 101.7, b"f1"), (2, 101.8, b"junk")],
                    start=100.0, period=1.0, block=1000)
    lat = harness.read_metric("latency_p95_ms", run, win, None)
    # due: 100.999 and 101.999; frames at 101.0, 101.6, 101.7
    want = np.percentile([1.0, -399.0, -299.0], 95)
    assert lat == pytest.approx(want, abs=1e-6)


def test_emit_wait_reader():
    run, win = fake([999, 2500], [(1, 100.7, b"f0"), (3, 103.2, b"f1")],
                    start=100.0, period=1.0, block=1000,
                    released=[100.5, 101.5, 102.5, 103.5])
    got = harness.read_metric("emit_wait_ms_p50.live", run, win, None)
    assert got == pytest.approx(np.median([200.0, 700.0]))


def test_rate_reader():
    run = types.SimpleNamespace(scene=types.SimpleNamespace(fs=1000))
    win = {"raw_fed": 20000, "t0": 5.0, "t1": 6.0}
    assert harness.read_metric("realtime_factor", run, win, None) == 20.0


def test_every_metric_has_a_reader():
    import json
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (ROOT / "vdl2bench/metrics" / f"{m['name']}.py").exists()


def test_frozen_k1_bound_equals_the_smoke_script():
    text = (ROOT / "chip_smoke.py").read_text()
    assert "def k1_bound" in text
    ns = {}
    start = text.index("HBM_BYTES_PER_S")
    block = text[start:text.index("# Ragged K1 shapes")]
    exec(block, ns)
    assert ns["K1_OPS_PER_OUTPUT"] == tracing.K1_OPS_PER_OUTPUT
    assert ns["HBM_BYTES_PER_S"] == tracing.HBM_BYTES_PER_S
    assert ns["ISSUE_LANES_PER_SM"] == tracing.ISSUE_LANES_PER_SM
    b = tracing.k1_bound(256, 108844, 132, 1.98e9)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(0.1406, rel=0.01)
