"""The port's stage profile of a wideband block
(dumpvdl2_tpu_torch/tools/profile_wideband_e2e.py), on the CPU.

A shortened scene (8 channels at oversample 20, blocks of 15 000
decimated samples, one staged block): the staged blocks, feed_planar
calls with the pipeline's step_ms on, must decode exactly the frames
that feed_planar decodes on a fresh pipeline of the same blocks (the
tool raises otherwise); every stage comes from the pipeline's span log,
the fetch from its fetch thread; the traced blocks carry the pipeline's
``vdl2.*`` spans; the trace fields and device times that need the card
are null; the mesh (1, 2) scene runs on the CPU twice; the span log's
cost is measured.  The trace reduction is checked on a made-up trace.
"""
import importlib.util
import os

import pytest
from _torch_port import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "dumpvdl2_tpu_torch", "tools",
                    "profile_wideband_e2e.py")
CUDA_ONLY = ("device_busy_ms", "idle_share", "kernel_launches", "copies",
             "top_ops", "idle_ms_by_stage", "idle_gaps", "kernel_ms_by_span")


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("profile_wideband", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def records(tool):
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        recs = tool.run("cpu", channels=8, oversample=20, blocks=1,
                        block_dec=15000)
    finally:
        torch.set_num_threads(n)
    return {(r["record"], r.get("scene"), r.get("block")): r for r in recs}


def test_staged_frames_equal_feed_planar(records):
    single = records[("trace", "single", None)]
    assert single["frames_equal_feed_planar"] is True
    assert single["frames"] >= 2 and single["max_float_diff"] <= 1e-4
    assert single["feed_planar_block_ms"] > 0
    assert records[("block", "single", 0)]["frames"] >= 1


def test_feed_planar_trace_has_the_pipeline_stages(records):
    """Every feed_planar call dispatches; whether it also drains the
    block before it depends on that block's fetch being done, so the
    drain's spans are checked only where they ran."""
    t = records[("trace", "single", None)]["feed_planar_trace"]
    assert t["wall_ms"] > 0
    for key in ("feed_planar", "dispatch", "detect", "l2", "gate"):
        assert t["stage_ms"]["vdl2." + key] > 0, key
    assert t["stage_ms"]["vdl2.dispatch"] >= t["stage_ms"]["vdl2.detect"]
    assert set(t["stage_ms"]) <= {
        "vdl2." + k for k in ("feed_planar", "dispatch", "detect", "l2",
                              "gate", "fetch", "drain", "drain.wait",
                              "drain.verdicts")}
    assert all(v > 0 for v in t["stage_ms"].values())


@pytest.mark.parametrize("rec", [("block", "single", 0),
                                 ("trace", "single", None)])
def test_single_stages_and_fetch_bytes(records, rec):
    """A staged block's stages from the span log: each step holds its
    device work, the fetch ran on the fetch thread, the drain waited
    and built the frames in the same call; the bytes the fetch copied,
    by part."""
    r = records[rec]
    st = r.get("traced_block", r)
    for key in ("feed_planar_ms", "dispatch_ms", "detect_ms", "l2_ms",
                "gate_ms", "fetch_host_ms", "fetch_ms", "drain_ms",
                "drain_wait_ms", "drain_verdicts_ms"):
        assert st[key] > 0, key
    assert st["dispatch_ms"] >= st["detect_ms"] + st["l2_ms"] + st["gate_ms"]
    assert st["feed_planar_ms"] >= st["dispatch_ms"] + st["fetch_host_ms"]
    assert st["fetch_host_ms"] >= st["drain_ms"] >= \
        st["drain_wait_ms"] + st["drain_verdicts_ms"]
    for key in ("detect", "l2", "gate", "fetch_lag"):
        assert st[f"{key}_dev_ms"] is None, key
    assert st["frames"] >= 1
    assert set(st["fetch_bytes"]) == {"gout", "cand", "l2", "map"}
    assert all(v > 0 for v in st["fetch_bytes"].values()), st["fetch_bytes"]


def test_feed_planar_blocks_have_their_spans(records):
    """The timed feed_planar blocks, unsynchronized: each dispatched,
    was fetched on the fetch thread and drained in a later call."""
    blocks = records[("trace", "single", None)]["feed_planar_blocks"]
    assert len(blocks) == 1
    for st in blocks:
        for key in ("feed_planar_ms", "dispatch_ms", "fetch_ms",
                    "drain_ms", "drain_wait_ms", "drain_verdicts_ms"):
            assert st[key] > 0, key
        assert st["fetch_host_ms"] is None
        assert st["frames"] is not None


def test_span_log_cost(records):
    """The log's cost inside its methods on the pipeline's feed_planar,
    both ways: a record, eight spans and four events a block on the
    main thread, the fetch's span and report on the fetch thread."""
    r = records[("span_log", None, None)]
    assert r["blocks"] == 1 and r["timer_ns"] > 0
    for way in ("steady", "drained"):
        w = r[way]
        assert (w["main_calls_per_block"], w["fetch_calls_per_block"]) == \
            (17, 3), way
        assert w["main_us_per_block"] > 0 and w["fetch_us_per_block"] > 0
        assert {"new_block", "open.detect", "close.gate", "open.fetch",
                "fetched"} <= set(w["by_call"])


@pytest.mark.parametrize("scene,key", [("single", "trace"),
                                       ("single", "feed_planar_trace"),
                                       ("mesh", "trace")])
def test_trace_fields_on_cpu(records, scene, key):
    t = records[("trace", scene, None)][key]
    assert t["wall_ms"] > 0
    for key in CUDA_ONLY:
        assert t[key] is None, key
    assert records[("setup", None, None)]["card"] is None


def test_mesh_scene_runs_on_two_cpu_devices(records):
    r = records[("trace", "mesh", None)]
    assert r["devices"] == ["cpu", "cpu"]
    assert r["untraced_block_ms"] > 0
    b = records[("block", "mesh", 0)]
    assert len(b["channelize_ms"]) == len(b["detect_ms"]) == 2
    for key in ("step_ms", "gather_ms", "l2_ms", "gate_ms", "drain_ms",
                "tail_ms", "block_ms"):
        assert b[key] > 0, key
    assert b["block_ms"] >= b["step_ms"] >= sum(b["channelize_ms"])


def test_summary_lines(tool, records):
    lines = tool.summary(list(records.values()))
    assert any(ln.startswith("single block 0: feed_planar") for ln in lines)
    assert any(ln.startswith("single feed_planar block 0: feed_planar")
               for ln in lines)
    assert any(ln.startswith("span log, us a block in its methods: ")
               for ln in lines)
    for label in ("single staged traced block", "single feed_planar "
                  "traced block", "mesh traced block"):
        assert any(ln.startswith(label + ": wall") for ln in lines), label


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize_trace(tool):
    """Device intervals merge into their union inside the block; the
    gaps between them are ranked and named by the innermost stage and
    host op spanning their middle."""
    events = [
        _x("block", "user_annotation", 1000.0, 1000.0),
        _x("dispatch", "user_annotation", 1000.0, 500.0),
        _x("host", "user_annotation", 1700.0, 300.0),
        _x("aten::matmul", "cpu_op", 1000.0, 300.0),
        _x("aten::mm", "cpu_op", 1050.0, 200.0),
        _x("cudaLaunchKernel", "cuda_runtime", 1500.0, 10.0),
        _x("gemm", "kernel", 1100.0, 200.0),
        _x("gemm", "kernel", 1250.0, 100.0),        # overlaps the first
        _x("Memcpy DtoH", "gpu_memcpy", 1600.0, 50.0),
        _x("k1", "kernel", 1900.0, 40.0),
        _x("early", "kernel", 500.0, 50.0),         # before the block
        _x("lead", "user_annotation", 400.0, 300.0),  # so is this stage
        {"ph": "M", "name": "process_name"},
    ]
    cpu = tool.summarize_trace(events, device_trace=False)
    assert cpu["wall_ms"] == 1.0
    assert cpu["stage_ms"] == pytest.approx({"dispatch": 0.5, "host": 0.3})
    assert all(cpu[k] is None for k in CUDA_ONLY)

    t = tool.summarize_trace(events, device_trace=True)
    # union: [1100, 1350] + [1600, 1650] + [1900, 1940] = 340 us
    assert t["device_busy_ms"] == pytest.approx(0.34)
    assert t["idle_share"] == pytest.approx(0.66)
    assert (t["kernel_launches"], t["copies"]) == (3, 1)
    assert [(o["name"], o["count"]) for o in t["top_ops"]] == \
        [("gemm", 2), ("Memcpy DtoH", 1), ("k1", 1)]
    assert t["top_ops"][0]["ms"] == pytest.approx(0.3)
    gaps = [(g["ms"], g["at_ms"], g["stage"], g["host_op"])
            for g in t["idle_gaps"]]
    assert [g[:2] for g in gaps] == pytest.approx(
        [(0.25, 0.35), (0.25, 0.65), (0.1, 0.0), (0.06, 0.94)])
    assert gaps[0][2:] == ("dispatch", None)    # middle at 1475
    assert gaps[1][2:] == ("host", None)        # middle at 1775
    assert gaps[2][2:] == ("dispatch", "aten::mm")
    assert t["idle_ms_by_stage"] == pytest.approx(
        {"dispatch": 0.25, "host": 0.26})


def test_kernel_ms_by_span(tool):
    """Device work counts in the step annotation whose thread launched
    it inside the annotation, matched by correlation id; the records'
    event intervals stand beside it, the newest records last."""
    from types import SimpleNamespace

    def x(name, cat, ts, dur, tid=1, corr=None):
        e = _x(name, cat, ts, dur)
        e["tid"] = tid
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    events = [
        x("vdl2.detect", "user_annotation", 0.0, 100.0),
        x("cudaLaunchKernel", "cuda_runtime", 10.0, 5.0, corr=5),
        x("gemm", "kernel", 200.0, 30.0, tid=7, corr=5),
        x("cuLaunchKernel", "cuda_driver", 40.0, 5.0, corr=9),
        x("k1", "kernel", 240.0, 20.0, tid=7, corr=9),
        x("cudaMemcpyAsync", "cuda_runtime", 20.0, 5.0, tid=2, corr=6),
        x("Memcpy DtoH", "gpu_memcpy", 231.0, 4.0, tid=7, corr=6),
        x("cudaLaunchKernel", "cuda_runtime", 150.0, 5.0, corr=7),
        x("late", "kernel", 300.0, 10.0, tid=7, corr=7),
        x("vdl2.l2", "user_annotation", 100.0, 20.0),
        x("cudaLaunchKernel", "cuda_runtime", 110.0, 5.0, corr=8),
        x("l2_front", "kernel", 320.0, 5.0, tid=7, corr=8),
        x("vdl2.gate", "user_annotation", 120.0, 10.0),
    ]
    by = tool.kernel_ms_by_span(events)
    assert by["detect"] == [pytest.approx(
        {"kernel_ms": 0.05, "ops": 2, "first_to_last_ms": 0.06})]
    assert by["l2"] == [pytest.approx(
        {"kernel_ms": 0.005, "ops": 1, "first_to_last_ms": 0.005})]
    assert by["gate"] == [{"kernel_ms": 0.0, "ops": 0,
                           "first_to_last_ms": 0.0}]
    blocks = [SimpleNamespace(seq=s, detect_dev=0.1 * s, l2_dev=0.01,
                              gate_dev=0.002) for s in (3, 4)]
    got = tool.events_vs_kernels(blocks, by)
    assert [r["seq"] for r in got] == [4]
    assert got[0]["detect"]["event_ms"] == pytest.approx(0.4)
    assert got[0]["detect"]["kernel_ms"] == pytest.approx(0.05)
