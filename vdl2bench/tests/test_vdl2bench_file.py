"""The file cell's parts on the CPU: the recorder's quantizer, the
capture reader against the pool the check is given, a tiny file cell
through the port's file path judged correct (and a fault in the file
path not), and the input layer's readers, which give nothing without
their spans."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vdl2bench import run as harness
from vdl2bench.loops import file as file_loop
from vdl2bench.reference import capture

ROOT = Path(__file__).resolve().parents[2]
READERS = ("read_ms_per_block.file", "ingest_ms_per_block.file",
           "ingest_dev_ms_per_block.file", "ingest_roofline.file")


def tiny_file_run(seed: int, blocks: int = 12, trace: bool = False):
    """The file cell shrunk as conftest.tiny_cell shrinks the closed
    loop: 8 channels at oversample 20, a 4-block capture."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "vdl2bench/configs/wb256_os80_cs16.json")
                     .read_text())
    cfg.update(channels=8, oversample=20, block_samples=20 * 13107,
               read_bytes=4 * 20 * 13107)
    mix = json.loads((ROOT / "vdl2bench/traffic/file.json").read_text())
    mix.update(pool_blocks=4, channels={"stride": 2, "active": 3},
               noise_rms=0.005)
    name = "wb256cs16.file"
    cell = {"spec": spec,
            "cell": {"name": name, "config": "tiny", "traffic": "tiny",
                     "chips": 1},
            "config": {}, "cfg": cfg, "mix": mix,
            "limits": json.loads((ROOT / f"vdl2bench/limits/{name}.json")
                                 .read_text())}
    r = harness.Run(cell, seed, 1e9, trace, torch.device("cpu"))
    r.max_blocks = blocks
    return r


def test_quantizer_rounds_half_to_even_and_saturates():
    lsb = 1.0 / 32768
    x = torch.tensor([[0.5 * lsb, 1.5 * lsb, -0.5 * lsb, -2.5 * lsb, 1.0,
                       2.0, -1.0, -3.0, 0.3]], dtype=torch.float32)
    sig = torch.cat([x, -x])
    got = file_loop.quantize(sig, 1.0).reshape(-1, 2)
    want = np.array([0, 2, 0, -2, 32767, 32767, -32768, -32768, 9830])
    assert got.dtype == np.dtype("<i2")
    assert np.array_equal(got[:, 0], want)
    assert np.array_equal(got[:, 1], [0, -2, 0, 2, -32768, -32768, 32767,
                                      32767, -9830])


def test_capture_read_back_is_the_pool(tmp_path):
    r = tiny_file_run(41)
    file_loop.make_stream(r)
    raw = np.fromfile(r.capture, "<i2")
    assert raw.size == 2 * 4 * r.block
    pool = torch.cat(r.pool, 1)
    assert torch.equal(pool, capture.read(r.capture, "cpu"))
    assert torch.equal(pool[0], torch.as_tensor(raw[0::2] / 32768.0,
                                                dtype=torch.float32))
    # the scene survives the recorder: quantizing error under half a step
    from vdl2bench.traffic import scene as S
    sig = S.render(r.scene, r.seed, "cpu")
    assert float((pool - sig).abs().max()) <= 0.5 / 32768 + 1e-9


def test_tiny_file_cell_is_correct():
    r = tiny_file_run(42)
    res = harness.execute(r, device_info=False)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["info"]["matched_frames"] > 0
    assert res["metrics"]["realtime_factor"]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0


def test_fault_in_the_file_path_is_not_correct(monkeypatch):
    """Every block's Q converted from the wrong bytes (I twice)."""
    from dumpvdl2_tpu_torch.dsp import ingest_kernel
    orig = ingest_kernel.ingest_plain

    def bad(raw, pend, fmt, residual, oversample):
        block, res = orig(raw, pend, fmt, residual, oversample)
        block[1] = block[0]
        return block, res
    monkeypatch.setattr(ingest_kernel, "ingest_plain", bad)
    res = harness.execute(tiny_file_run(43), device_info=False)
    assert not res["correct"]


def test_traced_run_reads_the_input_spans():
    r = tiny_file_run(44, blocks=file_loop.STEP_BLOCKS
                      + file_loop.PROFILE_BLOCKS + 3, trace=True)
    res = harness.execute(r, device_info=False)
    assert res["correct"], res["check"]
    m = res["metrics"]
    assert m["read_ms_per_block.file"]["value"] >= 0
    assert m["ingest_ms_per_block.file"]["value"] > 0
    # the pipeline's own layers, as the closed loop's trace reads them
    for name in ("stack_ms_per_frame", "host_ms_per_block",
                 "detect_ms_per_block", "l2_ms_per_block",
                 "gate_ms_per_block", "fetch_ms_per_block"):
        assert m[name]["value"] > 0, name
    # no device on the CPU: no event interval, no device trace
    assert "ingest_dev_ms_per_block.file" not in m
    assert "ingest_roofline.file" not in m


def test_readers_give_nothing_without_their_spans(monkeypatch):
    from dumpvdl2_tpu_torch.core import spans
    log = spans.SpanLog(torch.device("cpu"))
    blk = log.new_block(False)
    log.open(blk, "feed_planar")
    log.close(blk, "feed_planar")
    r = tiny_file_run(45)
    r.block = 20 * 13107
    prof = {"kernels": {"sync_metric_kernel": {"calls": 1,
                                               "seconds": 1e-3}}}
    for name in READERS:
        assert harness.read_metric(name, r, {"profile": prof}, None) is None
        assert harness.read_metric(name, r, {"profile": None}, None) is None
    monkeypatch.setattr(spans, "_latest", None)
    for name in READERS[:3]:
        assert harness.read_metric(name, r, {}, None) is None


def test_ingest_roofline_arithmetic():
    r = tiny_file_run(46)
    r.block = 4194240
    t = 50.3e-6
    prof = {"kernels": {"_anonymous_namespace_::ingest_kernel(x)":
                        {"calls": 2, "seconds": 2 * t}}}
    got = harness.read_metric("ingest_roofline.file", r,
                              {"profile": prof}, None)
    bytes_ = 4194240 * (4 + 8)
    assert got == pytest.approx(bytes_ / 3.35e12 / t * 100.0)
