"""The receive pipeline's span log (dumpvdl2_tpu_torch/core/spans.py) on
the CPU, and the benchmark's readers of it (vdl2bench/metrics).

A two-channel scene at oversample 10 with three bursts, fed in blocks
through ``feed`` and ``feed_planar`` and flushed: every unsynchronized
block carries the span tree of its calls, spans nest, the frames each
drain returned add up, ``step_ms`` is the sum of the synchronized
spans, the ring stays bounded, ``latest()`` follows the newest
pipeline, a profiler trace holds a ``vdl2.*`` annotation for each span
on the log's clock (the fetch on its own thread), and outside a
profiler no profiler range is entered.  The CPU leaves the device
fields None.  Each reader is checked on a made-up log.
"""
import json

import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu_torch.constants import SPS, SYMBOL_RATE
from dumpvdl2_tpu_torch.core import spans
from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
from dumpvdl2_tpu_torch.sim import frame_with_fcs, synthesize_iq_raw
from vdl2bench import run as harness

OS = 10
FS = SYMBOL_RATE * SPS * OS
CENTER = 136975000
BLOCK = 100_000
N_RAW = 6 * BLOCK
TREE = {"feed": None, "feed.h2d": "feed", "feed_planar": "feed",
        "dispatch": "feed_planar", "detect": "dispatch", "l2": "dispatch",
        "gate": "dispatch", "drain": None, "drain.wait": "drain",
        "drain.verdicts": "drain"}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(1)
    sig = ((rng.standard_normal(N_RAW) + 1j * rng.standard_normal(N_RAW))
           * 0.01).astype(np.complex64)
    for k, at in enumerate((50_000, 250_000, 420_000)):
        b = synthesize_iq_raw([frame_with_fcs(b"span log %d " % k * 3)],
                              oversample=OS, seed=k).astype(np.complex64)
        sig[at:at + b.size] += b * 0.5
    return sig


def new_pipeline():
    return VDL2Pipeline([CENTER, CENTER + 25_000], CENTER, FS, OS,
                        max_candidates=8, device="cpu")


def run(sig, pipe, planar_from: int = 3):
    """Blocks before ``planar_from`` through feed, the rest through
    feed_planar, then finish; returns the frames."""
    frames = []
    for i, at in enumerate(range(0, N_RAW, BLOCK)):
        block = sig[at:at + BLOCK]
        if i < planar_from:
            frames += pipe.feed(block)
        else:
            planar = np.stack([block.real, block.imag]).astype(np.float32)
            frames += pipe.feed_planar(planar)
    return frames + pipe.finish()


@pytest.fixture(scope="module")
def plain(scene):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipe = new_pipeline()
        frames = run(scene, pipe)
    finally:
        torch.set_num_threads(n)
    return pipe, frames


def test_unsynchronized_blocks_have_the_span_tree(plain):
    pipe, frames = plain
    blocks = list(pipe.span_log.blocks)
    assert len(blocks) == N_RAW // BLOCK + 1       # the flush's own
    assert len(frames) >= 3
    assert sum(b.frames for b in blocks) == len(frames)
    for b in blocks:
        assert not b.synced and not b.profiled
        assert all(s.seq == b.seq for s in b.spans)
    for i, b in enumerate(blocks[:-1]):
        want = dict(TREE)
        if i >= 3:                 # through feed_planar: no feed spans
            for k in ("feed", "feed.h2d"):
                del want[k]
            want["feed_planar"] = None
        main = {s.name: s for s in b.spans if s.thread == spans.MAIN}
        assert set(main) == set(want), (i, sorted(main))
        for name, parent in want.items():
            got = main[name].parent
            if name == "drain":      # a later call, or the flush: never
                # the call that dispatched the block, done or not
                assert got[1] in ("feed_planar", "finish") and got[0] > i
            else:
                assert got == (None if parent is None else (b.seq, parent))
        fetch = [s for s in b.spans if s.thread == spans.FETCH]
        assert [(s.name, s.parent) for s in fetch] == [("fetch", None)]
        assert b.fetch_bytes is None       # counted in synced records
    flush = blocks[-1]
    assert [s.name for s in flush.spans] == ["finish"]


def test_spans_nest(plain):
    pipe, _ = plain
    by_key = {(s.seq, s.name): s for b in pipe.span_log.blocks
              for s in b.spans if s.thread == spans.MAIN}
    n = 0
    for b in pipe.span_log.blocks:
        for s in b.spans:
            assert s.start <= s.end
            if s.parent is not None:
                p = by_key[s.parent]
                assert p.start <= s.start and s.end <= p.end, (s, p)
                n += 1
    assert n > 40


def test_cpu_leaves_device_fields_none(plain):
    pipe, _ = plain
    for b in pipe.span_log.blocks:
        assert b.events is None
        assert (b.detect_dev, b.l2_dev, b.gate_dev, b.fetch_lag_dev) == \
            (None, None, None, None)


def test_step_ms_is_the_synchronized_spans(scene, plain):
    pipe = new_pipeline()
    pipe.step_ms = {}
    frames = run(scene, pipe, planar_from=0)
    assert [bytes(f.frame) for f in frames] == \
        [bytes(f.frame) for f in plain[1]]
    blocks = [b for b in pipe.span_log.blocks if b.span("dispatch")]
    assert all(b.synced for b in pipe.span_log.blocks)
    assert set(pipe.step_ms) == {"detect", "l2", "gate", "fetch_host"}
    for key, ms in pipe.step_ms.items():
        assert ms == pytest.approx(sum(b.ms(key) for b in blocks),
                                   rel=1e-12), key
    for b in blocks:
        # gate output, candidates, L2 rows, row map
        assert len(b.fetch_bytes) == 4 and min(b.fetch_bytes[:3]) > 0
        # synchronized: the block is drained in its own call, inside
        # the span fetch_host
        fh, drain = b.span("fetch_host"), b.span("drain")
        assert drain.parent == (b.seq, "feed_planar")
        assert fh.start <= drain.start and drain.end <= fh.end


def test_ring_stays_bounded():
    log = spans.SpanLog(torch.device("cpu"))
    for _ in range(spans.RING_BLOCKS + 24):
        blk = log.new_block(False)
        log.open(blk, "feed_planar")
        log.close(blk, "feed_planar")
    assert len(log.blocks) == spans.RING_BLOCKS >= 8192
    assert log.blocks[0].seq == 24
    assert log.blocks[-1].seq == spans.RING_BLOCKS + 23


def test_latest_is_the_newest_pipelines_log():
    first = new_pipeline()
    assert spans.latest() is first.span_log
    second = new_pipeline()
    log = second.span_log
    assert spans.latest() is log
    del first, second
    assert spans.latest() is log


def test_no_record_function_outside_a_profiler(scene, monkeypatch):
    def refuse(name):
        raise AssertionError(f"profiler range {name!r} entered")
    monkeypatch.setattr(spans, "_enter", refuse)
    pipe = new_pipeline()
    for at in range(0, 3 * BLOCK, BLOCK):
        pipe.feed(scene[at:at + BLOCK])
    pipe.finish()
    assert all(not b.profiled for b in pipe.span_log.blocks)


def test_profiler_trace_holds_each_span(scene, tmp_path):
    """Under a CPU profiler of every thread: one ``vdl2.<name>``
    annotation per span, its start within 1 ms of the span's start on
    the log's clock, the fetch on another thread than the dispatch."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=every_thread) as prof:
        pipe = new_pipeline()
        for at in range(0, 3 * BLOCK, BLOCK):
            pipe.feed(scene[at:at + BLOCK])
        pipe.finish()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    ann: dict = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith("vdl2."):
            ann.setdefault(e["name"][5:], []).append(
                (e["ts"] * 1e3 + base, e["tid"]))
    log = pipe.span_log
    got = [s for b in log.blocks for s in b.spans]
    assert all(b.profiled for b in log.blocks)
    names = {s.name for s in got}
    assert names == set(ann)
    for name in names:
        mine = sorted(log.wall_ns(s.start) for s in got if s.name == name)
        theirs = sorted(t for t, _ in ann[name])
        assert len(mine) == len(theirs), name
        for a, b in zip(mine, theirs):
            assert abs(a - b) < 1e6, (name, (a - b) / 1e6)
    assert {tid for _, tid in ann["fetch"]}.isdisjoint(
        {tid for _, tid in ann["dispatch"]})


# ------------------------------------------------------------ the readers
def made_up_block(log, synced=False, profiled=False, scale=1.0):
    """A block of ``log`` whose spans and device times are ``scale``
    times a fixed pattern (ms): feed.h2d 2, dispatch 3, fetch 4 (ending
    at 10), drain.wait 5, drain.verdicts 6, drain starting at 30."""
    blk = spans.Block(log._seq, synced, profiled, False)
    log._seq += 1
    log.blocks.append(blk)
    ms = int(1e6 * scale)

    def add(name, start, dur):
        i = spans.SLOT[name]
        blk.t[i], blk.t[i + 1] = start * ms, (start + dur) * ms
    add("feed.h2d", 0, 2)
    add("dispatch", 2, 3)
    add("fetch", 6, 4)
    add("drain", 30, 11)
    add("drain.wait", 30, 5)
    add("drain.verdicts", 35, 6)
    blk.detect_dev, blk.l2_dev, blk.gate_dev, blk.fetch_lag_dev = \
        7 * scale, 8 * scale, 9 * scale, 10 * scale
    return blk


READERS = {
    "dispatch_ms_per_block": 3, "drain_wait_ms_per_block": 5,
    "verdicts_ms_per_block": 6, "fetch_ms_per_block": 4,
    "detect_dev_ms_per_block": 7, "l2_dev_ms_per_block": 8,
    "gate_dev_ms_per_block": 9, "fetch_lag_dev_ms_per_block": 10,
    "ready_wait_ms_p50.live": 20, "h2d_ms_p90.live": 2,
    "dispatch_ms_p90.live": 3,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_made_up_log(name):
    """Only blocks neither synced nor profiled count: the made-up log
    holds a plain block at scale 1, another at scale 3 (whose mean or
    quantile the reader gives) and synced and profiled ones at scale 100
    that must not move it; an empty log reads None."""
    spans.SpanLog(torch.device("cpu"))
    assert harness.read_metric(name, None, None, None) is None
    log = spans.SpanLog(torch.device("cpu"))
    made_up_block(log, scale=1.0)
    made_up_block(log, synced=True, scale=100.0)
    made_up_block(log, profiled=True, scale=100.0)
    made_up_block(log, scale=3.0)
    want = READERS[name]
    q = {"p50": 0.5, "p90": 0.9}.get(name.split("_")[-1].split(".")[0])
    expect = want * (1 + 2 * q) if q is not None else want * 2.0
    assert harness.read_metric(name, None, None, None) == \
        pytest.approx(expect), name
    assert name in {m["name"] for m in json.loads(
        (harness.ROOT / "BENCHMARK.json").read_text())["per_layer"]}


def test_readers_without_the_log(monkeypatch):
    """A program without spans.latest() gives every reader None."""
    import builtins
    real = builtins.__import__

    def no_spans(name, *a, **kw):
        if name == "dumpvdl2_tpu_torch.core" and a and a[2] and \
                "spans" in a[2]:
            raise ImportError("no span log")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_spans)
    for name in READERS:
        assert harness.read_metric(name, None, None, None) is None, name


@pytest.mark.cuda
def test_device_times_on_the_card(scene, monkeypatch):
    """On CUDA each block dispatched and fetched gets its device ms by
    step without a synchronize, its events back in the pool, and frames
    equal to the CPU's (with events on every record); by default only
    one record in EVENT_EVERY gets them; with step_ms every record, and
    the steps' device time lies inside the dispatch span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ref = run(scene, new_pipeline())
    with monkeypatch.context() as m:
        m.setattr(spans, "EVENT_EVERY", 1)
        pipe = VDL2Pipeline([CENTER, CENTER + 25_000], CENTER, FS, OS,
                            max_candidates=8, device="cuda")
        frames = run(scene, pipe)
    assert [bytes(f.frame) for f in frames] == [bytes(f.frame) for f in ref]
    blocks = [b for b in pipe.span_log.blocks if b.span("dispatch")]
    assert len(blocks) == N_RAW // BLOCK
    for b in blocks:
        devs = (b.detect_dev, b.l2_dev, b.gate_dev, b.fetch_lag_dev)
        assert all(d is not None and d >= 0 for d in devs), devs
        assert b.events is None
    assert 0 < len(pipe.span_log._free) <= 5 * 3
    pipe = VDL2Pipeline([CENTER, CENTER + 25_000], CENTER, FS, OS,
                        max_candidates=8, device="cuda")
    run(scene, pipe)
    timed = [b.seq for b in pipe.span_log.blocks if b.detect_dev is not None]
    assert timed == [b.seq for b in pipe.span_log.blocks
                     if b.seq % spans.EVENT_EVERY == 0 and b.span("dispatch")]
    assert timed == [0]
    pipe = VDL2Pipeline([CENTER, CENTER + 25_000], CENTER, FS, OS,
                        max_candidates=8, device="cuda")
    pipe.step_ms = {}
    run(scene, pipe, planar_from=0)
    for b in pipe.span_log.blocks:
        if b.span("dispatch"):
            # synchronized: the steps' device work lies inside dispatch
            assert b.ms("dispatch") >= \
                (b.detect_dev + b.l2_dev + b.gate_dev) * 0.999
