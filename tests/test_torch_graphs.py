"""The main path's device steps as CUDA graphs (core/graphs.py and the
graph path of core/pipeline.py).

On the CPU: the per-block integers a graph takes as 0-dim tensors give
the int path's results exactly (the channelizer's ``n0``, the gate's
base ``delta``); :func:`pipeline.graph_key` keeps every block but the
steady ones of the CUDA main path eager, and a CPU pipeline never
captures; a packed copy taken before its sources change keeps their
old values (``fetch.Packed``, ``graphs.Snapshot``); the launch counters'
bookkeeping; the benchmark's ``graph_block_share`` readers.

On the card (marker ``cuda``; the file imports no JAX, so it runs there
with ``--noconftest``): a graphed pipeline against an eager one on the
same wideband blocks and live ``feed`` blocks, block by block, each key
captured once, the launch counters alike, a capture with a fetch in
flight, and steady dispatches under ``set_sync_debug_mode("error")``.
"""
import time
import types

import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu_torch.constants import SPS, SYMBOL_RATE
from dumpvdl2_tpu_torch.core import graphs, nf_gate, pipeline, spans
from dumpvdl2_tpu_torch.core.pipeline import (DEFAULT_HALO, MAX_BURST_SYMS,
                                              VDL2Pipeline, graph_key)
from dumpvdl2_tpu_torch.dsp.chebyshev import fir_taps
from dumpvdl2_tpu_torch.dsp.frontend import (bandpass_channelize, nco_dphi,
                                             prepare_taps)
from dumpvdl2_tpu_torch.sim import frame_with_fcs, synthesize_iq_raw
from dumpvdl2_tpu_torch.utils import fetch
from vdl2bench import run as harness

CENTER = 136975000
CUDA = torch.device("cuda")


# ------------------------------------------------------------ CPU: inputs
@pytest.mark.parametrize("n0", [0, 1, 123_457, (1 << 24) - 3_001,
                                (1 << 24) - 1])
def test_channelize_n0_tensor_equals_int(n0):
    """n0 as a 0-dim int64 tensor gives the int path's block exactly,
    also where the NCO index wraps at 2^24 inside the block."""
    os_ = 20
    fs = SYMBOL_RATE * SPS * os_
    taps = torch.as_tensor(prepare_taps(fir_taps(fs), os_))
    freqs = [CENTER - 25_000, CENTER, CENTER + 75_000]
    dphi = torch.as_tensor(np.array([nco_dphi(CENTER, f, fs) for f in freqs],
                                    np.uint32).astype(np.int64))
    rng = np.random.default_rng(n0 % 1000)
    iq = torch.as_tensor(rng.standard_normal((2, 300 * os_))
                         .astype(np.float32))
    carry = torch.as_tensor(rng.standard_normal((2, taps.shape[0] - 1))
                            .astype(np.float32))
    dec_i, carry_i = bandpass_channelize(iq, taps, dphi, n0, carry, os_)
    dec_t, carry_t = bandpass_channelize(
        iq, taps, dphi, torch.tensor(n0, dtype=torch.int64), carry, os_)
    assert torch.equal(dec_t, dec_i) and torch.equal(carry_t, carry_i)


@pytest.mark.parametrize("delta", [0, 52_428, -7, nf_gate.MAX_DELTA,
                                   -nf_gate.MAX_DELTA])
def test_rebase_delta_tensor_equals_int(delta):
    """The gate's rebase with ``delta`` as a 0-dim int32 tensor equals
    the int path, clamp at the floor included."""
    rng = np.random.default_rng(abs(delta) % 97)
    st = nf_gate.init_state(4, ring=16)
    for k in ("busy_until", "next_det_min", "hold"):
        st[k] = torch.as_tensor(rng.integers(-(1 << 30), 1 << 30, 4)
                                .astype(np.int32))
    st["ring_pos"] = torch.as_tensor(rng.integers(-(1 << 30), 1 << 30,
                                                  (4, 16)).astype(np.int32))
    by_int = nf_gate._rebase(st, delta)
    by_tensor = nf_gate._rebase(st, torch.tensor(delta, dtype=torch.int32))
    assert by_int.keys() == by_tensor.keys()
    for k in by_int:
        assert by_tensor[k].dtype == by_int[k].dtype, k
        assert torch.equal(by_tensor[k], by_int[k]), k


# -------------------------------------------------------- CPU: the key
STEADY = dict(device=CUDA, device_l2=True, device_gate=True, H=DEFAULT_HALO,
              N=4_194_240, C=256, T=720, K=64, S=MAX_BURST_SYMS)


@pytest.mark.parametrize("change", [
    {"device": torch.device("cpu")},        # always eager on the CPU
    {"device_l2": False},                   # host L2
    {"device_gate": False},                 # host gating
    {"H": 0}, {"H": 52_428},                # the halo still grows
    {"N": 0},                               # the EOF flush: no fresh block
])
def test_graph_key_decides_eager(change):
    assert graph_key(**{**STEADY, **change}) is None


def test_graph_key_of_steady_blocks():
    """A steady main-path block has a key; another length, another
    key, so a changed N never replays a graph of the old one."""
    key = graph_key(**STEADY)
    assert key == (4_194_240, 256, 720, DEFAULT_HALO, 64, MAX_BURST_SYMS)
    assert graph_key(**{**STEADY, "N": 1_048_560}) != key
    assert graph_key(**{**STEADY, "N": 1_048_560}) == \
        graph_key(**{**STEADY, "N": 1_048_560})


def test_cpu_pipeline_never_captures():
    """Steady blocks on the CPU run eagerly: no capture, no graphed
    record."""
    os_ = 10
    fs = SYMBOL_RATE * SPS * os_
    pipe = VDL2Pipeline([CENTER, CENTER - 25_000], CENTER, fs, os_,
                        max_candidates=8, device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(4):
        pipe.feed(((rng.standard_normal(250_000)
                    + 1j * rng.standard_normal(250_000)) * 0.01)
                  .astype(np.complex64))
    assert pipe.hist.shape[2] == DEFAULT_HALO
    pipe.finish()
    assert pipe.graph_captures == 0 and not pipe._graphs
    recs = [b for b in pipe.span_log.blocks if b.span("dispatch")]
    assert len(recs) == 4 and not any(b.graphed for b in recs)


# ------------------------------------------------ CPU: copies and counts
def tree():
    return ({"ok": torch.tensor([True, False, True, True, False]),
             "i8": torch.tensor([-3, 0, 7], dtype=torch.int8),
             "none": None},
            torch.arange(6, dtype=torch.float32).reshape(2, 3),
            [torch.tensor([1 << 40, -5], dtype=torch.int64),
             torch.tensor([0.5, -0.25, 2.0], dtype=torch.float16)])


def overwrite(t):
    t[0]["ok"].logical_not_()
    t[0]["i8"].add_(1)
    t[1].mul_(-2)
    t[2][0].add_(9)
    t[2][1].fill_(7)


def assert_tree_equal(got, want):
    flat_got, flat_want = [], []
    fetch._flatten(got, flat_got)
    fetch._flatten(want, flat_want)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_packed_copy_keeps_old_values():
    """A copy of pack_tree taken before the tree's tensors are
    overwritten unpacks, as a Packed tree, to their old values."""
    t = tree()
    want = fetch.coalesced_get(tree())
    buf = fetch.pack_tree(t).clone()
    overwrite(t)
    got = fetch.coalesced_get(fetch.Packed(t, buf))
    assert got[0]["none"] is None
    assert_tree_equal(got, want)
    assert not np.array_equal(fetch.coalesced_get(t)[1], want[1])


def test_snapshot_copies_are_aligned_views_of_old_values():
    """A Snapshot's copy gives the tree as views of one buffer, each at
    an offset of its own alignment, holding the values of the moment
    the snapshot was made; later writes to the sources leave it."""
    t = tree()
    want = fetch.coalesced_get(tree())
    snap = graphs.Snapshot(t)
    first = snap.copy()
    overwrite(t)
    second = snap.copy()
    for got in (first, second):
        assert got[0]["none"] is None
        assert_tree_equal(got, want)
        leaves: list = []
        fetch._flatten(got, leaves)
        bases = {x.untyped_storage().data_ptr() for x in leaves}
        assert len(bases) == 1
        base = bases.pop()
        for x in leaves:
            assert (x.data_ptr() - base) % x.element_size() == 0
    assert first[1].untyped_storage().data_ptr() != \
        second[1].untyped_storage().data_ptr()


def test_launch_counts_add_up():
    """launch_counts reads every wrapper's counter; add_launches adds
    a replay's launches to them (and takes a capture's back)."""
    before = graphs.launch_counts()
    assert {mod.__name__.rsplit(".", 1)[1] for mod, _ in before} == {
        "sync_kernel", "candidates_kernel", "l2_kernel", "gate_kernel"}
    delta = {k: i + 1 for i, k in enumerate(before)}
    try:
        graphs.add_launches(delta)
        after = graphs.launch_counts()
        assert all(after[k] == before[k] + delta[k] for k in before)
    finally:
        graphs.add_launches({k: -n for k, n in delta.items()})
    assert graphs.launch_counts() == before


# ---------------------------------------------------- CPU: the readers
def record(log, graphed, synced=False, profiled=False, dispatched=True):
    blk = spans.Block(log._seq, synced, profiled, False)
    log._seq += 1
    log.blocks.append(blk)
    blk.graphed = graphed
    if dispatched:
        i = spans.SLOT["dispatch"]
        blk.t[i], blk.t[i + 1] = 0, 1_000_000
    return blk


@pytest.mark.parametrize("name", ["graph_block_share",
                                  "graph_block_share.live"])
def test_graph_block_share_reader(name, monkeypatch):
    """The share of untraced dispatching records that are graphed;
    synced, profiled and finish() records do not count; a log whose
    records have no ``graphed`` flag reads None."""
    log = spans.SpanLog(torch.device("cpu"))
    assert harness.read_metric(name, None, None, None) is None
    for flag in (False, True, True, True):
        record(log, flag)
    record(log, False, synced=True)
    record(log, False, profiled=True)
    record(log, False, dispatched=False)
    assert harness.read_metric(name, None, None, None) == 0.75
    log = spans.SpanLog(torch.device("cpu"))
    old = types.SimpleNamespace(synced=False, profiled=False,
                                ms=lambda name: 1.0)
    log.blocks.append(old)
    assert harness.read_metric(name, None, None, None) is None


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return CUDA


OS = 20
FS = SYMBOL_RATE * SPS * OS
FREQS = [CENTER - 25_000 * c for c in range(8)]


def scene(n_raw: int, seed: int) -> np.ndarray:
    """Noise and a burst on each channel in turn, some across block
    boundaries, at the ingest rate of 8 channels at oversample 20."""
    rng = np.random.default_rng(seed)
    sig = ((rng.standard_normal(n_raw) + 1j * rng.standard_normal(n_raw))
           * 0.01).astype(np.complex64)
    at = 150_000
    for k in range(n_raw // 500_000 * 2):
        f = FREQS[k % len(FREQS)]
        b = synthesize_iq_raw([frame_with_fcs(b"graph %d " % k * (2 + k % 5))],
                              oversample=OS, carrier_offset_hz=f - CENTER,
                              seed=seed + k)
        if at + b.size >= n_raw:
            break
        sig[at:at + b.size] += b * 0.5
        at += 237_000 + b.size
    return sig


def recorded(monkeypatch, pipe):
    """Each block's detections, planes and L2 rows (the step calls'
    results, where core/pipeline looks the steps up) and the verdicts
    its drain read, as host arrays."""
    got = {"detect": [], "l2": [], "verdicts": []}
    detect, l2 = pipeline.process_block_detect, pipeline.l2_sliced

    def on_detect(*a, **kw):
        out = detect(*a, **kw)
        got["detect"].append(fetch.coalesced_get(
            (tuple(out[0]), out[1].cpu(), out[2].cpu())))
        return out

    def on_l2(*a, **kw):
        out = l2(*a, **kw)
        got["l2"].append(fetch.coalesced_get(out))
        return out

    def on_verdicts(gout, *rest):
        got["verdicts"].append({k: np.array(v) for k, v in gout.items()})
        return VDL2Pipeline._process_verdicts(pipe, gout, *rest)
    monkeypatch.setattr(pipeline, "process_block_detect", on_detect)
    monkeypatch.setattr(pipeline, "l2_sliced", on_l2)
    pipe._process_verdicts = on_verdicts
    return got


def run_pair(monkeypatch, blocks, planar: bool, slow_fetch: float = 0.0):
    """The same blocks through an eager and a graphed pipeline on the
    card: each one's frames, recorded steps, launches and pipeline."""
    out = []
    for graphed in (False, True):
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(pipeline, "graph_key", lambda *a: None)
            pipe = VDL2Pipeline(FREQS, CENTER, FS, OS, max_candidates=16,
                                device="cuda")
            if slow_fetch:
                fetch_block = pipe._fetch

                def slow(tree, blk):
                    time.sleep(slow_fetch)
                    return fetch_block(tree, blk)
                pipe._fetch = slow
            got = recorded(m, pipe)
            before = graphs.launch_counts()
            frames = []
            for b in blocks:
                frames += pipe.feed_planar(b) if planar else pipe.feed(b)
            frames += pipe.finish()
            torch.cuda.synchronize()
            after = graphs.launch_counts()
        out.append({"frames": frames, "got": got, "pipe": pipe,
                    "launches": {k: after[k] - before[k] for k in after}})
    return out


def assert_same_blocks(eager, graphed):
    assert [(bytes(f.frame), f.metadata.freq) for f in graphed["frames"]] \
        == [(bytes(f.frame), f.metadata.freq) for f in eager["frames"]]
    for a, b in zip(graphed["frames"], eager["frames"]):
        for key in ("ppm_error", "frame_pwr_dbfs", "nf_pwr_dbfs"):
            assert getattr(a.metadata, key) == getattr(b.metadata, key), key
    ge, gg = eager["got"], graphed["got"]
    assert len(gg["detect"]) == len(ge["detect"]) > 0
    for (de, ph_e, pw_e), (dg, ph_g, pw_g) in zip(ge["detect"],
                                                   gg["detect"]):
        for x, y in zip(dg, de):
            np.testing.assert_array_equal(x, y)
        ze = np.sqrt(pw_e.astype(np.float64)) * np.exp(1j * ph_e)
        zg = np.sqrt(pw_g.astype(np.float64)) * np.exp(1j * ph_g)
        assert np.abs(zg - ze).max() <= 2e-5
    assert len(gg["l2"]) == len(ge["l2"])
    for (l2e, inv_e), (l2g, inv_g) in zip(ge["l2"], gg["l2"]):
        assert (inv_e is None) == (inv_g is None)
        if inv_e is not None:
            np.testing.assert_array_equal(inv_g, inv_e)
        assert l2g.keys() == l2e.keys()
        for k in l2e:
            np.testing.assert_array_equal(l2g[k], l2e[k], err_msg=k)
    assert len(gg["verdicts"]) == len(ge["verdicts"])
    for vg, ve in zip(gg["verdicts"], ge["verdicts"]):
        for k in ve:
            np.testing.assert_array_equal(vg[k], ve[k], err_msg=k)
    assert graphed["launches"] == eager["launches"]


@pytest.mark.cuda
def test_graphed_wideband_blocks_match_eager(cuda, monkeypatch):
    """Ten feed_planar blocks (the halo full from the third on): the
    graphed pipeline's frames, detections, planes, L2 rows and verdicts
    equal the eager one's block by block, one capture, every steady
    record graphed, the launch counters alike."""
    n = 600_000
    sig = scene(10 * n, seed=3)
    blocks = [torch.as_tensor(np.stack([sig[i:i + n].real,
                                        sig[i:i + n].imag]), device=cuda)
              for i in range(0, 10 * n, n)]
    eager, graphed = run_pair(monkeypatch, blocks, planar=True)
    assert len(eager["frames"]) >= 10
    assert_same_blocks(eager, graphed)
    pipe = graphed["pipe"]
    assert pipe.graph_captures == 1 and len(pipe._graphs) == 1
    assert eager["pipe"].graph_captures == 0
    recs = [b.graphed for b in pipe.span_log.blocks if b.span("dispatch")]
    assert recs == [False, False] + [True] * 8


@pytest.mark.cuda
def test_graphed_live_blocks_match_eager(cuda, monkeypatch):
    """Fourteen host blocks of 300 007 samples through feed (the halo
    full from the fifth on): two block lengths (300 000 and 300 020
    after the residual), each captured once,
    the results equal the eager pipeline's; a fetch slowed to be in
    flight at each capture changes nothing."""
    n = 300_007
    sig = scene(14 * n, seed=8)
    blocks = [sig[i:i + n] for i in range(0, 14 * n, n)]
    eager, graphed = run_pair(monkeypatch, blocks, planar=False,
                              slow_fetch=0.05)
    assert_same_blocks(eager, graphed)
    pipe = graphed["pipe"]
    keys = sorted(k[0] for k in pipe._graphs)
    assert keys == [300_000, 300_020]
    assert pipe.graph_captures == 2
    recs = [b.graphed for b in pipe.span_log.blocks if b.span("dispatch")]
    assert recs == [False] * 4 + [True] * 10


@pytest.mark.cuda
def test_steady_dispatch_does_not_synchronize(cuda):
    """Steady _dispatch_block calls (replays, their inputs and copies)
    under set_sync_debug_mode("error") raise nothing."""
    n = 600_000
    sig = scene(6 * n, seed=4)
    blocks = [torch.as_tensor(np.stack([sig[i:i + n].real,
                                        sig[i:i + n].imag]), device=cuda)
              for i in range(0, 6 * n, n)]
    pipe = VDL2Pipeline(FREQS, CENTER, FS, OS, max_candidates=16,
                        device="cuda")
    for b in blocks[:3]:
        pipe.feed_planar(b)
    pipe.finish()
    torch.cuda.synchronize()
    assert pipe.graph_captures == 1
    trees = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in blocks[3:]:
            pipe.span_log.new_block(False)
            trees.append(pipe._dispatch_block(b))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(isinstance(t[0], fetch.Packed) for t in trees)
    assert pipe.graph_captures == 1
