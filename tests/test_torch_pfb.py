"""The channelizer's polyphase filter bank (dsp/pfb_kernel.py, kernel KP
in csrc/pfb.cu) held to the GEMM formulation it replaces.

On the CPU (the bank's plain twin): the cells' channel sets (256
channels at oversample 80 and 8 at oversample 20, each tuned at its
middle: half bins) and integer-bin sets take the bank, and its output
equals the JAX package's ``bandpass_channelize`` within atol 2e-5 (the
JAX package's own limit), the port's GEMM formulation and the NCO-mix
oracle ``mix_filter_decimate_impl`` alike, over chains of blocks whose
lengths leave several residues modulo K (the live cell's 1 048 560 and
1 048 580 samples leave 72 and 8 modulo 84), whose NCO index crosses
2^24, and with a block shorter than the taps; the raw carry is exact.
Channel sets off the grid take the GEMM path unchanged, and the
pipeline's record says which path ran.  A pipeline makes its plan once,
the mesh once a shard, and a state of other channels brings its own.  The Taylor series' remainder
stays under 1e-7 of the output's RMS, and the mixed-radix transform is
a DFT.

On the card (marker ``cuda``; the JAX package is imported inside the
CPU tests only, so the file runs there with ``--noconftest``): KP equals
its twin bit for bit and the GEMM within atol 2e-5 at both cells' full
shapes, one launch a call; over a chain of live blocks of both lengths
across the wrap, the eager call and a CUDA graph's replay give the same
bits; a graphed pipeline's capture holds the plan it reads; KP runs on
each of two cards where there are two.
"""
import math
import types

import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu_torch.constants import SPS, SYMBOL_RATE
from dumpvdl2_tpu_torch.core import graphs, spans
from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
from dumpvdl2_tpu_torch.dsp import frontend as tfe
from dumpvdl2_tpu_torch.dsp import pfb_kernel
from dumpvdl2_tpu_torch.dsp.chebyshev import fir_taps
from vdl2bench import run as harness

CSC = 136_975_000
LIVE_LENGTHS = (1_048_560, 1_048_580)


def channel_set(C: int, os_: int, center: int | None = None,
                extra=()) -> tuple:
    """(fs, taps, dphi) of C channels 25 kHz apart from the CSC down,
    tuned at their middle (the CLI's rule) unless ``center`` is given,
    and ``extra`` frequencies beside them."""
    fs = SYMBOL_RATE * SPS * os_
    freqs = [CSC - 25_000 * i for i in range(C)]
    cf = (min(freqs) + max(freqs)) // 2 if center is None else center
    taps = tfe.prepare_taps(fir_taps(fs), os_)
    dphi = np.array([tfe.nco_dphi(cf, f, fs) for f in freqs + list(extra)],
                    np.uint32)
    return fs, taps, dphi


def tensors(taps, dphi):
    return torch.as_tensor(taps), torch.as_tensor(dphi.astype(np.int64))


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("C,os_,K", [(256, 80, 336), (8, 20, 84)])
def test_cells_channel_sets_take_the_bank(C, os_, K):
    """Both cells sit on half bins of a K-point grid: phi 1/2, two
    Taylor terms, the remainder's bound under 1e-7."""
    _, taps, dphi = channel_set(C, os_)
    plan = pfb_kernel.plan_for(*tensors(taps, dphi), os_)
    assert plan is not None
    assert (plan.K, plan.P, plan.phi) == (K, K // 21, 0.5)
    assert plan.orders == 2 and plan.truncation <= 1e-7
    assert plan.Q == -(-taps.size // K)
    bins = plan.bins.numpy()
    # bins -C/2 .. C/2 - 1 (then + 1/2), mod K
    assert sorted((bins + K // 2) % K - K // 2) == list(range(-C // 2,
                                                              C // 2))


@pytest.mark.parametrize("os_", [8, 30, 160, 7])
def test_other_grid_sizes_take_the_gemm(os_):
    """K = 105 kHz x os / 25 kHz must be 21 times a power of two up to
    16: 33.6 (os 8), 126 (os 30), 672 (os 160) and 29.4 (os 7) are
    not."""
    assert pfb_kernel.grid_size(os_) is None
    _, taps, dphi = channel_set(4, os_)
    assert pfb_kernel.plan_for(*tensors(taps, dphi), os_) is None


@pytest.mark.parametrize("center,extra", [
    (CSC - 37_500 + 1_000, ()),          # the tuner 1 kHz off the grid
    (None, (CSC + 8_333,)),              # an 8.33 kHz channel beside
])
def test_off_grid_sets_take_the_gemm_unchanged(center, extra):
    """No common phi in {0, 1/2} puts every channel within one NCO step
    of a bin: no plan, and bandpass_channelize is the GEMM formulation,
    bit for bit."""
    os_ = 20
    _, taps, dphi = channel_set(4, os_, center, extra)
    t_taps, t_dphi = tensors(taps, dphi)
    assert pfb_kernel.plan_for(t_taps, t_dphi, os_) is None
    rng = np.random.default_rng(9)
    iq = torch.as_tensor(rng.standard_normal((2, 60 * os_))
                         .astype(np.float32))
    carry = torch.as_tensor(rng.standard_normal((2, taps.size - 1))
                            .astype(np.float32))
    got = tfe.bandpass_channelize(iq, t_taps, t_dphi, 77, carry, os_)
    want = tfe.gemm_channelize(iq, t_taps, t_dphi, 77, carry, os_)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_a_stream_makes_its_plan_once(mesh, monkeypatch):
    """The pipeline makes the bank's plan when it is made, and the mesh
    once a shard at its first block; later blocks and the flush reuse
    them.  A plan given to bandpass_channelize is used as given."""
    made = []
    make = pfb_kernel.make_plan
    monkeypatch.setattr(pfb_kernel, "make_plan",
                        lambda *a: made.append(1) or make(*a))
    os_ = 10
    freqs = [CSC - 25_000 * i for i in range(4)]
    if mesh is None:
        pipe = VDL2Pipeline(freqs, CSC - 37_500, SYMBOL_RATE * SPS * os_,
                            os_, max_candidates=8, device="cpu")
    else:
        from dumpvdl2_tpu_torch.core.mesh_pipeline import MeshPipeline
        pipe = MeshPipeline(freqs, CSC - 37_500, SYMBOL_RATE * SPS * os_,
                            os_, mesh_shape=mesh, max_candidates=8,
                            devices=[torch.device("cpu")] * 4)
    assert len(made) == 1 and pipe.pfb_plan is not None
    rng = np.random.default_rng(2)
    for _ in range(4):
        pipe.feed(((rng.standard_normal(42_000)
                    + 1j * rng.standard_normal(42_000)) * 0.01)
                  .astype(np.complex64))
    pipe.finish()
    assert len(made) == 1 + (0 if mesh is None else mesh[0] * mesh[1])
    iq = torch.zeros((2, 4 * os_))
    carry = torch.zeros((2, pipe.taps.shape[0] - 1))
    tfe.bandpass_channelize(iq, pipe.taps, pipe.dphi, 0, carry, os_,
                            pipe.pfb_plan)
    tfe.bandpass_channelize(iq, pipe.taps, pipe.dphi, 0, carry, os_, None)
    assert len(made) == 1 + (0 if mesh is None else mesh[0] * mesh[1])


def cpu_state(pipe) -> dict:
    """load_state's dict of a pipeline that has run no block."""
    return {"taps": pipe.taps.numpy(),
            "dphi": pipe.dphi.numpy().astype(np.uint32),
            "carry": pipe.carry.numpy(), "n0": pipe.n0,
            "hist": pipe.hist.numpy(), "hist_base": pipe.hist_base,
            "channels": [{"busy_until": c.busy_until,
                          "next_det_min": c.next_det_min,
                          "mag_lp": c.mag_lp, "mag_nf": c.mag_nf,
                          "nfcnt": c.nfcnt, "nf_hold": c.nf_hold,
                          "nf_saved": c.nf_saved} for c in pipe.channels]}


def test_load_state_with_other_channels_makes_their_plan():
    """A state of the same taps and channels keeps the pipeline's plan;
    one of channels off the grid leaves it none, and its blocks run the
    GEMM."""
    from dumpvdl2_tpu_torch.core.pipeline import load_state
    os_ = 10
    fs = SYMBOL_RATE * SPS * os_
    pipe = VDL2Pipeline([CSC, CSC - 25_000], CSC - 12_500, fs, os_,
                        max_candidates=8, device="cpu")
    plan = pipe.pfb_plan
    load_state(pipe, cpu_state(pipe))
    assert pipe.pfb_plan is plan is not None
    off = VDL2Pipeline([CSC, CSC - 8_333], CSC, fs, os_, max_candidates=8,
                       device="cpu")
    load_state(pipe, cpu_state(off))
    assert pipe.pfb_plan is None
    rng = np.random.default_rng(4)
    pipe.feed(((rng.standard_normal(60_000)
                + 1j * rng.standard_normal(60_000)) * 0.01)
              .astype(np.complex64))
    recs = [b for b in pipe.span_log.blocks if b.ms("dispatch") is not None]
    assert recs and not any(b.pfb for b in recs)


# ------------------------------------------------ the output, by chains
def jax_chain(taps, dphi, os_, n0, carry, blocks):
    from dumpvdl2_tpu.dsp import frontend as jfe
    out, n = [], n0
    for iq in blocks:
        dec, carry = jfe.bandpass_channelize(
            iq, taps, dphi, np.uint32(n & 0xFFFFFF), carry, os_)
        out.append((np.asarray(dec), np.asarray(carry)))
        n = (n + iq.shape[1]) & 0xFFFFFF
    return out


def live_residue_lengths():
    """Multiples of 20 that leave the live cell's residues modulo 84
    (1 048 560 % 84 = 72, 1 048 580 % 84 = 8), and others."""
    assert [n % 84 for n in LIVE_LENGTHS] == [72, 8]
    lens = (4_440, 4_460, 4_000, 940, 4_460, 4_440)
    assert [n % 84 for n in lens] == [72, 8, 52, 16, 8, 72]
    return lens


CHAINS = {
    # the wideband cell's channel set; the second block < T - 1
    "wb256": (256, 80, None, (), (60 * 80, 37 * 80, 45 * 80), 3),
    # the live cell's: residues mod 84 of the live pair and others, a
    # block < T - 1, the NCO index across 2^24
    "sdr8_live": (8, 20, None, (), live_residue_lengths(),
                  (1 << 24) - 9_000),
    # integer bins (phi 0), os 10 (K 42)
    "ints_os10": (1, 10, CSC, (CSC - 25_000, CSC + 50_000, CSC - 400_000),
                  (150 * 10, 77 * 10, 150 * 10), (1 << 24) - 2_000),
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_bank_matches_the_gemm_jax_and_the_oracle(name):
    """Every block of the chain: the bank (bandpass_channelize) against
    the JAX package's GEMM formulation within atol 2e-5 and its raw
    carry exactly; against the port's GEMM formulation and the NCO-mix
    oracle within atol 2e-5."""
    C, os_, center, extra, lens, n0 = CHAINS[name]
    _, taps, dphi = channel_set(C, os_, center, extra)
    t_taps, t_dphi = tensors(taps, dphi)
    assert pfb_kernel.plan_for(t_taps, t_dphi, os_) is not None
    T = taps.size
    rng = np.random.default_rng(len(name))
    carry = rng.standard_normal((2, T - 1)).astype(np.float32)
    blocks = [rng.standard_normal((2, n)).astype(np.float32) for n in lens]
    want = jax_chain(taps, dphi, os_, n0, carry, blocks)

    b_carry = g_carry = torch.as_tensor(carry)
    o_carry = tfe.mix_nco(b_carry, t_dphi, (n0 - (T - 1)) & 0xFFFFFF)
    n = n0
    for iq, (j_dec, j_carry) in zip(blocks, want):
        t_iq = torch.as_tensor(iq)
        b_dec, b_carry = tfe.bandpass_channelize(t_iq, t_taps, t_dphi, n,
                                                 b_carry, os_)
        g_dec, g_carry = tfe.gemm_channelize(t_iq, t_taps, t_dphi, n,
                                             g_carry, os_)
        o_dec, o_carry = tfe.mix_filter_decimate_impl(t_iq, t_taps, t_dphi,
                                                      n, o_carry, os_)
        assert b_dec.shape == (2, dphi.size, iq.shape[1] // os_)
        np.testing.assert_allclose(b_dec.numpy(), j_dec, atol=2e-5)
        np.testing.assert_array_equal(b_carry.numpy(), j_carry)
        np.testing.assert_allclose(b_dec.numpy(), g_dec.numpy(), atol=2e-5)
        np.testing.assert_allclose(b_dec.numpy(), o_dec.numpy(), atol=2e-5)
        assert torch.equal(b_carry, g_carry)
        n = (n + iq.shape[1]) & 0xFFFFFF
    assert n < n0 or name == "wb256"      # the chain crossed 2^24


def test_n0_tensor_and_int_agree_across_the_wrap():
    """The bank never sees n0: a 0-dim tensor n0 gives the int's output
    exactly, at indices that wrap inside the block."""
    _, taps, dphi = channel_set(8, 20)
    t_taps, t_dphi = tensors(taps, dphi)
    rng = np.random.default_rng(2)
    iq = torch.as_tensor(rng.standard_normal((2, 4_460)).astype(np.float32))
    carry = torch.zeros((2, taps.size - 1))
    for n0 in ((1 << 24) - 1, (1 << 24) - 2_000, 0):
        a, _ = tfe.bandpass_channelize(iq, t_taps, t_dphi, n0, carry, 20)
        b, _ = tfe.bandpass_channelize(iq, t_taps, t_dphi,
                                       torch.tensor(n0), carry, 20)
        assert torch.equal(a, b)


# ------------------------------------------------ the series, the transform
@pytest.mark.parametrize("C,os_", [(256, 80), (8, 20)])
def test_taylor_remainder_under_1e7_of_the_output_rms(C, os_):
    """In float64, each channel's filter as the bank composes it (the
    plan's Taylor terms about the taps' centroid, the grid's bin and
    phi) against the exact h[u] e^{-j theta_c u}: the gap's output RMS
    on white input and its largest gain on a tone stay under 1e-7 of
    the output's RMS (the taps' L2 norm, their sum)."""
    _, taps, dphi = channel_set(C, os_)
    plan = pfb_kernel.plan_for(*tensors(taps, dphi), os_)
    h = taps.astype(np.float64)
    u = np.arange(h.size)
    u0 = pfb_kernel.taps_centroid(h)
    L = np.abs(u - u0).max()
    phi, k, e = pfb_kernel._grid(dphi, plan.K)
    delta = 2 * np.pi * e / (1 << 24)
    theta = 2 * np.pi * (dphi.astype(np.int64) & 0xFFFFFF) / (1 << 24)
    grid = np.exp(-2j * np.pi * np.outer(k + phi, u) / plan.K)
    series = sum(np.exp(-1j * delta * u0)[:, None]
                 * (-1j * delta * L)[:, None] ** n
                 * ((u - u0) / L)[None, :] ** n / math.factorial(n)
                 for n in range(plan.orders))
    gap = h * (grid * series - np.exp(-1j * np.outer(theta, u)))
    white = np.sqrt((np.abs(gap) ** 2).sum(1)) / np.sqrt((h * h).sum())
    tone = np.abs(gap).sum(1) / abs(h.sum())
    assert white.max() <= 1e-7 and tone.max() <= 1e-7
    # one term fewer leaves more than that
    assert pfb_kernel.truncation_bound(h, np.abs(delta).max(),
                                       plan.orders - 1) > 1e-7


@pytest.mark.parametrize("P", [1, 2, 4, 8, 16])
def test_mixed_radix_transform_is_the_dft(P):
    """The twin's transform (a P-point DFT, the table's twiddles, a
    21-point DFT; the kernel's order) against numpy's FFT in float64."""
    K = 21 * P
    i = np.arange(K)
    wtab = np.stack([np.cos(-2 * np.pi * i / K),
                     np.sin(-2 * np.pi * i / K)], 1).astype(np.float32)
    plan = pfb_kernel.Plan(
        K=K, P=P, phi=0.0, orders=1, Q=1, T=1, oversample=1, proto=None,
        pre=None, wtab=wtab, bins=None, dphi24=None, coef=None,
        truncation=0.0)
    rng = np.random.default_rng(P)
    v = rng.standard_normal((3, K)) + 1j * rng.standard_normal((3, K))
    xr, xi = pfb_kernel._transform(
        torch.as_tensor(v.real.astype(np.float32)),
        torch.as_tensor(v.imag.astype(np.float32)), plan)
    want = np.fft.fft(v, axis=-1)
    got = xr.numpy() + 1j * xi.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ------------------------------------------------ the record's flag
def run_cpu_pipeline(freqs, center, os_=10):
    fs = SYMBOL_RATE * SPS * os_
    pipe = VDL2Pipeline(freqs, center, fs, os_, max_candidates=8,
                        device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(3):
        pipe.feed(((rng.standard_normal(60_000)
                    + 1j * rng.standard_normal(60_000)) * 0.01)
                  .astype(np.complex64))
    pipe.finish()
    return [b for b in pipe.span_log.blocks if b.ms("dispatch") is not None]


@pytest.mark.parametrize("freqs,center,flag", [
    ([CSC, CSC - 25_000], CSC - 12_500, True),     # half bins
    ([CSC, CSC - 8_333], CSC, False),              # off the grid
])
def test_pipeline_record_says_which_path_ran(freqs, center, flag):
    recs = run_cpu_pipeline(freqs, center)
    assert len(recs) == 3 and all(b.pfb is flag for b in recs)


def record(log, pfb, synced=False, profiled=False, dispatched=True):
    blk = spans.Block(log._seq, synced, profiled, False)
    log._seq += 1
    log.blocks.append(blk)
    blk.pfb = pfb
    if dispatched:
        i = spans.SLOT["dispatch"]
        blk.t[i], blk.t[i + 1] = 0, 1_000_000
    return blk


@pytest.mark.parametrize("name", ["pfb_block_share",
                                  "pfb_block_share.live"])
def test_pfb_block_share_reader(name):
    """The share of untraced dispatching records whose channelizer ran
    the bank; synced, profiled and finish() records do not count; a log
    whose records have no ``pfb`` flag (the parent's) reads None."""
    log = spans.SpanLog(torch.device("cpu"))
    assert harness.read_metric(name, None, None, None) is None
    for flag in (True, True, False, True):
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


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def card_set(C, os_, dev):
    _, taps, dphi = channel_set(C, os_)
    return (torch.as_tensor(taps, device=dev),
            torch.as_tensor(dphi.astype(np.int64), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("C,os_,N", [(256, 80, 4_194_240),
                                     (8, 20, LIVE_LENGTHS[0]),
                                     (8, 20, LIVE_LENGTHS[1])])
def test_kernel_equals_twin_and_gemm_on_the_card(cuda, C, os_, N):
    taps, dphi = card_set(C, os_, cuda)
    plan = pfb_kernel.plan_for(taps, dphi, os_)
    gen = torch.Generator(device=cuda).manual_seed(N)
    iq = torch.randn((2, N), generator=gen, device=cuda)
    carry = torch.randn((2, plan.T - 1), generator=gen, device=cuda)
    n0 = (1 << 24) - N // 2
    before = pfb_kernel.launches
    got, _ = tfe.bandpass_channelize(iq, taps, dphi, n0, carry, os_)
    torch.cuda.synchronize(cuda)
    assert pfb_kernel.launches == before + 1
    want = pfb_kernel.pfb_plain(iq, carry, plan, n0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    gemm, _ = tfe.gemm_channelize(iq, taps, dphi, n0, carry, os_)
    assert (got - gemm).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_eager_and_graph_replay_agree_over_the_wrap(cuda):
    """Live blocks of both lengths from an n0 that crosses 2^24 within
    the chain: each block's dec and carry from a CUDA graph's replay
    (one capture a length, n0 a 0-dim device input, as core/pipeline.py
    captures) equal the eager call's bit for bit; a replay counts its
    launch."""
    os_ = 20
    taps, dphi = card_set(8, os_, cuda)
    plan = pfb_kernel.plan_for(taps, dphi, os_)
    gen = torch.Generator(device=cuda).manual_seed(7)
    lens = [LIVE_LENGTHS[i % 2] for i in range(20)]
    n = (1 << 24) - 5 * LIVE_LENGTHS[0]
    carry_in = torch.zeros((2, plan.T - 1), device=cuda)
    n0_t = torch.zeros((), dtype=torch.int64, device=cuda)
    pool = torch.cuda.graph_pool_handle()
    stream = torch.cuda.Stream(cuda)
    captured = {}
    e_carry = carry_in.clone()
    wrapped = False
    for N in lens:
        iq = torch.randn((2, N), generator=gen, device=cuda)
        e_dec, e_carry_new = tfe.bandpass_channelize(iq, taps, dphi, n,
                                                     e_carry, os_, plan)
        if N not in captured:
            x = torch.empty_like(iq)
            out = {}

            def step(x=x, out=out):
                out["r"] = tfe.bandpass_channelize(x, taps, dphi, n0_t,
                                                   carry_in, os_, plan)
                return lambda: out["r"]
            torch.cuda.synchronize(cuda)
            captured[N] = (x, graphs.StepGraph(step, pool, stream))
        x, g = captured[N]
        x.copy_(iq)
        carry_in.copy_(e_carry)
        n0_t.fill_(n)
        before = pfb_kernel.launches
        g_dec, g_carry = g.replay()
        torch.cuda.synchronize(cuda)
        assert pfb_kernel.launches == before + 1
        assert torch.equal(g_dec.view(torch.int32), e_dec.view(torch.int32))
        assert torch.equal(g_carry, e_carry_new)
        e_carry = e_carry_new
        wrapped |= n + N >= 1 << 24
        n = (n + N) & 0xFFFFFF
    assert wrapped and len(captured) == 2


@pytest.mark.cuda
def test_graphed_pipeline_keeps_its_plan(cuda):
    """The captured detect graph reads the plan's tensors: with the
    pipeline's own reference to its plan replaced after the capture,
    the memory churned and filled with NaN, a graphed pipeline's halo
    and frames stay bit for bit those of an undisturbed twin."""
    import gc
    os_ = 20
    fs = SYMBOL_RATE * SPS * os_
    freqs = [CSC - 25_000 * i for i in range(8)]
    rng = np.random.default_rng(11)
    n = 300_000
    blocks = [torch.as_tensor((rng.standard_normal((2, n)) * 0.01)
                              .astype(np.float32), device=cuda)
              for _ in range(10)]
    pipes = [VDL2Pipeline(freqs, CSC - 87_500, fs, os_, max_candidates=16,
                          device="cuda") for _ in range(2)]
    held = []
    frames = [[], []]
    for i, b in enumerate(blocks):
        for k, pipe in enumerate(pipes):
            frames[k] += pipe.feed_planar(b)
        torch.cuda.synchronize(cuda)
        assert torch.equal(pipes[0].hist.view(torch.int32),
                           pipes[1].hist.view(torch.int32)), i
        pipe = pipes[1]
        if pipe.graph_captures and not held:
            old = pipe.pfb_plan
            pipe.pfb_plan = pfb_kernel.plan_for(pipe.taps, pipe.dphi, os_)
            sizes = [t.numel() for t in (old.proto, old.pre, old.bins,
                                         old.dphi24, old.coef)]
            del old
            gc.collect()
            for _ in range(20):
                pfb_kernel.plan_for(pipe.taps, pipe.dphi, os_)
            held = [torch.full((m,), float("nan"), device=cuda)
                    for m in sizes for _ in range(64)]
    for k, pipe in enumerate(pipes):
        frames[k] += pipe.finish()
    assert held and all(p.graph_captures == 1 for p in pipes)
    assert [bytes(f.frame) for f in frames[1]] == \
        [bytes(f.frame) for f in frames[0]]
    assert all(b.pfb for b in pipes[1].span_log.blocks
               if b.ms("dispatch") is not None)


@pytest.mark.cuda
def test_kernel_runs_on_every_card(cuda):
    """KP's wideband CTA needs more than the default 48 KB of shared
    memory, a setting of each card's context: launches on card 0, card
    1 and card 0 again each equal the twin bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    os_ = 80
    for d in (0, 1, 0):
        dev = torch.device("cuda", d)
        taps, dphi = card_set(256, os_, dev)
        plan = pfb_kernel.plan_for(taps, dphi, os_)
        gen = torch.Generator(device=dev).manual_seed(d)
        iq = torch.randn((2, 80 * 2048), generator=gen, device=dev)
        carry = torch.randn((2, plan.T - 1), generator=gen, device=dev)
        got, _ = tfe.bandpass_channelize(iq, taps, dphi, 5, carry, os_,
                                         plan)
        want = pfb_kernel.pfb_plain(iq, carry, plan, 5)
        assert got.device == dev
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
