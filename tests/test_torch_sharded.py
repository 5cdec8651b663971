"""PyTorch port vs JAX: the sharded (channel x time) DSP step.

JAX's step runs under shard_map on the 8 virtual CPU devices of
tests/conftest.py; the port's runs its single-controller loop over a
mesh of the same shape whose shards all sit on the CPU.  On the scene
of tests/test_sharded.py the candidate grids (Tn, C, K[, S]) must agree:
counts, indices, symbol counts and symbols exactly, the fitted
frequency within 1e-5, the metric within 1e-3, the symbol powers within
rtol 1e-5 and pwr3 within rtol 1e-4 (its tolerance in
tests/test_sharded.py).  The carried state must agree over two blocks,
with a burst across the block boundary.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401
from test_sharded import CENTER, FS, OS, _setup

from dumpvdl2_tpu import sim
from dumpvdl2_tpu.dsp.chebyshev import fir_taps
from dumpvdl2_tpu.dsp.frontend import nco_dphi, prepare_taps, to_planar
from dumpvdl2_tpu.parallel import mesh as jmesh
from dumpvdl2_tpu.parallel import sharded as jsh
from dumpvdl2_tpu_torch.constants import SPS
from dumpvdl2_tpu_torch.parallel import sharded as tsh
from dumpvdl2_tpu_torch.parallel.mesh import make_mesh

_INT_FIELDS = ("count", "det_idx", "sync_idx", "sym_valid", "symbols")


def _steps(cs, ts, freqs, K, S):
    taps = prepare_taps(fir_taps(FS), OS)
    dphi = np.array([nco_dphi(CENTER, f, FS) for f in freqs], np.uint32)
    fwd = S * SPS + 1
    jm = jmesh.make_mesh(cs, ts)
    jstep = jsh.make_sharded_step(jm, oversample=OS, fwd_halo=fwd,
                                  max_candidates=K, max_symbols=S)
    tm = make_mesh(cs, ts, ["cpu"] * (cs * ts))
    tstep = tsh.make_sharded_step(tm, oversample=OS, fwd_halo=fwd,
                                  max_candidates=K, max_symbols=S)
    t_taps = torch.as_tensor(taps)
    t_dphi = torch.as_tensor(dphi.astype(np.int64))

    def run_jax(iq, st):
        return jstep(iq, taps, dphi, st)

    def run_port(iq, st):
        return tstep(torch.as_tensor(iq), t_taps, t_dphi, st)

    return (run_jax, jsh.init_sharded_state(jm, len(freqs), taps.size),
            run_port, tsh.init_sharded_state(tm, len(freqs), taps.size))


def _assert_cands_match(got, want):
    want = jax.tree.map(np.asarray, want)
    for name in _INT_FIELDS:
        g, w = getattr(got, name).numpy(), getattr(want, name)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got.dphi.numpy(), want.dphi, atol=1e-5)
    np.testing.assert_allclose(got.pherr.numpy(), want.pherr, atol=1e-3)
    np.testing.assert_allclose(got.power.numpy(), want.power, rtol=1e-5,
                               atol=1e-7)


def _assert_state_match(got, want):
    np.testing.assert_array_equal(
        torch.cat(got.raw_tail).numpy().reshape(-1, *got.raw_tail[0].shape),
        np.broadcast_to(np.asarray(want.raw_tail)[0],
                        (len(got.raw_tail),) + got.raw_tail[0].shape))
    np.testing.assert_allclose(torch.cat(got.dec_tail, dim=1).numpy(),
                               np.asarray(want.dec_tail)[0], rtol=1e-5,
                               atol=1e-6)
    assert got.n0 == int(np.asarray(want.n0))


@pytest.mark.parametrize("cs,ts", [(1, 4), (2, 4), (4, 2), (1, 1)])
def test_sharded_step_matches_jax(cs, ts):
    freqs = [CENTER, CENTER - 25e3, CENTER + 25e3, CENTER - 50e3]
    K, S = 64, 256
    run_jax, jst, run_port, tst = _steps(cs, ts, freqs, K, S)
    iq = _setup(61440 * OS, freqs)
    want_c, want_p, want_st = run_jax(iq, jst)
    got_c, got_p, got_st = run_port(iq, tst)
    _assert_cands_match(got_c, want_c)
    assert int(got_c.count.sum()) >= len(freqs)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=1e-4, atol=1e-6)
    _assert_state_match(got_st, want_st)


def test_sharded_state_carries_over_two_blocks():
    """The second block sees the first block's tails over the wrap leg:
    a burst across the block boundary is found alike, and the state
    after each block agrees."""
    freqs = [CENTER, CENTER - 25e3]
    K, S = 8, 256
    run_jax, jst, run_port, tst = _steps(2, 4, freqs, K, S)
    N = 30720 * OS
    rng = np.random.default_rng(7)
    wide = (rng.standard_normal(2 * N)
            + 1j * rng.standard_normal(2 * N)) * 1e-3
    burst = sim.synthesize_iq_raw([b"\x10\x01\x01\x01BOUNDARY"],
                                  oversample=OS, snr_db=35.0, seed=3)
    off = N - burst.size // 2
    wide[off:off + burst.size] += burst
    iq = to_planar(wide.astype(np.complex64))
    total = 0
    for blk in (iq[:, :N], iq[:, N:]):
        want_c, want_p, jst = run_jax(blk, jst)
        got_c, got_p, tst = run_port(blk, tst)
        _assert_cands_match(got_c, want_c)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                                   rtol=1e-4, atol=1e-6)
        _assert_state_match(tst, jst)
        total += int(got_c.count.sum())
    assert total >= 1
