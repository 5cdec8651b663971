"""PyTorch port vs JAX: detection and symbol slicing (dsp/demod.py).

Bursts at several carrier offsets, one per channel row, go through both
packages' find_candidates / find_and_slice; candidate counts and
indices, symbol counts and symbols must match exactly, the fitted
frequency and metric to the sync metric's tolerances.
"""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu import sim
from dumpvdl2_tpu.dsp import demod as jdm
from dumpvdl2_tpu.dsp.frontend import to_planar
from dumpvdl2_tpu_torch.dsp import demod as tdm

OFFSETS = (0.0, 200.0, -350.0, 600.0)


def _scene(seed: int, bursts_per_row: int = 1) -> np.ndarray:
    """(2, C, M) decimated planar block: one row per carrier offset."""
    rng = np.random.default_rng(seed)
    rows = []
    for c, off in enumerate(OFFSETS):
        parts = []
        for b in range(bursts_per_row):
            frames = [bytes(rng.integers(0, 256, 20 + 13 * c + 7 * b,
                                         dtype=np.uint8))]
            parts.append(sim.synthesize_iq(frames, snr_db=25.0,
                                           freq_offset_hz=off,
                                           lead_in_syms=30 + 11 * c,
                                           seed=seed + 10 * c + b))
        rows.append(np.concatenate(parts))
    M = max(r.size for r in rows) + 40
    noise = (rng.standard_normal((len(rows), M))
             + 1j * rng.standard_normal((len(rows), M))) * 0.05
    block = noise.astype(np.complex64)
    for c, r in enumerate(rows):
        block[c, :r.size] += r
    return np.stack([to_planar(r) for r in block], axis=1)


def _assert_dets_equal(got, want):
    for name in ("count", "det_idx", "sync_idx", "sym_valid"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == np.int32, name
    np.testing.assert_allclose(got.dphi.numpy(), np.asarray(want.dphi),
                               atol=1e-5)
    np.testing.assert_allclose(got.pherr.numpy(), np.asarray(want.pherr),
                               atol=1e-3)


@pytest.mark.parametrize("seed,bursts,K,S", [
    (3, 1, 8, 1024), (5, 3, 8, 512), (8, 3, 2, 256)])
def test_find_and_slice_matches_jax(seed, bursts, K, S):
    iq = _scene(seed, bursts)
    got = tdm.find_and_slice(torch.as_tensor(iq), 4.0, K, S)
    want = jdm.find_and_slice(iq, 4.0, K, S)
    _assert_dets_equal(got, want)
    assert int(got.count.numpy().min()) >= 1
    np.testing.assert_array_equal(got.symbols.numpy(),
                                  np.asarray(want.symbols))
    np.testing.assert_allclose(got.power.numpy(), np.asarray(want.power),
                               rtol=1e-5, atol=1e-7)


def test_find_candidates_detect_window_matches_jax():
    iq = _scene(4, 3)
    phases = np.arctan2(iq[1], iq[0]).astype(np.float32)
    M = phases.shape[1]
    for lo, hi in ((0, None), (400, M - 300), (M // 2, M)):
        got = tdm.find_candidates(torch.as_tensor(phases), 4.0, 8, 512,
                                  lo, hi)
        want = jdm.find_candidates_impl(phases, 4.0, 8, 512, lo, hi)
        _assert_dets_equal(got, want)


def test_demod_window_matches_jax():
    rng = np.random.default_rng(6)
    sym_phase = rng.uniform(-np.pi, np.pi, (3, 5, 65)).astype(np.float32)
    power = rng.uniform(0, 1, (3, 5, 65)).astype(np.float32)
    dphi = rng.uniform(-0.3, 0.3, (3, 5)).astype(np.float32)
    s1, p1 = tdm.demod_window(torch.as_tensor(sym_phase),
                              torch.as_tensor(power), torch.as_tensor(dphi))
    s0, p0 = jdm.demod_window(sym_phase, power, dphi)
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s0))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(p0))
