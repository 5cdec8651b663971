"""PyTorch port vs JAX: the per-block device step (core/device.py).

process_block_detect and process_block run over two chained blocks of
a raw wideband stream carrying bursts on two channels, each package on
its own carried state; every returned tensor must match: integers
exactly, float planes to the channelizer's 2e-5 (phases as angles, so
a +-pi wrap of a near-real sample is no difference).
"""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu.core import device as jdev
from dumpvdl2_tpu.dsp.chebyshev import fir_taps
from dumpvdl2_tpu.dsp.frontend import nco_dphi, prepare_taps, to_planar
from dumpvdl2_tpu.sim import synthesize_iq_raw
from dumpvdl2_tpu_torch.core import device as tdev

OS = 10
FS = 105000 * OS
CENTER = 136975000
FREQS = [CENTER, CENTER - 25000]
BLOCK = 40_000
HALO = 3000
K, S = 8, 512


def _stream():
    rng = np.random.default_rng(12)
    sig = ((rng.standard_normal(2 * BLOCK) + 1j * rng.standard_normal(
        2 * BLOCK)) * 0.01).astype(np.complex64)
    for at, off, seed in ((5_000, 0.0, 1), (36_000, -25e3, 2),
                          (52_000, 0.0, 3)):
        b = synthesize_iq_raw([bytes(rng.integers(0, 256, 24,
                                                  dtype=np.uint8))],
                              oversample=OS, carrier_offset_hz=off,
                              lead_in_syms=0, tail_syms=0, seed=seed)
        sig[at:at + b.size] += b * 0.5
    return to_planar(sig)


def _angle_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b))))


def _assert_dets(got, want):
    for name in ("count", "det_idx", "sync_idx", "sym_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.dphi.numpy(), np.asarray(want.dphi),
                               atol=1e-5)
    np.testing.assert_allclose(got.pherr.numpy(), np.asarray(want.pherr),
                               atol=1e-3)


@pytest.mark.parametrize("detect_only", [True, False])
def test_device_step_chained_blocks(detect_only):
    taps = prepare_taps(fir_taps(FS), OS)
    dphi = np.array([nco_dphi(CENTER, f, FS) for f in FREQS], np.uint32)
    planar = _stream()
    t_taps = torch.as_tensor(taps)
    t_dphi = torch.as_tensor(dphi.astype(np.int64))
    j_carry = np.zeros((2, taps.size - 1), np.float32)
    j_hist = np.zeros((2, len(FREQS), 0), np.float32)
    t_carry, t_hist = torch.as_tensor(j_carry), torch.as_tensor(j_hist)
    n0 = 0
    found = 0
    for b in range(2):
        iq = planar[:, b * BLOCK:(b + 1) * BLOCK]
        if detect_only:
            want = jdev.process_block_detect(iq, taps, dphi, np.uint32(n0),
                                             j_carry, j_hist, OS, HALO,
                                             4.0, K, S)
            got = tdev.process_block_detect(torch.as_tensor(iq), t_taps,
                                            t_dphi, n0, t_carry, t_hist, OS,
                                            HALO, 4.0, K, S)
            (wd, wph, wpw, j_hist, j_carry, wp3) = want
            (gd, gph, gpw, t_hist, t_carry, gp3) = got
            assert _angle_diff(gph.numpy(), np.asarray(wph)).max() < 2e-4
            np.testing.assert_allclose(gpw.numpy(), np.asarray(wpw),
                                       rtol=1e-4, atol=2e-5)
        else:
            want = jdev.process_block(iq, taps, dphi, np.uint32(n0), j_carry,
                                      j_hist, OS, HALO, 4.0, K, S)
            got = tdev.process_block(torch.as_tensor(iq), t_taps, t_dphi,
                                     n0, t_carry, t_hist, OS, HALO, 4.0,
                                     K, S)
            (wd, j_hist, j_carry, wp3) = want
            (gd, t_hist, t_carry, gp3) = got
            np.testing.assert_array_equal(gd.symbols.numpy(),
                                          np.asarray(wd.symbols))
            np.testing.assert_allclose(gd.power.numpy(),
                                       np.asarray(wd.power),
                                       rtol=1e-4, atol=2e-5)
        _assert_dets(gd, wd)
        found += int(gd.count.numpy().sum())
        np.testing.assert_allclose(t_hist.numpy(), np.asarray(j_hist),
                                   atol=2e-5)
        np.testing.assert_array_equal(t_carry.numpy(), np.asarray(j_carry))
        np.testing.assert_allclose(gp3.numpy(), np.asarray(wp3),
                                   rtol=1e-4, atol=2e-5)
        n0 = (n0 + BLOCK) & 0xFFFFFF
    assert found >= 3
