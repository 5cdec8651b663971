"""PyTorch port vs JAX: channelizer front end (dsp/frontend.py).

Same seeded numpy inputs through both packages on the CPU; the
decimated output must agree to atol=2e-5 (the JAX package's own limit,
tests/test_dsp.py) and the raw carry must match exactly, over two
chained blocks.
"""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu.dsp import frontend as jfe
from dumpvdl2_tpu.dsp.chebyshev import fir_taps as j_fir_taps
from dumpvdl2_tpu_torch.dsp import frontend as tfe
from dumpvdl2_tpu_torch.dsp.chebyshev import fir_taps as t_fir_taps

CENTER = 136.975e6


@pytest.mark.parametrize("os_,n0,lens", [
    (10, 12345, (150 * 10, 150 * 10)),
    (20, (1 << 24) - 700, (200 * 20, 120 * 20)),   # NCO index wraps
    (80, 3, (90 * 80, 40 * 80)),                   # 2nd block < T - 1
])
def test_bandpass_channelize_chained_blocks(os_, n0, lens):
    fs = 105000.0 * os_
    taps_np = jfe.prepare_taps(j_fir_taps(fs), os_)
    np.testing.assert_array_equal(tfe.prepare_taps(t_fir_taps(fs), os_),
                                  taps_np)
    freqs = [CENTER - 25e3, CENTER, CENTER + 50e3, CENTER - 400e3]
    dphi = np.array([jfe.nco_dphi(CENTER, f, fs) for f in freqs], np.uint32)
    np.testing.assert_array_equal(
        np.array([tfe.nco_dphi(CENTER, f, fs) for f in freqs], np.uint32),
        dphi)
    T = taps_np.size
    rng = np.random.default_rng(os_)
    carry_np = rng.standard_normal((2, T - 1)).astype(np.float32)
    j_carry, t_carry = carry_np, torch.as_tensor(carry_np)
    t_taps = torch.as_tensor(taps_np)
    t_dphi = torch.as_tensor(dphi.astype(np.int64))
    n = n0
    for N in lens:
        iq = rng.standard_normal((2, N)).astype(np.float32)
        j_dec, j_carry = jfe.bandpass_channelize(
            iq, taps_np, dphi, np.uint32(n & 0xFFFFFF), j_carry, os_)
        t_dec, t_carry = tfe.bandpass_channelize(
            torch.as_tensor(iq), t_taps, t_dphi, n & 0xFFFFFF, t_carry, os_)
        assert t_dec.shape == (2, len(freqs), N // os_)
        np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec),
                                   atol=2e-5)
        np.testing.assert_array_equal(t_carry.numpy(), np.asarray(j_carry))
        n = (n + N) & 0xFFFFFF


def test_dequantize_matches_jax():
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, 1000, dtype=np.uint8)
    s16 = rng.integers(-32768, 32768, 1000, dtype=np.int16)
    np.testing.assert_array_equal(
        tfe.dequantize_u8(torch.as_tensor(u8)).numpy(),
        np.asarray(jfe.dequantize_u8(u8)))
    np.testing.assert_array_equal(
        tfe.dequantize_s16(torch.as_tensor(s16)).numpy(),
        np.asarray(jfe.dequantize_s16(s16)))


def test_to_planar_matches_jax():
    rng = np.random.default_rng(4)
    iq = (rng.standard_normal(64) + 1j * rng.standard_normal(64)) \
        .astype(np.complex64)
    np.testing.assert_array_equal(tfe.to_planar(iq), jfe.to_planar(iq))
