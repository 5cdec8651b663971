"""PyTorch port vs JAX: the preamble sync metric (kernel K1's twin).

The port's plain version must match the JAX XLA metric and the Pallas
kernel in interpret mode (as tests/test_dsp.py runs it) with the same
inf mask, |d err| < 1e-3 and |d freq| < 1e-5 (tests/test_tpu_hw.py's
limits for the compiled kernel).  On a CPU tensor the dispatching
wrapper runs the plain version and launches nothing.
"""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu.dsp.demod import sync_error_metric as j_metric
from dumpvdl2_tpu.dsp.sync_pallas import sync_error_metric_pallas
from dumpvdl2_tpu_torch.dsp import sync_kernel


def _phases(C, M, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi, np.pi, (C, M)).astype(np.float32)


def _assert_metric_close(got, want):
    (e1, f1), (e0, f0) = got, want
    e1, f1, e0, f0 = map(np.asarray, (e1, f1, e0, f0))
    assert e1.shape == e0.shape and f1.shape == f0.shape
    np.testing.assert_array_equal(np.isinf(e1), np.isinf(e0))
    fin = ~np.isinf(e0)
    assert np.abs(e1[fin] - e0[fin]).max(initial=0.0) < 1e-3
    assert np.abs(f1 - f0).max(initial=0.0) < 1e-5


@pytest.mark.parametrize("C,M", [(5, 4321), (3, 120), (2, 150), (1, 151)])
def test_plain_matches_jax_xla(C, M):
    ph = _phases(C, M, seed=C * 1000 + M)
    got = sync_kernel.sync_error_metric_plain(torch.as_tensor(ph))
    _assert_metric_close([t.numpy() for t in got], j_metric(ph))


@pytest.mark.parametrize("C,M", [(5, 4321), (2, 120)])
def test_plain_matches_pallas_interpret(C, M):
    ph = _phases(C, M, seed=7 + M)
    got = sync_kernel.sync_error_metric_plain(torch.as_tensor(ph))
    _assert_metric_close([t.numpy() for t in got],
                         sync_error_metric_pallas(ph, interpret=True))


def test_wrapper_runs_plain_on_cpu_without_launching():
    ph = torch.as_tensor(_phases(4, 1000, seed=9))
    before = sync_kernel.launches
    e, f = sync_kernel.sync_error_metric(ph)
    e0, f0 = sync_kernel.sync_error_metric_plain(ph)
    assert sync_kernel.launches == before
    assert torch.equal(e, e0) and torch.equal(f, f0)


def test_cuda_entry_refuses_cpu_tensor():
    with pytest.raises(ValueError):
        sync_kernel.sync_error_metric_cuda(torch.zeros((2, 300)))
