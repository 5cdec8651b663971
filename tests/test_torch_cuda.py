"""PyTorch port on the card: kernel K1 and the CUDA paths.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so on the GPU machine it runs without
the JAX-side conftest:

    python -m pytest -o addopts= -p no:cacheprovider --noconftest \
        -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
from dumpvdl2_tpu_torch.dsp import sync_kernel
from dumpvdl2_tpu_torch.sim import frame_with_fcs, synthesize_iq_raw
from dumpvdl2_tpu_torch.utils import fetch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("C,M", [(5, 4321), (256, 2000), (3, 120),
                                 (1, 151), (7, 256 + 150)])
def test_k1_matches_plain(cuda, C, M):
    rng = np.random.default_rng(C * 10000 + M)
    ph = torch.as_tensor(rng.uniform(-np.pi, np.pi, (C, M))
                         .astype(np.float32), device=cuda)
    before = sync_kernel.launches
    e1, f1 = sync_kernel.sync_error_metric(ph)
    assert sync_kernel.launches == before + 1
    e0, f0 = sync_kernel.sync_error_metric_plain(ph)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(e1), torch.isinf(e0))
    fin = ~torch.isinf(e0)
    if fin.any():
        assert (e1[fin] - e0[fin]).abs().max().item() < 1e-3
    assert (f1 - f0).abs().max().item() < 1e-5


def test_k1_rejects_bad_input(cuda):
    with pytest.raises(ValueError):
        sync_kernel.sync_error_metric_cuda(
            torch.zeros((2, 400), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        sync_kernel.sync_error_metric_cuda(
            torch.zeros((400, 2), device=cuda).T)


def test_coalesced_get_round_trip(cuda):
    tree = ({"ok": torch.tensor([True, False], device=cuda),
             "x": torch.arange(6, dtype=torch.int32, device=cuda)
             .reshape(2, 3), "none": None},
            torch.linspace(0, 1, 5, device=cuda).to(torch.float16))
    out = fetch.coalesced_get(tree)
    assert out[0]["none"] is None and out[0]["ok"].dtype == np.bool_
    np.testing.assert_array_equal(out[0]["x"], tree[0]["x"].cpu().numpy())
    np.testing.assert_array_equal(out[1], tree[1].cpu().numpy())


def test_pipeline_on_card_matches_cpu(cuda):
    os_ = 10
    fs = 105000 * os_
    center = 136975000
    freqs = [center, center - 25000]
    rng = np.random.default_rng(4)
    sig = ((rng.standard_normal(700_000) + 1j * rng.standard_normal(
        700_000)) * 0.007).astype(np.complex64)
    payloads = [b"card vs cpu burst one", b"card vs cpu burst two"]
    for k, (p, f) in enumerate(zip(payloads, freqs)):
        b = synthesize_iq_raw([p], oversample=os_,
                              carrier_offset_hz=f - center, seed=k)
        sig[100_000 + 300_000 * k:][:b.size] += b * 0.5
    out = []
    for dev in ("cpu", "cuda"):
        pipe = VDL2Pipeline(freqs, center, fs, os_, device=dev)
        out.append(pipe.feed(sig[:400_000]) + pipe.feed(sig[400_000:],
                                                        eof=True))
    cpu, gpu = ([(bytes(f.frame), f.metadata.freq) for f in o] for o in out)
    assert gpu == cpu
    for p, f in zip(payloads, freqs):
        assert (frame_with_fcs(p), f) in gpu
