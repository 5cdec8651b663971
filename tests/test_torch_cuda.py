"""PyTorch port on the card: kernels K1, G1 and G2 (nf_track) and the
CUDA paths.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so on the GPU machine it runs without
the JAX-side conftest:

    python -m pytest -o addopts= -p no:cacheprovider --noconftest \
        -m cuda tests/test_torch_cuda.py
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dumpvdl2_tpu_torch.core import gate_kernel
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


# Ragged shapes for K1's tiling (2720 outputs a tile): rows of every
# length mod 4, the first output at n = 150, one and two tiles plus one
# output, and more channels than a grid dimension holds.
@pytest.mark.parametrize("C,M", [(5, 4321), (256, 2000), (3, 120),
                                 (1, 151), (7, 256 + 150), (1, 150),
                                 (1, 2198), (1, 2199), (1, 2721),
                                 (2, 2870), (2, 2871), (3, 5441),
                                 (70000, 200)])
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


def _chip_smoke():
    """chip_smoke.py as a module: its G1/G2 input grids and checks."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("C,K,kw", [
    (256, 64, {}), (1, 1, {}), (300, 8, {"B": 1}), (129, 64, {"no_rows": True}),
    (256, 64, {"base": 2**31 - 900}), (64, 64, {"negative_bits": True})])
@pytest.mark.parametrize("eof,max_ppm", [(False, 5.0), (True, 0.0)])
def test_g1_matches_plain(cuda, C, K, kw, eof, max_ppm):
    """Verdicts, gate state, bits and the hold decisions with the
    tracker's bounds: all equal to the plain version's."""
    smoke = _chip_smoke()
    args = smoke.gate_grid(C, K, C * 7 + K, **kw)
    before = gate_kernel.launches["gate"]
    gate_kernel.gate(*args, max_ppm, eof, 52428)
    assert gate_kernel.launches["gate"] == before + 1
    smoke.compare_g1(args, max_ppm, eof, 52428, f"{(C, K)} {kw}")


@pytest.mark.parametrize("C,W,K,R,kw", [
    (256, 17476, 64, 32768, {}),
    (256, 17476, 64, 32768, {"replay": 0.6}),
    (256, 17476, 64, 32768, {"persist": 0.5, "replay": 0.3}),
    (256, 0, 64, 32768, {"replay": 0.7}),
    (256, 300, 64, 512, {"nfcnt_max": 400}),
    (64, 9000, 64, 4096, {"negative_bits": True, "replay": 0.5}),
    (1, 1, 1, 1, {"replay": 1.0}),
    (3, 9000, 300, 9000, {"replay": 1.0})])
def test_g2_matches_plain(cuda, C, W, K, R, kw):
    """nf_track: the count and the crossing columns equal the plain
    version's, the floats within rtol 1e-5, atol 1e-7."""
    smoke = _chip_smoke()
    args = smoke.track_args(smoke.track_grid(C, W, K, R, C + W + K, **kw),
                            cuda)
    before = gate_kernel.launches["nf_track"]
    gate_kernel.nf_track(*args)
    assert gate_kernel.launches["nf_track"] == before + 1
    smoke.compare_track(args, f"{(C, W, K, R)} {kw}")


def test_gate_wrappers_reject_bad_input(cuda):
    smoke = _chip_smoke()
    args = list(smoke.gate_grid(4, 8, 0))
    args[1] = args[1].to(torch.int64)
    with pytest.raises(ValueError):
        gate_kernel.gate_cuda(*args, 0.0, False, 0)
    targs = list(smoke.track_args(smoke.track_grid(4, 30, 3, 8, 0), cuda))
    targs[0] = targs[0].double()
    with pytest.raises(ValueError):
        gate_kernel.nf_track_cuda(*targs)


@pytest.mark.parametrize("device_gate", [True, False])
def test_pipeline_modes_on_card_match_cpu(cuda, device_gate):
    """A short run of each gating mode on the card against the CPU; the
    gated one launches K1, G1 and G2."""
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
    before = dict(gate_kernel.launches)
    for dev in ("cpu", "cuda"):
        pipe = VDL2Pipeline(freqs, center, fs, os_, device=dev,
                            device_gate=device_gate)
        out.append(pipe.feed(sig[:400_000]) + pipe.feed(sig[400_000:],
                                                        eof=True))
    cpu, gpu = out
    assert [(bytes(f.frame), f.metadata.freq) for f in gpu] == \
        [(bytes(f.frame), f.metadata.freq) for f in cpu]
    for a, b in zip(gpu, cpu):
        assert abs(a.metadata.nf_pwr_dbfs - b.metadata.nf_pwr_dbfs) < 1e-4
    for p, f in zip(payloads, freqs):
        assert (frame_with_fcs(p), f) in \
            [(bytes(g.frame), g.metadata.freq) for g in gpu]
    launched = {k: gate_kernel.launches[k] - before[k] for k in before}
    assert launched == ({"gate": 3, "nf_track": 3} if device_gate
                        else {"gate": 0, "nf_track": 0}), launched


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
