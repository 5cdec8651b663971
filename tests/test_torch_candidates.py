"""PyTorch port: KC ``candidates`` (dsp/candidates_kernel.py,
csrc/candidates.cu), the detector's candidate search after the sync
metric.

* ``candidates_plain`` against the JAX ``find_candidates_impl`` (its
  metric replaced by the same ``(err, freq)``), on adversarial metric
  planes: more leaders than K, clusters that straddle a 128-sample
  segment and the kernel's 8 192-sample tile edge, ``detect_lo`` and
  ``detect_hi`` inside a cluster, ``M <= LOOKBACK + 2``, detections
  near the block end (symbol counts clipped) and the K1 planes' +inf
  head.
* A numpy model of the kernel's decomposition (tiles of 8 192 samples,
  a 32-bit crossing word a thread, the word before it carried across
  threads and tiles, the 20-sample window as shifted ORs of the 64-bit
  pair, a block scan of the words' population counts for the ranks)
  against the plain version, and the source's constants against the
  Python ones.
* The wrapper on CPU tensors runs the plain version and launches
  nothing; ``candidates_cuda`` refuses CPU tensors.

No tolerance: every field is an integer or a float gathered from the
inputs or computed in the plain version's order.  The tests marked
``cuda`` hold the kernel against its plain version on the card and
skip without one; the JAX package is imported inside the CPU tests, so
on the GPU machine the file runs as

    python -m pytest -o addopts= -p no:cacheprovider --noconftest \\
        -m cuda tests/test_torch_candidates.py
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu_torch.constants import SPS
from dumpvdl2_tpu_torch.dsp import candidates_kernel as ck
from dumpvdl2_tpu_torch.dsp import demod as tdm
from dumpvdl2_tpu_torch.dsp.sync_kernel import LOOKBACK

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = REPO / "dumpvdl2_tpu_torch" / "csrc" / "candidates.cu"
THR = 4.0
FIELDS = ("count", "det_idx", "sync_idx", "dphi", "pherr", "sym_valid")


def _plane(C: int, M: int, seed: int, lo: float = 0.0, hi: float = 8.0
           ) -> tuple[np.ndarray, np.ndarray]:
    """Random (err, freq) planes with K1's +inf / 0 head: uniform err
    in [lo, hi) crosses the threshold every few samples."""
    rng = np.random.default_rng(seed)
    err = rng.uniform(lo, hi, (C, M)).astype(np.float32)
    err[:, :min(LOOKBACK, M)] = np.inf
    freq = rng.normal(0, 0.05, (C, M)).astype(np.float32)
    freq[:, :min(LOOKBACK, M)] = 0.0
    return err, freq


def _sparse(C: int, M: int, seed: int, rate: float
            ) -> tuple[np.ndarray, np.ndarray]:
    """Quiet planes (err above the threshold) with a dip below it at a
    ``rate`` of the samples: isolated crossings, clusters and chains."""
    err, freq = _plane(C, M, seed, 4.5, 9.0)
    rng = np.random.default_rng(seed + 1000)
    hit = rng.random((C, M)) < rate
    hit[:, :LOOKBACK] = False
    err[hit] = rng.uniform(0.0, 4.0, int(hit.sum())).astype(np.float32)
    return err, freq


def _dip(err: np.ndarray, c: int, p: int, low: float = 1.0,
         rise: float = 4.25) -> None:
    """A crossing at sample p of row c: err[p-1] below the threshold,
    err[p] above it (and above the threshold, so p + 1 is none)."""
    err[c, p - 1] = low
    err[c, p] = rise


def _planted(M: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Quiet rows (err above the threshold) with planted crossings:
    clusters across the 128-sample segment edges and the 8 192-sample
    tile edges, a run of more leaders than K, one exactly 20 and 21
    samples after another, detections near M."""
    err, freq = _plane(4, M, seed, 5.0, 9.0)
    for p in (254, 257, 383, 385, 8189, 8193, 8200, 8212, 16381, 16385,
              16406):
        if p < M:
            _dip(err, 0, p)
    for p in range(300, M - 40, 23):                  # leaders every 23
        _dip(err, 1, p)
    for p in (400, 420, 600, 621, 900, 919):          # 20 and 21 apart
        _dip(err, 2, p)
    for p in (M - 1, M - 12, M - 37, M - 200):       # near the end
        _dip(err, 3, p, low=0.5)
    return err, freq


CASES = {
    # name: (err/freq maker, K, S, detect_lo, detect_hi)
    "noise": (lambda: _plane(3, 3000, 1), 8, 64, 0, None),
    "sparse": (lambda: _sparse(3, 9000, 15, 0.04), 8, 64, 0, None),
    "sparse_many_K": (lambda: _sparse(2, 9000, 2, 0.02), 100, 5616, 0,
                      None),
    "planted": (lambda: _planted(17000, 3), 16, 256, 0, None),
    "planted_tiles": (lambda: _planted(24600, 4), 64, 5616, 0, None),
    "lo_hi_in_cluster": (lambda: _planted(17000, 5), 16, 256, 8191, 16390),
    "lo_hi_sparse": (lambda: _sparse(2, 5000, 6, 0.04), 8, 512, 1234, 4321),
    "hi_negative": (lambda: _sparse(2, 3000, 7, 0.04), 8, 64, 0, -500),
    "hi_past_end": (lambda: _sparse(2, 3000, 8, 0.04), 8, 64, 2900, 5000),
    "lo_past_end": (lambda: _sparse(2, 3000, 9, 0.04), 8, 64, 3500, None),
    "M_152": (lambda: _plane(2, 152, 10), 4, 16, 0, None),
    "M_153": (lambda: _plane(2, 153, 11), 4, 16, 0, None),
    "M_100": (lambda: _plane(2, 100, 12), 4, 16, 0, None),
    "K_0": (lambda: _plane(2, 800, 13), 0, 16, 0, None),
}


@pytest.fixture(scope="module")
def planes():
    return {name: case[0]() for name, case in CASES.items()}


def _plain(planes, name, device=None):
    err, freq = planes[name]
    _, K, S, lo, hi = CASES[name]
    return ck.candidates_plain(torch.as_tensor(err, device=device),
                               torch.as_tensor(freq, device=device),
                               THR, K, S, lo, hi)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][1] > 0])
def test_candidates_plain_matches_jax(planes, name, monkeypatch):
    import jax.numpy as jnp

    from dumpvdl2_tpu.dsp import demod as jdm
    err, freq = planes[name]
    _, K, S, lo, hi = CASES[name]
    monkeypatch.setattr(jdm, "_metric",
                        lambda ph: (jnp.asarray(err), jnp.asarray(freq)))
    want = jdm.find_candidates_impl(np.zeros_like(err), THR, K, S, lo, hi)
    got = _plain(planes, name)
    for key in FIELDS:
        g, w = getattr(got, key).numpy(), np.asarray(getattr(want, key))
        np.testing.assert_array_equal(g, w, err_msg=key)
        assert g.dtype == w.dtype, key


def test_cases_reach_their_edges(planes):
    """The adversarial planes do what they are named for."""
    got = {n: _plain(planes, n) for n in CASES}
    # dense noise is one chain of crossings: its first one leads
    assert (got["noise"].count == 1).all()
    assert (got["sparse"].count > 8).all()
    assert (got["sparse_many_K"].count.numpy() > 100).all()
    det = got["planted"].det_idx.numpy()
    # clusters across the segment edges 128, 256 and the tile edges
    # 8 192, 16 384: only their first crossings lead
    assert set(det[0][det[0] >= 0]) == {254, 383, 8189, 16381, 16406}
    assert int(got["planted"].count[1]) > 16
    # 20 samples after a crossing is inside its window, 21 is not
    assert set(det[2][det[2] >= 0]) == {400, 600, 621, 900}
    M = planes["planted"][0].shape[1]
    assert set(det[3][det[3] >= 0]) == {M - 200, M - 37, M - 12}
    sv = got["planted"].sym_valid.numpy()[3]
    assert sv[det[3] >= 0].min() <= 2 and sv.max() > 0
    lohi = set(got["lo_hi_in_cluster"].det_idx.numpy()[0])
    # 8189 is masked by lo = 8191, so 8193 leads; 16406 by hi = 16390
    assert {8193, 16381} <= lohi and not {8189, 8200, 16406} & lohi
    assert int(got["M_152"].count.sum()) == 0
    assert int(got["M_100"].count.sum()) == 0


# ------------------------------------------------------ the kernel's model
def _cu_int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);",
                  SOURCE.read_text())
    expr = m.group(1)
    for other in re.findall(r"k[A-Z]\w*", expr):
        expr = expr.replace(other, str(_cu_int(other)))
    return int(eval(expr))


def test_source_constants():
    assert _cu_int("kSps") == SPS
    assert _cu_int("kNmsWin") == ck._NMS_WIN
    assert _cu_int("kRun") == 32
    assert _cu_int("kTile") == _cu_int("kThreads") * _cu_int("kRun")
    assert ck._NMS_WIN < _cu_int("kRun")


def _model(err: np.ndarray, K: int, lo: int, hi: int) -> tuple:
    """KC's decomposition in numpy: (count, first K leaders) per row."""
    tile, run = _cu_int("kTile"), _cu_int("kRun")
    C, M = err.shape
    counts, dets = [], []
    for c in range(C):
        row = err[c]
        carry_e, carry_w = row[M - 1], 0      # the sample and word before
        found, det = 0, []
        for t0 in range(0, M, tile):
            e = np.zeros(tile, np.float32)
            n = min(tile, M - t0)
            e[:n] = row[t0:t0 + n]
            prev = np.concatenate([[carry_e], e[:-1]])
            g = t0 + np.arange(tile)
            hit = (g >= lo) & (g < hi) & (prev < THR) & (e > prev)
            bits = hit.reshape(-1, run).astype(np.uint64)
            words = (bits << np.arange(run, dtype=np.uint64)).sum(axis=1)
            before = np.concatenate([np.array([carry_w], np.uint64),
                                     words[:-1]])
            x = (words << np.uint64(32)) | before
            y1 = x << np.uint64(1)
            y2 = y1 | (y1 << np.uint64(1))
            y4 = y2 | (y2 << np.uint64(2))
            y8 = y4 | (y4 << np.uint64(4))
            y16 = y8 | (y8 << np.uint64(8))
            y20 = y16 | (y4 << np.uint64(16))
            lead = words & ~(y20 >> np.uint64(32)) & np.uint64(0xFFFFFFFF)
            pops = np.array([bin(int(w)).count("1") for w in lead])
            rank0 = found + np.concatenate([[0], np.cumsum(pops)[:-1]])
            for t in range(len(lead)):
                r = int(rank0[t])
                w = int(lead[t])
                while w and r < K:
                    k = (w & -w).bit_length() - 1
                    det.append(t0 + run * t + k)
                    r += 1
                    w &= w - 1
            found += int(pops.sum())
            carry_e, carry_w = e[-1], int(words[-1])
        counts.append(found)
        dets.append(sorted(det)[:K] + [-1] * (K - min(len(det), K)))
    return np.array(counts, np.int32), np.array(dets, np.int32).reshape(C, K)


@pytest.mark.parametrize("name", [n for n in CASES if n != "K_0"])
def test_kernel_model_matches_plain(planes, name):
    err, _ = planes[name]
    _, K, _, lo, hi = CASES[name]
    got = _plain(planes, name)
    counts, dets = _model(err, K, *ck.detect_window(err.shape[1], lo, hi))
    np.testing.assert_array_equal(counts, got.count.numpy())
    np.testing.assert_array_equal(dets, got.det_idx.numpy())


def test_detect_window_is_the_plain_mask():
    """detect_window gives the columns the plain slice assignments
    leave on, negative and out-of-range bounds included."""
    M = 400
    for lo, hi in ((0, None), (200, 300), (0, -50), (390, 500), (500, None),
                   (0, -600), (160, 10)):
        mask = np.ones(M, bool)
        mask[:max(LOOKBACK + 2, lo)] = False
        if hi is not None and hi < M:
            mask[hi:] = False
        a, b = ck.detect_window(M, lo, hi)
        want = np.zeros(M, bool)
        want[a:max(a, b)] = True
        np.testing.assert_array_equal(mask, want, err_msg=str((lo, hi)))


# ------------------------------------------------------------- wrappers
def test_candidates_on_cpu_runs_plain(planes, monkeypatch):
    calls = []
    fn = ck.candidates_plain
    monkeypatch.setattr(ck, "candidates_plain",
                        lambda *a: calls.append(1) or fn(*a))
    before = ck.launches
    ph = torch.as_tensor(np.random.default_rng(3).uniform(
        -np.pi, np.pi, (2, 900)).astype(np.float32))
    d = tdm.find_candidates(ph, THR, 8, 64)
    assert calls == [1] and ck.launches == before
    assert isinstance(d, tdm.Detections)


def test_candidates_cuda_refuses_cpu_tensors(planes):
    err, freq = (torch.as_tensor(x) for x in planes["noise"])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ck.candidates_cuda(err, freq, THR, 8, 64)


# ------------------------------------------------------------ on the card
def _chip_smoke():
    """chip_smoke.py as a module: its KC comparison."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_candidates_kernel_matches_plain(cuda, planes, name):
    err, freq = planes[name]
    _, K, S, lo, hi = CASES[name]
    _chip_smoke().compare_kc(
        (torch.as_tensor(err, device=cuda), torch.as_tensor(freq, device=cuda),
         THR, K, S, lo, hi), name)


@pytest.mark.cuda
def test_candidates_kernel_wideband_shape(cuda):
    err, freq = _plane(256, 108844, 14)
    _chip_smoke().compare_kc(
        (torch.as_tensor(err, device=cuda), torch.as_tensor(freq, device=cuda),
         THR, 64, 5616, 0, None), "random (256, 108844)")


@pytest.mark.cuda
def test_candidates_kernel_rejects_bad_input(cuda, planes):
    err, freq = (torch.as_tensor(x, device=cuda) for x in planes["noise"])
    with pytest.raises(ValueError):
        ck.candidates_cuda(err.double(), freq, THR, 8, 64)
    with pytest.raises(ValueError):
        ck.candidates_cuda(err, freq[:, :10].contiguous(), THR, 8, 64)
    with pytest.raises(ValueError):
        ck.candidates_cuda(err.t(), freq, THR, 8, 64)
