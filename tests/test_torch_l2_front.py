"""PyTorch port: the sliced L2 step's front, L2H ``l2_front``
(core/pipeline.py's wrapper and plain version, fec/l2_kernel.py's
``l2_front_cuda``, csrc/l2.cu) -- slot compaction, window slicing at
the symbol clock, D8PSK decisions, the burst header and the frame
power in one kernel -- and L2P's hdr-ok compaction prologue
(``l2_payload_capped``).

* The plain front and L2P (``core/pipeline.py::l2_sliced``) against
  the JAX ``_launch_sliced_l2`` (``_l2_sliced_impl``) on block planes
  whose symbol-clock phases carry synthesized bursts: fewer valid slots
  than the cap, more valid slots than the cap, every slot within the cap
  (no compaction), sync points near the block end (zero padding), empty
  slots at ``sp = -1`` and at arbitrary positions, and more accepted
  headers than L2P's cap (overflow).  Every integer and byte equal;
  ``frame_pwr`` within rtol 1e-6 (its sum runs in another order).
* The EOF batch (``flush=True``) decodes every candidate as
  ``launch_compacted_l2`` does on the fully sliced candidates, and
  ``launch_compacted_l2`` (the mesh's L2 step, L2P behind the same
  compaction) decodes every candidate as the JAX
  ``_launch_compacted_l2`` does.
* A numpy model of the kernels' indexing (the front's compaction ranks
  from per-channel prefix sums, its inverse map, the windows' indices,
  L2P's rank of a row in the hdr-ok order and its ``blocks_row``, the
  frame power in float64) against the plain versions, and the source's
  constants against the Python ones.
* The wrappers on CPU tensors run the plain versions and launch
  nothing; the CUDA entries refuse CPU tensors.

The tests marked ``cuda`` hold the kernels against their plain versions
on the card (integers and bytes exact, ``frame_pwr`` within rtol 1e-6)
and skip without one; on the GPU machine the file runs as

    python -m pytest -o addopts= -p no:cacheprovider --noconftest \\
        -m cuda tests/test_torch_l2_front.py
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu_torch import burst, sim
from dumpvdl2_tpu_torch.constants import ARITY, GRAYCODE, HEADER_LEN, SPS
from dumpvdl2_tpu_torch.core import pipeline
from dumpvdl2_tpu_torch.dsp import demod as tdm
from dumpvdl2_tpu_torch.fec import l2 as l2_step
from dumpvdl2_tpu_torch.fec import l2_kernel

S = 5616                # MAX_BURST_SYMS
REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = REPO / "dumpvdl2_tpu_torch" / "csrc" / "l2.cu"
INV_GRAY = np.argsort(np.array(GRAYCODE))
RTOL_PWR = 1e-6


def _scene(C: int, K: int, M: int, counts, seed: int, planted,
           near_end: int = 0, odd_empty: int = 0, clean: bool = False
           ) -> tuple:
    """Block planes and detections: random phases, with a burst of
    ``sim.l2_fuzz`` (with ``clean``, an undamaged burst of random
    octets) at the symbol clock of each ``planted`` (c, sp);
    slot k = 0 of such a channel points there, other valid slots at
    random points (``near_end`` of them within a window of M), empty
    slots at -1 (``odd_empty`` of them anywhere) with one frequency a
    channel, as the detector leaves them (a burst at sp <= 0 has it, so
    they read it too).  Returns numpy ``(phases, pwr, count, sync_idx,
    dphi)``."""
    rng = np.random.default_rng(seed)
    phases = rng.uniform(-np.pi, np.pi, (C, M)).astype(np.float32)
    pwr = rng.uniform(0.5, 1.6, (C, M)).astype(np.float32)
    count = np.asarray(counts, np.int32)
    sync = np.full((C, K), -1, np.int32)
    dphi = rng.normal(0, 0.05, (C, K)).astype(np.float32)
    for c in range(C):
        n = min(int(count[c]), K)
        sync[c, :n] = rng.integers(0, M, n)
        dphi[c, max(n, 0):] = dphi[c, -1]
    for c, k in zip(rng.integers(0, C, near_end), rng.integers(0, K,
                                                               near_end)):
        sync[c, k] = M - rng.integers(1, SPS * S // 2)
    for c, k in zip(rng.integers(0, C, odd_empty), rng.integers(0, K,
                                                                odd_empty)):
        if k >= count[c]:
            sync[c, k] = rng.integers(-50, M + 50)
    rows = [sim.bits_to_symbol_row(sim.build_burst_bits(
        [bytes(rng.integers(0, 256, 40 + 97 * i, dtype=np.uint8))]), S, rng)
        for i in range(len(planted))] if clean \
        else sim.l2_fuzz(len(planted), seed=seed + 1)
    for (c, sp), row in zip(planted, rows):
        sync[c, 0] = sp
        start = min(max(sp, 0), M)
        d = dphi[c, -1] if sp <= 0 else dphi[c, 0]
        dphi[c, 0] = d
        steps = (INV_GRAY[row].astype(np.float64) * (np.pi / 4) + d)
        ph = np.angle(np.exp(1j * (rng.uniform(-np.pi, np.pi)
                                   + np.concatenate([[0.0],
                                                     np.cumsum(steps)]))))
        idx = start + SPS * np.arange(S + 1)
        inside = idx < M
        phases[c, idx[inside]] = ph[inside].astype(np.float32)
    return phases, pwr, count, sync, dphi


SCENES = {
    # fewer valid slots than the cap (140 of 512 slots, cap 256)
    "fewer_than_cap": lambda: _scene(
        8, 64, 60000, [1, 3, 0, 70, 2, 1, 64, 5], 31,
        [(0, 100), (1, 37), (3, 2000), (4, 3000), (5, 0), (6, 1234),
         (7, 3500)], near_end=6, odd_empty=20),
    # more valid slots than the cap: valid slots past it overflow
    "more_than_cap": lambda: _scene(
        8, 64, 60000, [64, 64, 64, 64, 40, 64, 64, 64], 32,
        [(0, 10), (2, 600), (5, 3800)], near_end=10),
    # bursts at sp = 0: the empty slots (-1 -> 0) of three channels read
    # them too, and more headers pass than L2P's cap of 128 rows
    "l2p_overflow": lambda: _scene(
        8, 64, 60000, [1, 1, 1, 0, 0, 2, 0, 0], 33,
        [(0, 0), (1, 0), (2, 0)], clean=True),
    # every slot within the cap: no compaction, no L2P cap
    "all_fit": lambda: _scene(2, 8, 58000, [3, 8], 34,
                              [(0, 50), (1, 400)], near_end=2),
}


@pytest.fixture(scope="module")
def scenes():
    return {name: make() for name, make in SCENES.items()}


def _torch(scene, device=None) -> tuple:
    return tuple(torch.as_tensor(x, device=device) for x in scene)


def _sliced(scene, device=None, flush=False):
    phases, pwr, count, sync, dphi = _torch(scene, device)
    return pipeline.l2_sliced(phases, pwr, count, sync, dphi,
                              sync.shape[1], S, flush)


def _assert_l2_equal(got: dict, want: dict, label: str) -> None:
    """Every field equal, frame_pwr within RTOL_PWR."""
    assert set(got) == set(want), label
    for key, w in want.items():
        g = got[key]
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.shape == w.shape, (label, key)
        if key == "frame_pwr":
            np.testing.assert_allclose(g, w, rtol=RTOL_PWR, atol=0,
                                       err_msg=f"{label} {key}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {key}")
            assert g.dtype == w.dtype, (label, key)


@pytest.mark.parametrize("name", list(SCENES))
def test_sliced_plain_matches_jax(scenes, name):
    from dumpvdl2_tpu.core import pipeline as jpl
    from dumpvdl2_tpu.dsp.demod import Detections as JDets
    phases, pwr, count, sync, dphi = scenes[name]
    K = sync.shape[1]
    z = np.zeros_like(sync)
    want, want_inv = jpl._launch_sliced_l2(
        phases, pwr, JDets(count=count, det_idx=z, sync_idx=sync, dphi=dphi,
                           pherr=dphi, sym_valid=z), K)
    got, inv = _sliced(scenes[name])
    _assert_l2_equal(got, want, name)
    if want_inv is None:
        assert inv is None
    else:
        np.testing.assert_array_equal(inv.numpy(), np.asarray(want_inv))


def test_scenes_reach_their_cases(scenes):
    """Each scene does what it is named for."""
    res = {}
    for name, sc in scenes.items():
        l2, inv = _sliced(sc)
        res[name] = (l2, inv)
    l2, inv = res["fewer_than_cap"]
    assert inv is not None and (inv >= 0).sum() == 256
    assert int(l2["hdr_ok"].sum()) >= 5
    l2, inv = res["more_than_cap"]
    valid = (np.arange(64)[None, :] < scenes["more_than_cap"][2][:, None])
    assert (inv.numpy().reshape(8, 64)[valid] < 0).any()
    l2, _ = res["l2p_overflow"]
    assert int(l2["hdr_ok"].sum()) > 128
    assert (l2["blocks_row"] < 0).any() and l2["blocks"].shape[0] == 128
    l2, inv = res["all_fit"]
    assert inv is None and "blocks_row" not in l2
    # a planted burst decodes: the front's symbols are the burst's
    l2, inv = res["fewer_than_cap"]
    row = int(inv[0])
    assert burst._result_from_batch(
        {k: v.numpy() for k, v in l2.items()}, row).ok


def _summary(res) -> tuple:
    return (res.ok, res.reason, res.datalen, res.datalen_octets,
            res.syndrome, res.synd_weight, res.num_fec_corrections,
            res.blocks_processed, res.blocks_fec_ok, res.bits_consumed,
            [bytes(f) for f in res.frames])


def _full_slices(scene) -> tuple:
    """Every slot's window demodulated, (C, K, S) symbols and power, as
    the mesh's find_and_slice gives them."""
    phases, pwr, count, sync, dphi = _torch(scene)
    C, K = sync.shape
    rows = torch.arange(C).repeat_interleave(K)
    starts = sync.reshape(-1)
    sym_phase = tdm.slice_windows(phases, rows, starts, S + 1)
    power_all = tdm.slice_windows(pwr, rows, starts, S + 1)
    symbols, power = tdm.demod_window(sym_phase, power_all, dphi.reshape(-1))
    return symbols.reshape(C, K, S), power.reshape(C, K, S)


@pytest.mark.parametrize("name", list(SCENES))
def test_launch_compacted_matches_jax(scenes, name):
    """launch_compacted_l2 (L2P behind the hdr-ok compaction) against
    the JAX _launch_compacted_l2 (the full batch decoded, then its blocks
    compacted) on the same fully sliced candidates: the slot map and
    every header field equal, frame_pwr within RTOL_PWR, and each valid
    slot's burst decoding to the same result through each package's
    result assembly."""
    from dumpvdl2_tpu import burst as jburst
    from dumpvdl2_tpu.core import pipeline as jpl
    count = scenes[name][2]
    K = scenes[name][3].shape[1]
    symbols, power = _full_slices(scenes[name])
    got, inv = pipeline.launch_compacted_l2(symbols, power,
                                            torch.as_tensor(count), K)
    want, want_inv = jpl._launch_compacted_l2(symbols.numpy(),
                                              power.numpy(), count, K)
    assert (inv is None) == (want_inv is None)
    if inv is not None:
        np.testing.assert_array_equal(inv.numpy(), np.asarray(want_inv))
    got_np = {k: v.numpy() for k, v in got.items()}
    want_np = {k: np.asarray(v) for k, v in want.items()}
    assert set(got_np) == set(want_np)
    for key in (*l2_kernel.HDR_INT[:-1], *l2_kernel.HDR_BOOL):
        np.testing.assert_array_equal(got_np[key], want_np[key], key)
    np.testing.assert_allclose(got_np["frame_pwr"], want_np["frame_pwr"],
                               rtol=RTOL_PWR)
    if "blocks_row" in want_np:
        np.testing.assert_array_equal(got_np["blocks_row"],
                                      want_np["blocks_row"])
    C = count.shape[0]
    for c in range(C):
        for k in range(min(int(count[c]), K)):
            r = c * K + k if inv is None else int(inv[c * K + k])
            if r < 0:
                continue
            assert _summary(burst._result_from_batch(got_np, r)) == \
                _summary(jburst._result_from_batch(want_np, r)), (c, k)


@pytest.mark.parametrize("name", list(SCENES))
def test_flush_batch_matches_launch_compacted(scenes, name):
    """The EOF batch through the front equals launch_compacted_l2 on
    the fully sliced candidates (what the JAX package's flush runs), on
    every valid slot's burst and its frame power."""
    count = _torch(scenes[name])[2]
    K = scenes[name][3].shape[1]
    C = count.shape[0]
    symbols, power = _full_slices(scenes[name])
    want, want_inv = pipeline.launch_compacted_l2(symbols, power, count, K)
    got, inv = _sliced(scenes[name], flush=True)
    if want_inv is None:
        assert inv is None
    else:
        assert torch.equal(inv, want_inv)
    want_np = {k: v.numpy() for k, v in want.items()}
    got_np = {k: v.numpy() for k, v in got.items()}
    for c in range(C):
        for k in range(min(int(count[c]), K)):
            r = c * K + k if inv is None else int(inv[c * K + k])
            if r < 0:
                continue
            assert _summary(burst._result_from_batch(got_np, r)) == \
                _summary(burst._result_from_batch(want_np, r)), (c, k)
            np.testing.assert_allclose(got_np["frame_pwr"][r],
                                       want_np["frame_pwr"][r],
                                       rtol=RTOL_PWR)


# ------------------------------------------------------ the kernels' model
def _cu(name: str, kind: str = "int"):
    m = re.search(rf"constexpr {kind} {name} = ([^;]+);",
                  SOURCE.read_text())
    expr = m.group(1).strip()
    if kind == "float":
        return np.float32(float(expr.rstrip("f")))
    for other in re.findall(r"k[A-Z]\w*", expr):
        expr = expr.replace(other, str(_cu(other)))
    return int(eval(expr.replace("/", "//")))


def test_source_constants():
    assert _cu("kFrontWin") == l2_kernel.FRONT_WIN
    assert _cu("kSps") == SPS and _cu("kArity") == ARITY
    assert 3 * _cu("kHeaderSyms") >= HEADER_LEN
    assert _cu("kTwoPi", "float") == np.float32(tdm._TWO_PI)
    assert _cu("kQuarterPi", "float") == np.float32(tdm._QUARTER_PI)
    assert np.float32(tdm._QUARTER_PI) == np.float32(np.pi / 4)


def _front_model(count: np.ndarray, K: int) -> tuple:
    """The front's compaction as its CTAs compute it: per-channel valid
    counts vc, their prefix pv and the empty slots before pi = c K - pv;
    row r < nv is valid slot r - pv of its channel, row r >= nv empty
    slot vc + (r - nv - pi); inv from the same prefix sums."""
    C = count.shape[0]
    total = C * K
    cap = l2_kernel.slot_cap(C, K)
    if cap >= total:
        return np.arange(total), None
    vc = np.clip(count, 0, K)
    pv = np.concatenate([[0], np.cumsum(vc)[:-1]])
    nv = int(vc.sum())
    pi = np.arange(C) * K - pv
    take = np.zeros(cap, np.int64)
    for r in range(cap):
        if r < nv:
            c = int(np.nonzero((pv <= r) & (r < pv + vc))[0][0])
            take[r] = c * K + r - pv[c]
        else:
            q = r - nv
            c = int(np.nonzero((pi <= q) & (q < pi + K - vc))[0][0])
            take[r] = c * K + vc[c] + q - pi[c]
    inv = np.zeros(total, np.int32)
    for c in range(C):
        for k in range(K):
            p = pv[c] + k if k < vc[c] else nv + pi[c] + k - vc[c]
            inv[c * K + k] = p if p < cap else -1
    return take, inv


@pytest.mark.parametrize("counts,K", [
    ([1, 3, 0, 70, 2, 1, 64, 5], 64), ([64] * 8, 64), ([0] * 8, 64),
    ([5, -3, 100, 0], 128), ([3, 8], 8), ([9] * 70, 16)])
def test_front_compaction_model(counts, K):
    count = np.asarray(counts, np.int32)
    take, inv = pipeline._slot_compaction(torch.as_tensor(count), K)
    m_take, m_inv = _front_model(count, K)
    np.testing.assert_array_equal(take.numpy(), m_take)
    if m_inv is None:
        assert inv is None
    else:
        np.testing.assert_array_equal(inv.numpy(), m_inv)


@pytest.mark.parametrize("B,cap,seed", [(256, 128, 1), (300, 75, 2),
                                        (1024, 256, 3), (200, 199, 4)])
def test_payload_prologue_model(B, cap, seed):
    """L2P's prologue: row i's position in the hdr-ok order is its rank
    among accepted rows, or n_ok plus its rank among rejected ones; CTA
    bp takes the row at position bp and writes blocks_row[i] for i ==
    bp (mod cap)."""
    ok = np.random.default_rng(seed).random(B) < 0.4
    okb = np.concatenate([[0], np.cumsum(ok)[:-1]])
    pos = np.where(ok, okb, ok.sum() + np.arange(B) - okb)
    rows = np.zeros(cap, np.int64)
    blocks_row = np.full(B, 7, np.int32)
    for bp in range(cap):
        rows[bp] = np.nonzero(pos == bp)[0][0]
        mine = np.arange(bp, B, cap)
        blocks_row[mine] = np.where(pos[mine] < cap, pos[mine], -1)
    sel, inv = l2_kernel.compact_rows(torch.as_tensor(ok), cap)
    np.testing.assert_array_equal(rows, sel.numpy())
    np.testing.assert_array_equal(blocks_row, inv.numpy())


@pytest.mark.parametrize("name", list(SCENES))
def test_window_and_power_model(scenes, name):
    """The front's window indices start + SPS j (start = clip(sp, 0, M),
    zero past M) and its float64 frame-power sum over s < ceil(bits /
    3) against the plain versions."""
    phases, pwr, count, sync, dphi = scenes[name]
    C, M = phases.shape
    K = sync.shape[1]
    front = pipeline.l2_front_plain(*_torch(scenes[name]), K, S)
    take = front["take"].numpy()
    for r in np.random.default_rng(5).choice(take.shape[0], 24):
        slot = int(take[r])
        c, start = slot // K, min(max(int(sync.reshape(-1)[slot]), 0), M)
        idx = start + SPS * np.arange(S + 1)
        ph = np.where(idx < M, phases[c, np.minimum(idx, M - 1)], 0)
        d = (ph[1:] - ph[:-1]) - dphi.reshape(-1)[slot]
        d = np.where(d < 0, d + np.float32(tdm._TWO_PI), d)
        d = np.where(d > tdm._TWO_PI, d - np.float32(tdm._TWO_PI), d)
        q = np.rint(d / np.float32(tdm._QUARTER_PI)).astype(np.int64)
        np.testing.assert_array_equal(np.array(GRAYCODE)[q % ARITY],
                                      front["symbols"][r].numpy())
        if front["hdr_ok"][r]:
            n = max(-(-int(front["bits_consumed"][r]) // 3), 1)
            pw = np.where(idx[1:n + 1] < M,
                          pwr[c, np.minimum(idx[1:n + 1], M - 1)], 0)
            np.testing.assert_allclose(
                np.float32(pw.astype(np.float64).sum()) / np.float32(n),
                front["frame_pwr"][r].item(), rtol=RTOL_PWR)
        else:
            assert front["frame_pwr"][r].item() == 0.0


# ------------------------------------------------------------- wrappers
def test_sliced_on_cpu_runs_plain(scenes, monkeypatch):
    calls = []
    for mod, name in ((pipeline, "l2_front"), (pipeline, "l2_front_plain"),
                      (l2_step, "l2_payload_capped"),
                      (l2_kernel, "l2_payload_capped_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn:
                            calls.append(_n) or _f(*a))
    before = dict(l2_kernel.launches)
    phases, pwr, count, sync, dphi = _torch(scenes["fewer_than_cap"])
    pipeline.l2_sliced(phases, pwr, count, sync, dphi, sync.shape[1], S)
    assert calls == ["l2_front", "l2_front_plain", "l2_payload_capped",
                     "l2_payload_capped_plain"]
    assert l2_kernel.launches == before


def test_cuda_entries_refuse_cpu_tensors(scenes):
    phases, pwr, count, sync, dphi = _torch(scenes["all_fit"])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        l2_kernel.l2_front_cuda(phases, pwr, count, sync, dphi, 8, S)
    sym = torch.as_tensor(sim.l2_fuzz(4, seed=3))
    hdr = l2_kernel.l2_header_plain(sym)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        l2_kernel.l2_payload_capped_cuda(
            sym, 2, hdr["hdr_ok"], hdr["num_blocks"], hdr["last_len"],
            hdr["lf"], hdr["datalen_octets"])


# ------------------------------------------------------------ on the card
def _chip_smoke():
    """chip_smoke.py as a module: its front comparison."""
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
@pytest.mark.parametrize("name", list(SCENES))
def test_front_kernel_matches_plain(cuda, scenes, name):
    phases, pwr, count, sync, dphi = _torch(scenes[name], cuda)
    _chip_smoke().compare_front((phases, pwr, count, sync, dphi,
                                 sync.shape[1], S), name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("flush", [False, True])
def test_sliced_step_on_card_matches_cpu(cuda, scenes, name, flush):
    got, inv = _sliced(scenes[name], cuda, flush)
    want, want_inv = _sliced(scenes[name], None, flush)
    _assert_l2_equal(got, {k: v.numpy() for k, v in want.items()}, name)
    assert (inv is None) == (want_inv is None)
    if inv is not None:
        assert torch.equal(inv.cpu(), want_inv)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 9, 96, 383])
def test_payload_capped_kernel_matches_plain(cuda, cap):
    sym = torch.as_tensor(sim.l2_fuzz(384, seed=22), device=cuda)
    hdr = l2_kernel.l2_header_plain(sym)
    args = (sym, cap, hdr["hdr_ok"], hdr["num_blocks"], hdr["last_len"],
            hdr["lf"], hdr["datalen_octets"])
    got = l2_kernel.l2_payload_capped_cuda(*args)
    want = l2_kernel.l2_payload_capped_plain(*args)
    for name, a, b in zip(("table", "counts", "fec_row", "blocks_row"),
                          got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.cuda
def test_front_rejects_bad_input(cuda, scenes):
    phases, pwr, count, sync, dphi = _torch(scenes["all_fit"], cuda)
    with pytest.raises(ValueError):
        l2_kernel.l2_front_cuda(phases, pwr, count, sync, dphi, 8, 100)
    with pytest.raises(ValueError):
        l2_kernel.l2_front_cuda(phases, pwr, count.long(), sync, dphi, 8, S)
    with pytest.raises(ValueError):
        l2_kernel.l2_front_cuda(phases, pwr[:1].contiguous(), count, sync,
                                dphi, 8, S)
