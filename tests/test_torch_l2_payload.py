"""PyTorch port: L2P ``l2_payload`` (fec/l2_kernel.py, csrc/l2.cu), the
fused payload stage of the L2 step -- octet packing, deinterleave and
RS(255,249) decode of each burst's table in one kernel.

* ``l2_payload_plain`` (with the burst cap ``l2_payload_capped_plain``,
  L2P behind the hdr-ok compaction) against the JAX
  ``l2_decode_batch``'s ``blocks``, ``counts``, ``fec_row`` and
  ``blocks_row``, exactly, with and without the burst cap,
  on ``sim.l2_fuzz`` bursts and on ``sim.l2_rs_fuzz`` bursts, whose RS
  rows carry the cases of ``sim.RS_FUZZ_CASES`` through the
  deinterleave (every count from -1 to 5).  A header's geometry gives a
  row 6, 4, 2 or 0 parity octets, at most 4 erasures, and no such row
  decodes to 6 roots; count 6 reaches L2P only through a caller's odd
  parity count, checked against JAX's ``rs_verify_batch``.
* A numpy model of the kernel's octet packing (the 12-bit window, the
  bit reversal, the PRBS octets) and of the octets it stages
  (``payload_octets``) against the plain version's octets and tables,
  and the kernel's constant-byte layout against the Python tables.
* The wrapper on a CPU tensor runs the plain version and launches
  nothing; ``l2_payload_cuda`` refuses CPU tensors.

No tolerance: every field is an integer or a byte.  The tests marked
``cuda`` hold the kernel against its plain version on the card and skip
without one.  The JAX package is imported inside the CPU tests, so that
on the GPU machine (no JAX) the file runs as

    python -m pytest -o addopts= -p no:cacheprovider --noconftest \\
        -m cuda tests/test_torch_l2_payload.py
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu_torch import constants, sim
from dumpvdl2_tpu_torch.fec import gf256, l2_kernel
from dumpvdl2_tpu_torch.fec import l2 as l2_step
from dumpvdl2_tpu_torch.fec.l2 import l2_decode_batch

S = 5616        # MAX_BURST_SYMS
REPO = pathlib.Path(__file__).resolve().parent.parent
FUZZ = {"l2_fuzz": lambda: sim.l2_fuzz(24, seed=31),
        "l2_rs_fuzz": lambda: sim.l2_rs_fuzz(30, seed=41)}


@pytest.fixture(scope="module")
def fuzz_sets():
    return {name: make() for name, make in FUZZ.items()}


def _args(syms, cap: int | None, device=None) -> tuple:
    """L2P's arguments as l2_decode_batch forms them: the symbols, the
    burst cap (None: every burst) and L2H's plain results."""
    sym = torch.as_tensor(syms, device=device)
    hdr = l2_kernel.l2_header_plain(sym)
    return (sym, cap, hdr["hdr_ok"], hdr["num_blocks"], hdr["last_len"],
            hdr["lf"], hdr["datalen_octets"])


def _payload_plain(args: tuple) -> tuple:
    """The plain L2P on ``_args``: ``l2_payload_plain`` on every burst,
    or behind the hdr-ok compaction ``l2_payload_capped_plain`` (its
    fourth result ``blocks_row``)."""
    sym, cap, *geom = args
    if cap is None:
        return l2_kernel.l2_payload_plain(sym, *geom)
    return l2_kernel.l2_payload_capped_plain(*args)


@pytest.mark.parametrize("cap", [None, 9])
@pytest.mark.parametrize("fuzz", list(FUZZ))
def test_l2_payload_plain_matches_jax(fuzz_sets, fuzz, cap):
    from dumpvdl2_tpu.fec.l2_tpu import l2_decode_batch as j_l2
    rows = fuzz_sets[fuzz]
    got_all = _payload_plain(_args(rows, cap))
    want = j_l2(rows, S, rs_burst_cap=cap)
    keys = ("blocks", "counts", "fec_row", "blocks_row")
    assert len(got_all) == (3 if cap is None else 4)
    assert ("blocks_row" in want) == (cap is not None)
    for key, got in zip(keys, got_all):
        w = np.asarray(want[key])
        np.testing.assert_array_equal(got.numpy(), w, err_msg=key)
        assert got.numpy().dtype == w.dtype, key


def test_l2_rs_fuzz_reaches_every_count(fuzz_sets):
    """Through the deinterleave of real headers: failures, zero
    syndromes, skipped rows and corrections of 1 to 5 positions, on rows
    of 6, 4, 2 and 0 parity octets."""
    _, counts, fec_row = _payload_plain(_args(fuzz_sets["l2_rs_fuzz"], None))
    parity = fec_row != 0
    assert set(counts[parity].tolist()) >= {-1, 0, 1, 2, 3, 4, 5}
    assert set(fec_row.unique().tolist()) == {0, 2, 4, 6}
    assert int(counts[parity].max()) == 5


def test_l2_payload_plain_odd_parity_counts(fuzz_sets):
    """A caller's odd parity counts (RS_FUZZ_CASES[7]) on the accepted
    bursts' last rows: the table's rows decode as JAX's rs_verify_batch
    decodes them, and count 6 reaches L2P."""
    from dumpvdl2_tpu.fec.rs_tpu import rs_verify_batch as j_verify
    args = list(_args(fuzz_sets["l2_rs_fuzz"], None))
    rng = np.random.default_rng(43)
    args[5] = torch.as_tensor(rng.choice(
        np.array([1, 3, 5, 7, -1], np.int32), size=args[0].shape[0]))
    blocks, counts, fec_row = _payload_plain(args)
    tab, fec_plain = l2_kernel.l2_deinterleave_plain(args[0], None,
                                                     *args[2:])
    assert torch.equal(fec_row, fec_plain)
    want_cw, want_cnt = j_verify(tab.reshape(-1, 255).numpy(),
                                 fec_row.reshape(-1).numpy())
    np.testing.assert_array_equal(blocks.reshape(-1, 255).numpy(),
                                  np.asarray(want_cw))
    np.testing.assert_array_equal(counts.reshape(-1).numpy(),
                                  np.asarray(want_cnt))
    assert 6 in set(counts.reshape(-1).tolist())
    assert {1, 3, 5} <= set(fec_row.reshape(-1).tolist())


# ---------------------------------------------------- the kernel's model
def _c_constants() -> dict:
    src = (REPO / "dumpvdl2_tpu_torch" / "csrc" / "l2.cu").read_text()
    return {m.group(1): int(m.group(2), 0) for m in re.finditer(
        r"constexpr int (k\w+) = (0x[0-9A-Fa-f]+|\d+);", src)}


def test_const_bytes_match_kernel_layout():
    const = _c_constants()
    lay = l2_kernel.CONST_LAYOUT
    assert (const["kExpOff"], const["kLogOff"], const["kPrbsOff"],
            const["kConstBytes"]) == (lay["exp"], lay["log"],
                                      lay["prbs_octets"], lay["bytes"])
    assert all(v % 16 == 0 for v in lay.values())
    assert const["kSymStage"] % 16 == 0
    assert const["kSymStage"] >= l2_kernel.MIN_SYMBOLS + 15
    b = l2_kernel.const_bytes()
    i = np.arange(510)
    np.testing.assert_array_equal(b[i], gf256.ALPHA_TO[i % 255])
    np.testing.assert_array_equal(b[lay["log"]:lay["log"] + 256],
                                  gf256.INDEX_OF)
    # an all-zero symbol row's plain octets are the PRBS octets
    zero = torch.zeros((1, S), dtype=torch.uint8)
    bits = l2_kernel._clear_bits(zero, constants.HEADER_LEN,
                                 constants.HEADER_LEN
                                 + 8 * l2_kernel.MAX_TOTAL_OCT)
    octets = (bits.reshape(-1, 8) << torch.arange(8)).sum(dim=1)
    o = lay["prbs_octets"]
    np.testing.assert_array_equal(b[o:o + l2_kernel.MAX_TOTAL_OCT],
                                  octets.numpy())


def _model_payload_octets(nb, ll, lf, doct) -> int:
    """csrc/l2.cu payload_octets."""
    rs_k, par = constants.RS_K, constants.RS_N - constants.RS_K
    header = 1 <= nb <= l2_kernel.MAX_BLOCKS and 1 <= ll <= rs_k \
        and 0 <= lf <= par and doct == rs_k * (nb - 1) + ll
    return min(doct + par * (nb - 1) + lf, l2_kernel.MAX_TOTAL_OCT) \
        if header else l2_kernel.MAX_TOTAL_OCT


def _model_octets(sym_row: np.ndarray, n_oct: int) -> np.ndarray:
    """csrc/l2.cu pack_octet on the staged symbols only (an index past
    them raises), XOR the PRBS octets."""
    staged = sym_row[:(constants.HEADER_LEN + 8 * n_oct + 2) // 3] \
        .astype(np.int64) & 7
    o = np.arange(n_oct)
    p0 = constants.HEADER_LEN + 8 * o
    s0, r = p0 // 3, p0 % 3
    w = (staged[s0] << 9) | (staged[s0 + 1] << 6) | (staged[s0 + 2] << 3)
    two = np.nonzero(r == 2)[0]
    w[two] |= staged[s0[two] + 3]
    f = (w >> (4 - r)) & 0xFF
    rev = sum(((f >> k) & 1) << (7 - k) for k in range(8))
    return rev ^ l2_kernel.prbs_octets()[:n_oct].astype(np.int64)


def _model_table(octets: np.ndarray, nb, ll, lf, doct) -> np.ndarray:
    """The kernel's deinterleave gather from ``octets`` (-1 past the
    octets it packed)."""
    rows = np.arange(l2_kernel.MAX_BLOCKS)[:, None]
    cols = np.arange(constants.RS_N)[None, :]
    rs_k = constants.RS_K
    is_data, cf = cols < rs_k, cols - rs_k
    src = np.where(is_data, cols * (nb - 1) + np.minimum(cols, ll) + rows,
                   doct + cf * (nb - 1) + np.minimum(cf, lf) + rows)
    cpr = np.where(is_data, np.where(rows < nb - 1, rs_k, ll),
                   np.where(rows < nb - 1, constants.RS_N - rs_k, lf))
    valid = (rows < nb) & (np.where(is_data, cols, cf) < cpr)
    full = np.full(l2_kernel.MAX_TOTAL_OCT, -1)
    full[:octets.size] = octets
    return np.where(valid, full[np.clip(src, 0, full.size - 1)], 0)


@pytest.mark.parametrize("fuzz", list(FUZZ))
def test_kernel_packing_model_matches_plain(fuzz_sets, fuzz):
    """The kernel packs octets from 3 or 4 staged symbols and stages only
    up to the last parity octet; on every accepted burst that gives the
    plain version's table, and no valid cell reads past what it packed.
    A geometry no header gives stages every octet."""
    rows = fuzz_sets[fuzz]
    args = _args(rows, None)
    tab, _ = l2_kernel.l2_deinterleave_plain(*args)
    sym, _, hdr_ok, nbs, lls, lfs, docts = (
        a if a is None else a.numpy() for a in args)
    full_octets = 0
    for i in np.nonzero(hdr_ok)[0]:
        geom = int(nbs[i]), int(lls[i]), int(lfs[i]), int(docts[i])
        n_oct = _model_payload_octets(*geom)
        full_octets += n_oct == l2_kernel.MAX_TOTAL_OCT
        got = _model_table(_model_octets(sym[i], n_oct), *geom)
        np.testing.assert_array_equal(got, tab[i].numpy(), err_msg=str(i))
    assert full_octets < hdr_ok.sum()
    assert _model_payload_octets(3, 10, 4, 500) == l2_kernel.MAX_TOTAL_OCT
    assert _model_payload_octets(9, 249, 6, 8 * 249 + 249) == \
        l2_kernel.MAX_TOTAL_OCT
    np.testing.assert_array_equal(
        _model_octets(sym[0], l2_kernel.MAX_TOTAL_OCT),
        l2_kernel._clear_bits(torch.as_tensor(sym[:1]), constants.HEADER_LEN,
                              constants.HEADER_LEN
                              + 8 * l2_kernel.MAX_TOTAL_OCT)
        .reshape(-1, 8).mul(1 << torch.arange(8)).sum(dim=1).numpy())


# ------------------------------------------------------------- wrappers
def test_l2_payload_on_cpu_runs_plain(fuzz_sets, monkeypatch):
    rows = fuzz_sets["l2_rs_fuzz"]
    calls = []
    for mod, name in ((l2_step, "l2_header"),
                      (l2_step, "l2_payload_capped"),
                      (l2_kernel, "l2_payload_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn:
                            calls.append(_n) or _f(*a))
    before = dict(l2_kernel.launches)
    out = l2_decode_batch(torch.as_tensor(rows), S, rs_burst_cap=9)
    assert calls == ["l2_header", "l2_payload_capped", "l2_payload_plain"]
    assert l2_kernel.launches == before
    want = _payload_plain(_args(rows, 9))
    for key, w in zip(("blocks", "counts", "fec_row", "blocks_row"), want):
        assert torch.equal(out[key], w), key


def test_l2_payload_cuda_refuses_cpu_tensors(fuzz_sets):
    sym, _, *geom = _args(fuzz_sets["l2_fuzz"][:2], None)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        l2_kernel.l2_payload_cuda(sym, *geom)


# ------------------------------------------------------------ on the card
def _chip_smoke():
    """chip_smoke.py as a module: its L2 comparisons."""
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
@pytest.mark.parametrize("cap", [None, 9])
@pytest.mark.parametrize("fuzz", list(FUZZ))
def test_l2_payload_kernel_matches_plain(cuda, fuzz_sets, fuzz, cap):
    smoke = _chip_smoke()
    rows = fuzz_sets[fuzz]
    before = l2_kernel.launches["l2_payload"]
    smoke.compare_l2p(_args(rows, cap, cuda), f"{fuzz}, {cap} rows")
    assert l2_kernel.launches["l2_payload"] == before + 1
    sym = torch.as_tensor(rows, device=cuda)
    got = l2_decode_batch(sym, S, rs_burst_cap=cap)
    want = l2_decode_batch(sym.cpu(), S, rs_burst_cap=cap)
    for key, v in want.items():
        assert torch.equal(got[key].cpu(), v), key


@pytest.mark.cuda
def test_l2_payload_kernel_any_geometry(cuda, fuzz_sets):
    """Odd parity counts (count 6 through the table), geometry no header
    gives, and a misaligned symbol base: the kernel equals its plain
    version."""
    smoke = _chip_smoke()
    args = list(_args(fuzz_sets["l2_rs_fuzz"], None, cuda))
    n = args[0].shape[0]
    rng = np.random.default_rng(44)
    args[5] = torch.as_tensor(rng.choice(
        np.array([1, 3, 5, 7, -1], np.int32), size=n), device=cuda)
    res = smoke.compare_l2p(tuple(args), "odd parity counts")
    assert 6 in res["by_count"]
    args[4] = torch.as_tensor(rng.integers(-3, 300, n, dtype=np.int32),
                              device=cuda)
    smoke.compare_l2p(tuple(args), "geometry no header gives")
    buf = torch.zeros(n * S + 5, dtype=torch.uint8, device=cuda)
    args[0] = buf[5:].view(n, S)
    args[0].copy_(torch.as_tensor(fuzz_sets["l2_rs_fuzz"], device=cuda))
    smoke.compare_l2p(tuple(args), "misaligned symbols")


@pytest.mark.cuda
def test_l2_payload_rejects_bad_input(cuda, fuzz_sets):
    sym, _, hdr_ok, nb, last_len, *rest = _args(fuzz_sets["l2_fuzz"][:4],
                                                None, cuda)
    with pytest.raises(ValueError):
        l2_kernel.l2_payload_cuda(sym[:, :100].contiguous(), hdr_ok, nb,
                                  last_len, *rest)
    with pytest.raises(ValueError):
        l2_kernel.l2_payload_cuda(sym, hdr_ok, nb, last_len.long(), *rest)
    with pytest.raises(ValueError):
        l2_kernel.l2_payload_cuda(sym, hdr_ok[:3], nb, last_len, *rest)
