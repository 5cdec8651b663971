"""PyTorch port: the L2 kernels' plain twins (fec/l2_kernel.py) against
the JAX package and the scalar decoder, their wrappers on the CPU, and
the kernels on the card.

* ``rs_verify_plain`` against ``dumpvdl2_tpu.fec.rs_tpu.rs_verify_batch``
  and the scalar ``dumpvdl2_tpu.fec.rs.rs_verify``, exactly, on each case
  of ``sim.rs_fuzz`` (0-3 errors; erasures with errors up to capacity;
  4-20 errors; a zero syndrome; fec_octets 0, 2, 4, 6 and odd or out of
  range ones).
* ``l2_header_plain`` and ``l2_deinterleave_plain`` (with
  ``rs_verify_plain`` after them) against the JAX ``l2_decode_batch``'s
  fields, and against the scalar burst decoder's header and
  deinterleave row by row, on ``sim.l2_fuzz``'s synthesized bursts of 1
  to 9 RS blocks, damaged bursts, noise rows and the 1990-octet burst.
* Each wrapper on a CPU tensor runs its plain version and launches
  nothing; the CUDA entry points refuse CPU tensors.
* ``burst.decode_bursts_device`` against the JAX package's.
* ``csrc/l2.cu``'s constants against the Python ones.

No tolerance: every field is an integer or a byte.  The tests marked
``cuda`` hold each kernel against its plain version on the card and
skip without one.  The JAX package is imported inside the CPU tests, so
that on the GPU machine (no JAX) the file runs as

    python -m pytest -o addopts= -p no:cacheprovider --noconftest \\
        -m cuda tests/test_torch_l2_kernels.py
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu_torch import burst, constants, sim
from dumpvdl2_tpu_torch.fec import l2_kernel, rs
from dumpvdl2_tpu_torch.fec.l2 import l2_decode_batch

S = 5616        # MAX_BURST_SYMS
REPO = pathlib.Path(__file__).resolve().parent.parent
N_CASE = 40     # RS rows a fuzz case


def _rs_case(case: int) -> tuple[np.ndarray, np.ndarray]:
    n = len(sim.RS_FUZZ_CASES)
    rows, fec = sim.rs_fuzz(n * N_CASE, seed=101)
    return rows[case::n], fec[case::n]


@pytest.mark.parametrize("case", range(len(sim.RS_FUZZ_CASES)),
                         ids=lambda c: "fec{}_err{}-{}".format(
                             *sim.RS_FUZZ_CASES[c]))
def test_rs_verify_plain_matches_jax_and_scalar(case):
    from dumpvdl2_tpu.fec import rs as j_rs
    from dumpvdl2_tpu.fec.rs_tpu import rs_verify_batch as j_verify
    rows, fec = _rs_case(case)
    got_cw, got_cnt = l2_kernel.rs_verify_plain(torch.as_tensor(rows),
                                                torch.as_tensor(fec))
    assert got_cw.dtype == torch.uint8 and got_cnt.dtype == torch.int32
    want_cw, want_cnt = j_verify(rows, fec)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(got_cw.numpy(), np.asarray(want_cw))
    got_cw, got_cnt = got_cw.numpy(), got_cnt.numpy()
    for i, (row, fo) in enumerate(zip(rows, fec)):
        if not 0 <= fo <= rs.NROOTS:
            continue            # the scalar decoder's domain
        exp_cw, exp_cnt = j_rs.rs_verify(row, int(fo))
        assert got_cnt[i] == exp_cnt, (case, i)
        if exp_cnt >= 0:
            np.testing.assert_array_equal(got_cw[i], exp_cw)
        else:
            np.testing.assert_array_equal(got_cw[i], row)


def test_rs_fuzz_reaches_every_outcome():
    """The fuzz exercises failures, zero syndromes, skipped rows and
    corrections of 1 to 6 positions."""
    rows, fec = sim.rs_fuzz(len(sim.RS_FUZZ_CASES) * N_CASE, seed=101)
    _, cnt = l2_kernel.rs_verify_plain(torch.as_tensor(rows),
                                       torch.as_tensor(fec))
    assert set(cnt.tolist()) >= {-1, 0, 1, 2, 3, 4, 5, 6}
    assert {0, 2, 4, 6} <= set(fec.tolist())
    rs_rows = rows[np.arange(rows.shape[0]) % len(sim.RS_FUZZ_CASES) == 5]
    assert (rs_rows == 0).all(axis=1).any()          # all-zero rows


def test_encode_batch_matches_scalar():
    data = np.random.default_rng(5).integers(0, 256, (12, rs.KK),
                                             dtype=np.uint8)
    want = np.stack([rs.encode(d) for d in data])
    np.testing.assert_array_equal(rs.encode_batch(data), want)


def _decode_plain(syms: np.ndarray, cap: int | None) -> dict:
    """l2_decode_batch composed from the three plain twins."""
    sym = torch.as_tensor(syms)
    hdr = l2_kernel.l2_header_plain(sym)
    sel = None if cap is None else torch.argsort(
        (~hdr["hdr_ok"]).to(torch.int32), stable=True)[:cap]
    tab, fec_row = l2_kernel.l2_deinterleave_plain(
        sym, sel, hdr["hdr_ok"], hdr["num_blocks"], hdr["last_len"],
        hdr["lf"], hdr["datalen_octets"])
    corr, counts = l2_kernel.rs_verify_plain(tab.reshape(-1, 255),
                                             fec_row.reshape(-1))
    return {**hdr, "tab": tab, "fec_row": fec_row,
            "blocks": corr.reshape(tab.shape),
            "counts": counts.reshape(fec_row.shape), "sel": sel}


@pytest.fixture(scope="module")
def fuzz_rows():
    return sim.l2_fuzz(24, seed=31)


@pytest.mark.parametrize("cap", [None, 7])
def test_l2_plain_twins_match_jax(fuzz_rows, cap):
    from dumpvdl2_tpu.fec.l2_tpu import l2_decode_batch as j_l2
    got = _decode_plain(fuzz_rows, cap)
    want = j_l2(fuzz_rows, S, rs_burst_cap=cap)
    for key in ("syndrome", "synd_weight", "reserved_bad", "too_long",
                "no_fec", "hdr_ok", "datalen", "datalen_octets",
                "num_blocks", "last_len", "bits_consumed", "blocks",
                "counts", "fec_row"):
        g, w = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_array_equal(g, w, err_msg=key)
        assert g.dtype == w.dtype, key
    if cap is not None:
        assert (np.asarray(want["blocks_row"]) < 0).any()


def test_l2_plain_twins_match_scalar_decoder(fuzz_rows):
    """Row by row: the header against header_info, the table against
    deinterleave_burst, the parity counts against the scalar geometry;
    accepted bursts with every kind of RS outcome are covered."""
    from dumpvdl2_tpu.burst import header_info
    from dumpvdl2_tpu.fec.interleave import (deinterleave_burst,
                                             get_fec_octetcount)
    from dumpvdl2_tpu.fec.scramble import descramble
    from dumpvdl2_tpu.utils.bits import pack_lsb
    got = _decode_plain(fuzz_rows, None)
    reasons = set()
    for i, row in enumerate(fuzz_rows):
        bits = ((row[:, None] >> np.array([2, 1, 0])) & 1) \
            .astype(np.uint8).reshape(-1)
        clear = descramble(bits)
        ref = header_info(clear[:constants.HEADER_LEN])
        reasons.add(ref.reason)
        assert int(got["syndrome"][i]) == ref.syndrome
        assert int(got["synd_weight"][i]) == ref.synd_weight
        assert bool(got["hdr_ok"][i]) == ref.ok
        # the scalar decoder stops at its first failed check
        flags = [bool(got[k][i]) for k in ("reserved_bad", "too_long",
                                           "no_fec")]
        first = flags.index(True) if any(flags) else 3
        assert ref.reason == ("hdr_reserved_bits", "too_long", "no_fec",
                              "")[first]
        tab = got["tab"][i].numpy()
        if not ref.ok:
            assert not tab.any() and not got["fec_row"][i].any()
            continue
        assert int(got["datalen"][i]) == ref.datalen
        assert int(got["bits_consumed"][i]) == ref.bits_consumed
        n_oct = (ref.bits_consumed - constants.HEADER_LEN) // 8
        octets = pack_lsb(clear[constants.HEADER_LEN:ref.bits_consumed])
        assert octets.size == n_oct
        want, nb, last_len = deinterleave_burst(octets, ref.datalen_octets)
        assert int(got["num_blocks"][i]) == nb
        np.testing.assert_array_equal(tab[:nb], want)
        assert not tab[nb:].any()
        fec_row = [rs.NROOTS] * (nb - 1) + [get_fec_octetcount(last_len)]
        assert got["fec_row"][i].tolist() == fec_row + [0] * (9 - nb)
    counts = got["counts"][got["fec_row"] != 0]
    assert reasons >= {"", "hdr_reserved_bits"}
    assert (counts > 0).any() and (counts == 0).any()
    assert int(got["num_blocks"][got["hdr_ok"]].max()) == 9  # near-cap


def test_wrappers_on_cpu_run_plain(fuzz_rows, monkeypatch):
    calls = []
    for name in ("l2_header_plain", "l2_deinterleave_plain",
                 "rs_verify_plain"):
        fn = getattr(l2_kernel, name)
        monkeypatch.setattr(l2_kernel, name,
                            lambda *a, _n=name, _f=fn: calls.append(_n)
                            or _f(*a))
    before = dict(l2_kernel.launches)
    out = l2_decode_batch(torch.as_tensor(fuzz_rows), S, rs_burst_cap=7)
    assert calls == ["l2_header_plain", "l2_deinterleave_plain",
                     "rs_verify_plain"]
    assert l2_kernel.launches == before
    want = _decode_plain(fuzz_rows, 7)
    for key in ("hdr_ok", "blocks", "counts", "fec_row"):
        assert torch.equal(out[key], want[key]), key


def test_cuda_entry_points_refuse_cpu_tensors(fuzz_rows):
    sym = torch.as_tensor(fuzz_rows)
    hdr = l2_kernel.l2_header_plain(sym)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        l2_kernel.l2_header_cuda(sym)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        l2_kernel.l2_deinterleave_cuda(
            sym, None, hdr["hdr_ok"], hdr["num_blocks"], hdr["last_len"],
            hdr["lf"], hdr["datalen_octets"])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        l2_kernel.rs_verify_cuda(torch.zeros((2, 255), dtype=torch.uint8),
                                 torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        l2_kernel.rs_verify(torch.zeros((2, 255), dtype=torch.uint8,
                                        device="meta"),
                            torch.zeros(2, dtype=torch.int32, device="meta"))


def test_decode_bursts_device_matches_jax(fuzz_rows):
    from dumpvdl2_tpu.burst import decode_bursts_device as j_decode
    got = burst.decode_bursts_device(fuzz_rows, S, device="cpu")
    want = j_decode(fuzz_rows, S)
    assert len(got) == len(want) == fuzz_rows.shape[0]
    for g, w in zip(got, want):
        assert (g.ok, g.reason, g.syndrome, g.synd_weight, g.datalen,
                g.datalen_octets, g.bits_consumed, g.num_fec_corrections,
                g.blocks_processed, g.blocks_fec_ok) == \
            (w.ok, w.reason, w.syndrome, w.synd_weight, w.datalen,
             w.datalen_octets, w.bits_consumed, w.num_fec_corrections,
             w.blocks_processed, w.blocks_fec_ok)
        assert [bytes(f) for f in g.frames] == [bytes(f) for f in w.frames]
    assert any(g.ok for g in got) and not all(g.ok for g in got)
    out = burst.tree_to_numpy({"a": torch.arange(3)})
    assert isinstance(out["a"], np.ndarray)


def test_decode_bursts_device_needs_a_card_by_default(monkeypatch,
                                                      fuzz_rows):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        burst.decode_bursts_device(fuzz_rows[:1], S)


def test_kernel_constants_match_python():
    src = (REPO / "dumpvdl2_tpu_torch" / "csrc" / "l2.cu").read_text()
    const = {m.group(1): int(m.group(2), 0) for m in re.finditer(
        r"constexpr int (k\w+) = (0x[0-9A-Fa-f]+|\d+);", src)}
    want = {"kHeaderLen": constants.HEADER_LEN, "kTrLen": constants.TRLEN,
            "kHdrFecLen": constants.HDRFECLEN,
            "kMaxFrameLength": constants.MAX_FRAME_LENGTH,
            "kMaxFrameLengthCorrected":
                constants.MAX_FRAME_LENGTH_CORRECTED,
            "kRsN": rs.NN, "kRsK": rs.KK, "kRoots": rs.NROOTS,
            "kFcr": rs.FCR, "kGf": 255, "kA0": 255,
            "kMaxBlocks": l2_kernel.MAX_BLOCKS,
            "kMaxTotalOct": l2_kernel.MAX_TOTAL_OCT}
    assert {k: const[k] for k in want} == want
    assert constants.RS_N == rs.NN and constants.RS_K == rs.KK
    # the header FEC, geometry and PRBS reach the kernels as tables only
    for name in ("SYNDTABLE", "0x6959", "0x187"):
        assert name not in src
    assert 3 * l2_kernel.MIN_SYMBOLS >= \
        constants.HEADER_LEN + 8 * l2_kernel.MAX_TOTAL_OCT


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
@pytest.mark.parametrize("seed", [1, 2])
def test_rs_kernel_matches_plain(cuda, seed):
    smoke = _chip_smoke()
    rows, fec = sim.rs_fuzz(4000, seed=seed)
    before = l2_kernel.launches["rs_verify"]
    res = smoke.compare_rs(torch.as_tensor(rows, device=cuda),
                           torch.as_tensor(fec, device=cuda), f"seed {seed}")
    assert l2_kernel.launches["rs_verify"] == before + 1
    assert -1 in res["by_count"] and 6 in res["by_count"]


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 9])
def test_l2h_l2d_kernels_match_plain(cuda, fuzz_rows, cap):
    smoke = _chip_smoke()
    sym = torch.as_tensor(fuzz_rows, device=cuda)
    smoke.compare_l2h(sym, "fuzz")
    hdr = l2_kernel.l2_header_plain(sym)
    sel = None if cap is None else torch.argsort(
        (~hdr["hdr_ok"]).to(torch.int32), stable=True)[:cap]
    smoke.compare_l2d((sym, sel, hdr["hdr_ok"], hdr["num_blocks"],
                       hdr["last_len"], hdr["lf"], hdr["datalen_octets"]),
                      f"fuzz, {cap} rows")
    got = l2_decode_batch(sym, S, rs_burst_cap=cap)
    want = l2_decode_batch(sym.cpu(), S, rs_burst_cap=cap)
    for key, v in want.items():
        assert torch.equal(got[key].cpu(), v), key


@pytest.mark.cuda
def test_l2_kernels_reject_bad_input(cuda):
    sym = torch.zeros((4, S), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        l2_kernel.l2_header_cuda(sym[:, :100].contiguous())
    with pytest.raises(ValueError):
        l2_kernel.l2_header_cuda(sym.to(torch.int32))
    with pytest.raises(ValueError):
        l2_kernel.rs_verify_cuda(torch.zeros((4, 254), dtype=torch.uint8,
                                             device=cuda),
                                 torch.zeros(4, dtype=torch.int32,
                                             device=cuda))
    with pytest.raises(ValueError):
        l2_kernel.rs_verify_cuda(torch.zeros((255, 4), dtype=torch.uint8,
                                             device=cuda).T,
                                 torch.zeros(4, dtype=torch.int32,
                                             device=cuda))
