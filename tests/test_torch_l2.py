"""PyTorch port vs JAX: batched L2 burst decode (fec/l2.py).

The burst cases of tests/test_l2_tpu.py (good bursts, RS-correctable
and uncorrectable errors, header errors, noise rows, the max-length
burst) go through both packages' l2_decode_batch, with and without
the rs_burst_cap compaction; every key must match exactly and
frame_pwr to float32 summation-order tolerance.  The port's rows must
also assemble into the scalar decoder's BurstResults.
"""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu.burst import decode_burst
from dumpvdl2_tpu.fec.l2_tpu import l2_decode_batch as j_l2
from dumpvdl2_tpu.sim import build_burst_bits, frame_with_fcs
from dumpvdl2_tpu_torch.burst import _result_from_batch
from dumpvdl2_tpu_torch.fec.l2 import l2_decode_batch

S = 5616        # MAX_BURST_SYMS


def _bits_to_syms(bits, rng):
    pad = 3 * S - bits.size
    bits = np.concatenate([bits, rng.integers(0, 2, pad, dtype=np.uint8)])
    tri = bits.reshape(S, 3)
    return ((tri[:, 0] << 2) | (tri[:, 1] << 1) | tri[:, 2]).astype(np.uint8)


def _cases():
    rng = np.random.default_rng(7)
    cases = []
    for sizes in ([16], [64], [249], [1000], [16, 32], [100, 200, 50],
                  [1990]):
        frames = [bytes(rng.integers(0, 256, s, dtype=np.uint8))
                  for s in sizes]
        cases.append(build_burst_bits(frames))
    b = cases[3].copy()
    for pos in (40, 400, 800, 3000):            # RS-correctable
        b[pos] ^= 1
    cases.append(b)
    b = cases[0].copy()
    b[5] ^= 1                                   # header single-bit error
    cases.append(b)
    b = cases[2].copy()
    b[100:200] ^= 1                             # uncorrectable block
    cases.append(b)
    for seed in range(4):                       # noise rows
        cases.append(np.random.default_rng(seed).integers(
            0, 2, 3 * S, dtype=np.uint8))
    syms = np.stack([_bits_to_syms(c, rng) for c in cases])
    power = rng.uniform(0.0, 2.0, syms.shape).astype(np.float32)
    return syms, power


def _assert_l2_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        if k == "frame_pwr":
            np.testing.assert_allclose(g, np.asarray(v), rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)
            assert g.dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("rs_burst_cap", [None, 5, 64])
def test_l2_decode_batch_matches_jax(rs_burst_cap):
    syms, power = _cases()
    got = l2_decode_batch(torch.as_tensor(syms), S, torch.as_tensor(power),
                          rs_burst_cap=rs_burst_cap)
    want = j_l2(syms, S, power, rs_burst_cap=rs_burst_cap)
    _assert_l2_equal(got, want)
    if rs_burst_cap == 5:                       # more hdr-ok rows than cap
        assert (got["blocks_row"].numpy() < 0).any()


def test_l2_rows_match_scalar_decoder():
    syms, _ = _cases()
    out = {k: v.numpy() for k, v in
           l2_decode_batch(torch.as_tensor(syms), S).items()}
    for i, row in enumerate(syms):
        bits = ((row[:, None] >> np.array([2, 1, 0])) & 1) \
            .astype(np.uint8).reshape(-1)
        ref = decode_burst(bits)
        res = _result_from_batch(out, i)
        assert (res.ok, res.reason, res.syndrome, res.synd_weight) == \
            (ref.ok, ref.reason, ref.syndrome, ref.synd_weight), i
        if ref.ok:
            assert res.bits_consumed == ref.bits_consumed
            assert res.num_fec_corrections == ref.num_fec_corrections
            assert [bytes(f) for f in res.frames] == \
                [bytes(f) for f in ref.frames]


def test_max_length_burst_uses_all_rs_blocks():
    rng = np.random.default_rng(11)
    payload = bytes(rng.integers(0, 256, 1990, dtype=np.uint8))
    syms = _bits_to_syms(build_burst_bits([payload]), rng)[None, :]
    out = {k: v.numpy() for k, v in
           l2_decode_batch(torch.as_tensor(syms), S).items()}
    assert int(out["num_blocks"][0]) == 9
    res = _result_from_batch(out, 0)
    assert res.ok, res.reason
    assert [bytes(f) for f in res.frames] == [frame_with_fcs(payload)]
