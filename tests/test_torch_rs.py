"""PyTorch port vs JAX: batched RS(255,249) decoder (fec/rs_batch.py).

The cases of tests/test_rs_tpu.py go through the JAX batch decoder,
the port and the scalar decoder; corrected bytes and counts must match
exactly, failed rows included.  Rows of zeros and zero erasure
locators drive the log-table gathers to LOG[0] + LOG[0] and the BM
update to dlog + A0, the indices JAX clamps and the port masks.
"""
import numpy as np
import torch

from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu.fec import rs
from dumpvdl2_tpu.fec.rs_tpu import rs_decode_batch as j_decode
from dumpvdl2_tpu.fec.rs_tpu import rs_verify_batch as j_verify
from dumpvdl2_tpu_torch.fec.rs_batch import rs_decode_batch, rs_verify_batch

NN, KK, T = rs.NN, rs.KK, rs.NROOTS


def _random_codeword(rng):
    return rs.encode(rng.integers(0, 256, KK, dtype=np.uint8))


def _decode_both(batch, erase, nerase):
    got_cw, got_cnt = rs_decode_batch(torch.as_tensor(batch),
                                      torch.as_tensor(erase),
                                      torch.as_tensor(nerase))
    want_cw, want_cnt = j_decode(batch, erase, nerase)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(got_cw.numpy(), np.asarray(want_cw))
    assert got_cw.dtype == torch.uint8 and got_cnt.dtype == torch.int32
    return got_cw.numpy(), got_cnt.numpy()


def test_random_errors_match_jax_and_scalar():
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(200):
        cw = _random_codeword(rng).astype(np.int32)
        for p in rng.choice(NN, size=rng.integers(0, 5), replace=False):
            cw[p] ^= rng.integers(1, 256)
        cases.append(cw)
    batch = np.stack(cases)
    got_cw, got_cnt = _decode_both(batch, np.zeros((len(cases), T), np.int32),
                                   np.zeros(len(cases), np.int32))
    for i, cw in enumerate(cases):
        exp_cw, exp_cnt = rs.decode(cw)
        assert got_cnt[i] == exp_cnt, f"case {i}"
        if exp_cnt >= 0:
            np.testing.assert_array_equal(got_cw[i], exp_cw)


def test_erasures_match_jax_and_scalar():
    rng = np.random.default_rng(1)
    batch, eras, ners, scalars = [], [], [], []
    for _ in range(150):
        cw = _random_codeword(rng).astype(np.int32)
        ne = int(rng.integers(0, T + 1))
        epos = rng.choice(NN, size=ne, replace=False).astype(np.int32)
        for p in epos:
            cw[p] = rng.integers(0, 256)
        n_extra = int(rng.integers(0, max(1, (T - ne) // 2 + 1)))
        extra = rng.choice([p for p in range(NN) if p not in set(epos)],
                           size=n_extra, replace=False)
        for p in extra:
            cw[p] ^= rng.integers(1, 256)
        batch.append(cw)
        pad = np.zeros(T, np.int32)
        pad[:ne] = epos
        eras.append(pad)
        ners.append(ne)
        scalars.append(rs.decode(cw, [int(p) for p in epos]))
    got_cw, got_cnt = _decode_both(np.stack(batch), np.stack(eras),
                                   np.array(ners, np.int32))
    for i, (exp_cw, exp_cnt) in enumerate(scalars):
        assert got_cnt[i] == exp_cnt, f"case {i}"
        if exp_cnt >= 0:
            np.testing.assert_array_equal(got_cw[i], exp_cw)


def test_uncorrectable_and_zero_log_rows():
    rng = np.random.default_rng(2)
    rows, eras, ners = [], [], []
    for _ in range(40):                         # 5..12 errors > t = 3
        cw = _random_codeword(rng).astype(np.int32)
        for p in rng.choice(NN, size=rng.integers(5, 13), replace=False):
            cw[p] ^= rng.integers(1, 256)
        rows.append(cw)
        eras.append(np.zeros(T, np.int32))
        ners.append(0)
    # all-zero codewords and words that are zero but for one octet, with
    # and without erasures at zero octets: both logs A0 everywhere
    for ne in (0, 2, 6):
        for cw in (np.zeros(NN, np.int32),
                   np.eye(1, NN, 17, dtype=np.int32)[0] * 0x5A):
            rows.append(cw)
            pad = np.zeros(T, np.int32)
            pad[:ne] = np.arange(100, 100 + ne)
            eras.append(pad)
            ners.append(ne)
    _, cnt = _decode_both(np.stack(rows), np.stack(eras),
                          np.array(ners, np.int32))
    assert (cnt[:40] == -1).any()


def test_verify_batch_shortened_blocks():
    rng = np.random.default_rng(3)
    rows, fecs, scalars = [], [], []
    for fec_octets in (0, 2, 4, 6, 6, 2, 0, 4):
        cw = _random_codeword(rng).astype(np.int32)
        cw[KK + fec_octets:] = 0                # absent parity
        if fec_octets:
            p = rng.integers(0, KK)
            cw[p] ^= rng.integers(1, 256)
        rows.append(cw)
        fecs.append(fec_octets)
        scalars.append(rs.rs_verify(cw, fec_octets))
    rows, fecs = np.stack(rows), np.array(fecs, np.int32)
    got_cw, got_cnt = rs_verify_batch(torch.as_tensor(rows),
                                      torch.as_tensor(fecs))
    want_cw, want_cnt = j_verify(rows, fecs)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(got_cw.numpy(), np.asarray(want_cw))
    for i, (exp_cw, exp_cnt) in enumerate(scalars):
        assert got_cnt[i] == exp_cnt
        if exp_cnt >= 0:
            np.testing.assert_array_equal(got_cw[i].numpy(), exp_cw)
