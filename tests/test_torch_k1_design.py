"""Kernel K1's design, checked on a host with no nvcc.

* The constants in ``csrc/sync_metric.cu`` are bit-equal to the plain
  version's float32 values, and the build keeps FMA contraction off and
  fast math out: the unwrap's +-pi decisions depend on both.
* The chain layout covers every output of a tile once, conflict-free.
* The kernel's arithmetic, as a numpy model of its statements: the
  unwrap step (one compare of |d|, cum - copysign(2 pi, d) where it
  holds) gives the plain version's running sum bit for bit, at the
  +-pi edges too, and the whole fit
  (explicit fused multiply-adds, x 1/16, x float32(1/340)) stays inside
  the limits against the plain version and the JAX metric: same inf
  mask, |d err| < 1e-3, |d freq| < 1e-5.  These test the model, not the
  compiled kernel (the GPU tests do that); MODELLED_STATEMENTS pins the
  model to the source, so a change of the kernel's arithmetic fails
  here until the model follows it.
* ``chip_smoke.k1_bound`` against a hand computation, and each of
  ``tools/k1_probe.py``'s variants edits the source in one place.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu.dsp.demod import sync_error_metric as j_metric
from dumpvdl2_tpu_torch import kernels
from dumpvdl2_tpu_torch.dsp import sync_kernel

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = (REPO / "dumpvdl2_tpu_torch" / "csrc" / "sync_metric.cu").read_text()


def _cu_array(name):
    body = re.search(r"constexpr float " + name + r"\[kSyms\] = \{(.*?)\};",
                     SOURCE, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    vals = [float.fromhex(v.strip().rstrip("f"))
            for v in body.split(",") if v.strip()]
    return np.array(vals, np.float32)


def _cu_scalar(name):
    m = re.search(r"constexpr float " + name + r" = ([^;]*);", SOURCE)
    return float.fromhex(m.group(1).strip().rstrip("f"))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_kernel_constants_are_the_plain_versions():
    np.testing.assert_array_equal(_bits(_cu_array("PR_PHASE")),
                                  _bits(sync_kernel.PR_PHASE))
    np.testing.assert_array_equal(_bits(_cu_array("LR_X")),
                                  _bits(sync_kernel.LR_X))
    assert _bits(_cu_scalar("kPi")) == _bits(sync_kernel._PI)
    assert _bits(_cu_scalar("kTwoPi")) == _bits(sync_kernel._TWO_PI)
    assert _bits(_cu_scalar("kInv340")) == _bits(
        np.float32(1.0 / sync_kernel.LR_DENOM))


def test_nvcc_flags_keep_float_semantics():
    assert "--fmad=false" in kernels.NVCC_FLAGS
    for flag in kernels.NVCC_FLAGS:
        low = flag.lower().replace("-", "_")
        assert "fast_math" not in low, flag
        assert "ftz=true" not in low, flag
        assert "prec_div=false" not in low and "prec_sqrt=false" not in low


def test_chain_layout_covers_a_tile_once():
    def const(name):
        return int(re.search(r"constexpr int " + name + r" = (\d+);",
                             SOURCE).group(1))
    sps, chain, groups = const("kSps"), const("kChain"), const("kGroups")
    assert sps == 10 and sps * groups % 32 == 0
    tile = sps * chain * groups
    outs = [g * sps * chain + m + sps * r
            for g in range(groups) for m in range(sps) for r in range(chain)]
    assert sorted(outs) == list(range(tile))
    # lane j of a warp reads and writes bank j at every step of its chain
    for tid in range(sps * groups):
        g, m = divmod(tid, sps)
        assert (g * sps * chain + m) % 32 == tid % 32


# The statements of sync_metric.cu's fit() that the model below copies.
MODELLED_STATEMENTS = [
    "float prev = w[off] - PR_PHASE[0];",
    "const float cur = w[off + k] - PR_PHASE[k];",
    "const float d = cur - prev;",
    "if (fabsf(d) > kPi) cum = cum - copysignf(kTwoPi, d);",
    "ev[k] = cur + cum;",
    "for (int k = 1; k < kSyms; ++k) sum = sum + ev[k];",
    "const float mean = sum * 0.0625f;",
    "ev[k] = ev[k] - mean;",
    "f = __fmaf_rn(LR_X[k], ev[k], f);",
    "f = f * kInv340;",
    "const float res = __fmaf_rn(-f, LR_X[k], ev[k]);",
    "e = __fmaf_rn(res, res, e);",
]


def test_model_copies_the_kernel_statements():
    start = SOURCE.index("{", SOURCE.index("void fit("))
    body = SOURCE[start:SOURCE.index("void fit_chain(")]
    body = " ".join(re.sub(r"//[^\n]*", "", body).split())
    for stmt in MODELLED_STATEMENTS:
        assert body.count(stmt) == 1, stmt
    # and fit() does no float arithmetic beyond them
    ops = re.findall(r"(?:\w+\(|[-+*/] )", re.sub(
        r"constexpr[^;]*;|for \([^)]*\)", "", body))
    modelled = re.findall(r"(?:\w+\(|[-+*/] )",
                          " ".join(MODELLED_STATEMENTS))
    assert sorted(ops) == sorted(modelled)


def _fma(a, b, c):
    """float32 fused multiply-add: the float64 product of two float32
    values is exact, so one rounding to float64 and one to float32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


_PI = np.float32(sync_kernel._PI)
_TWO_PI = np.float32(sync_kernel._TWO_PI)


def _unwrap_step(cum, d):
    """The kernel's step: where |d| > pi, cum - copysign(2 pi, d)."""
    return np.where(np.abs(d) > _PI, cum - np.copysign(_TWO_PI, d),
                    cum).astype(np.float32)


def _plain_unwrap_step(cum, d):
    """The plain version's step: adj from two compares, one add."""
    adj = np.where(d > _PI, -_TWO_PI, np.where(d < -_PI, _TWO_PI,
                                                np.float32(0)))
    return (cum + adj).astype(np.float32)


def test_unwrap_step_is_bit_identical():
    rng = np.random.default_rng(3)
    ulp = np.spacing(_PI)
    edges = np.array([_PI, -_PI, _PI + ulp, _PI - ulp, -_PI + ulp,
                      -_PI - ulp, 0.0, -0.0, np.nan, 3.75 * np.pi,
                      -3.75 * np.pi, 1e-30, -1e-30], np.float32)
    d = np.concatenate([edges, rng.uniform(-3.75 * np.pi, 3.75 * np.pi,
                                           20000).astype(np.float32)])
    d = np.stack([d, rng.permutation(d), rng.permutation(d)])
    cum_k = cum_p = np.zeros(d.shape[1], np.float32)
    for row in d:          # three steps: cum runs over 0, +-2pi, +-4pi
        cum_k = _unwrap_step(cum_k, row)
        cum_p = _plain_unwrap_step(cum_p, row)
        np.testing.assert_array_equal(cum_k.view(np.uint32),
                                      cum_p.view(np.uint32))


def _kernel_model(ph):
    """The kernel's per-output arithmetic (fit_chain) in numpy."""
    C, M = ph.shape
    L = M - sync_kernel.LOOKBACK
    err = np.full((C, M), np.inf, np.float32)
    freq = np.zeros((C, M), np.float32)
    if L <= 0:
        return err, freq
    pr, x = sync_kernel.PR_PHASE, sync_kernel.LR_X
    cur = [ph[:, 10 * k:10 * k + L] - pr[k] for k in range(16)]
    ev = [cur[0]]
    cum = np.zeros((C, L), np.float32)
    for k in range(1, 16):
        cum = _unwrap_step(cum, cur[k] - cur[k - 1])
        ev.append(cur[k] + cum)
    s = ev[0]
    for k in range(1, 16):
        s = s + ev[k]
    mean = s * np.float32(0.0625)
    evc = [v - mean for v in ev]
    f = np.zeros((C, L), np.float32)
    for k in range(16):
        f = _fma(np.full_like(f, x[k]), evc[k], f)
    f = f * np.float32(1.0 / 340.0)
    e = np.zeros((C, L), np.float32)
    for k in range(16):
        r = _fma(-f, np.full_like(f, x[k]), evc[k])
        e = _fma(r, r, e)
    err[:, sync_kernel.LOOKBACK:] = e
    freq[:, sync_kernel.LOOKBACK:] = f
    return err, freq


@pytest.mark.parametrize("C,M", [(4, 3000), (1, 151), (2, 150), (3, 2871)])
def test_kernel_arithmetic_within_limits(C, M):
    rng = np.random.default_rng(C * 7919 + M)
    ph = rng.uniform(-np.pi, np.pi, (C, M)).astype(np.float32)
    e1, f1 = _kernel_model(ph)
    e_p, f_p = (t.numpy() for t in
                sync_kernel.sync_error_metric_plain(torch.as_tensor(ph)))
    for e0, f0 in ((e_p, f_p), tuple(map(np.asarray, j_metric(ph)))):
        np.testing.assert_array_equal(np.isinf(e1), np.isinf(e0))
        fin = ~np.isinf(e0)
        assert np.abs(e1[fin] - e0[fin]).max(initial=0.0) < 1e-3
        assert np.abs(f1 - f0).max(initial=0.0) < 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("C,M,bound_ms,bound_by", [
    # 256 x 108 694 outputs x 169 instructions over 128 x 132 x 1.98e9
    # per second; 12 x 256 x 108 844 bytes over 3.35e12 per second
    (256, 108844, 4702537216 / 3.345408e13 * 1e3, "operations"),
    # one output: 12 x 151 bytes over 3.35e12 per second
    (1, 151, 1812 / 3.35e12 * 1e3, "bytes"),
])
def test_k1_bound_by_hand(C, M, bound_ms, bound_by):
    smoke = _chip_smoke()
    # per output: 74 adds; per unwrap step a compare, a copysign and a
    # conditional add (45); 2 multiplies; 48 FMAs
    assert sum(smoke.K1_OPS_PER_OUTPUT.values()) == 74 + 45 + 2 + 48 == 169
    got = smoke.k1_bound(C, M, sms=132, clock_hz=1.98e9)
    assert got["bound_by"] == bound_by
    assert got["bound_ms"] == pytest.approx(bound_ms, rel=1e-12)
    assert got["bytes_ms"] == pytest.approx(12 * C * M / 3.35e12 * 1e3,
                                            rel=1e-12)


def _k1_probe():
    spec = importlib.util.spec_from_file_location(
        "k1_probe", REPO / "tools" / "k1_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["unroll1", "unroll4", "unroll16",
                                  "unwrap_satfma", "unwrap_select"])
def test_probe_variant_edits_one_place(name):
    pattern, repl = _k1_probe().VARIANTS[name]
    text, n = re.subn(pattern, repl, SOURCE)
    assert n == 1 and repl in text
