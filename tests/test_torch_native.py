"""The port's native host library (dumpvdl2_tpu_torch/native/l2host.c)
against the port's pure-Python spec and against the JAX package.

* Port C vs port Python: CRC-16 on random lengths (0 included) and on
  bytes, bytearray and ndarray; HDLC unstuffing on valid stuffed streams
  and on 2 000 seeded random bit streams (same frames, same error, same
  order, and equal to the JAX package's C and Python); the descrambler
  against fec/scramble.py; the raw-frame parser against the Python
  decoder, and under fuzz (truncated and corrupt records, no crash).
* A burst of more than 64 frames: the C path yields the first 64 frames,
  as the JAX package's default (native) path does; the Python spec
  yields all of them.
* The slice end to end: the 8-channel, oversample-20 correctness vector
  of chip_smoke.py through the port's gated VDL2Pipeline(device="cpu")
  gives frames byte-identical to the JAX package's gated pipeline, with
  the library on and with DUMPVDL2_TPU_NATIVE=0; a --raw-frames-file
  replay through both CLIs gives byte-identical text and JSON.
* The loader: the library lands in _build/ under a hashed name; a build
  that no compiler can make raises (in the loader, in each wrapper and
  in the parallel decoder's parent) and nothing falls back to Python;
  DUMPVDL2_TPU_NATIVE=0 builds nothing and runs the Python spec.
* The NCO-mix oracle: mix_nco and mix_filter_decimate_impl against the
  JAX package's (atol 2e-5), and the port's channelizer against it, on
  the inputs of tests/test_dsp.py.

Every comparison but the channelizer's is exact.  The tests skip only
where no C compiler is on PATH, as tests/test_native.py does.
"""
import ctypes
import importlib.util
import os
import re
import shutil

import numpy as np
import pytest
import torch
from _torch_port import assert_frames_match, one_torch_thread  # noqa: F401

from dumpvdl2_tpu.dsp import frontend as jfe
from dumpvdl2_tpu.dsp.chebyshev import fir_taps
from dumpvdl2_tpu.io import rawframes as jrf
from dumpvdl2_tpu.link import crc as jcrc
from dumpvdl2_tpu.link import unstuff as junstuff
from dumpvdl2_tpu_torch import native
from dumpvdl2_tpu_torch.constants import LFSR_IV
from dumpvdl2_tpu_torch.core.metadata import MsgMetadata
from dumpvdl2_tpu_torch.dsp import frontend as tfe
from dumpvdl2_tpu_torch.fec.scramble import PRBS
from dumpvdl2_tpu_torch.io import rawframes as rf
from dumpvdl2_tpu_torch.link import crc
from dumpvdl2_tpu_torch.link import unstuff
from dumpvdl2_tpu_torch.sim import stuff_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTER = 136975000


@pytest.fixture(scope="module")
def lib():
    if not any(shutil.which(c) for c in ("cc", "gcc", "clang")):
        pytest.skip("no C compiler on PATH to build the native host library")
    lib = native.load_l2host()
    assert lib is not None
    return lib


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """The loader and the three wrappers as before their first call,
    building into ``tmp_path``; monkeypatch restores them after."""
    monkeypatch.setattr(native, "BUILD", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(crc, "_LIB", None)
    monkeypatch.setattr(crc, "_LIB_TRIED", False)
    monkeypatch.setattr(crc, "_CRC_FN", None)
    monkeypatch.setattr(rf, "_NATIVE_LIB", False)
    return tmp_path


def _frames(gen):
    """(frames as lists, "err" or None) of a frames_from_bits generator."""
    frames = []
    try:
        for f in gen:
            frames.append(f.tolist())
        return frames, None
    except (unstuff.UnstuffError, junstuff.UnstuffError):
        return frames, "err"


def _crc_py(data: bytes, init: int = 0xFFFF) -> int:
    c = init
    for b in data:
        c = (c >> 8) ^ int(crc.CRC_TABLE[(c ^ b) & 0xFF])
    return c


# ------------------------------------------------- port C vs port Python
@pytest.mark.parametrize("kind", [bytes, bytearray, np.asarray])
def test_crc_native_matches_spec(lib, kind):
    rng = np.random.default_rng(8)
    before = native.calls["l2h_crc16_ccitt"]
    for n in (0, 1, 7, 138, 256, 1000, 4096):
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        data = kind(raw) if kind is not np.asarray \
            else np.frombuffer(raw, np.uint8)
        for init in (0xFFFF, 0):
            want = _crc_py(raw, init)
            assert crc.crc16_ccitt(data, init) == want, (n, init)
            assert jcrc.crc16_ccitt(raw, init) == want
            if n:
                assert lib.l2h_crc16_ccitt(raw, n, init) == want
    # every non-empty input went through the library
    assert native.calls["l2h_crc16_ccitt"] - before == 12


@pytest.mark.parametrize("sizes", [[4], [16, 32], [1, 2, 3], [200, 1990]])
def test_unstuff_native_matches_spec_on_valid_streams(lib, sizes):
    rng = np.random.default_rng(sum(sizes))
    frames = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
              for s in sizes]
    bits = stuff_frames(frames)
    got = _frames(unstuff._frames_native(bits, lib))
    assert got == _frames(unstuff._frames_py(bits))
    assert got == _frames(junstuff.frames_from_bits(bits))
    assert [bytes(np.packbits(np.array(f, np.uint8), bitorder="little"))
            for f in got[0] if f] == frames


def test_unstuff_fuzz_port_c_python_and_jax(lib):
    """2 000 seeded random streams, with flags and runs of seven ones
    written in: the port's C, the port's Python spec, the JAX package's
    default path (its C) and its Python spec give the same frames, the
    same error and the same order."""
    rng = np.random.default_rng(2000)
    errs = 0
    for trial in range(2000):
        n = int(rng.integers(0, 300))
        bits = rng.integers(0, 2, n, dtype=np.uint8)
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, max(n - 8, 1)))
            bits[p:p + 7] = rng.choice(
                [np.array([0, 1, 1, 1, 1, 1, 1]),
                 np.array([1, 1, 1, 1, 1, 1, 0])])[:max(0, n - p)]
        want = _frames(unstuff._frames_py(bits))
        assert _frames(unstuff.frames_from_bits(bits)) == want, trial
        assert _frames(junstuff.frames_from_bits(bits)) == want, trial
        assert _frames(junstuff._frames_py(bits)) == want, trial
        errs += want[1] == "err"
    assert 0 < errs < 2000


@pytest.mark.parametrize("tail", ["clean", "bad_tail"])
def test_more_than_64_frames_as_the_jax_package(lib, tail):
    """l2h_unstuff_frames records at most 64 frame lengths: the C path
    yields the first 64 of a 70-frame burst (and still reports an error
    that follows them), exactly as the JAX package's default path does;
    the Python spec yields all 70."""
    frames = [bytes([i, 0x7E ^ i]) for i in range(70)]
    bits = stuff_frames(frames)
    if tail == "bad_tail":
        bits = np.concatenate([bits, np.ones(8, np.uint8)])
    got = _frames(unstuff.frames_from_bits(bits))
    jax_default = _frames(junstuff.frames_from_bits(bits))
    spec = _frames(unstuff._frames_py(bits))
    assert got == jax_default
    assert len(got[0]) == 64 and got[0] == spec[0][:64]
    assert len([f for f in spec[0] if f]) == 70
    assert got[1] == spec[1] == (None if tail == "clean" else "err")


def test_descramble_matches_prbs(lib):
    rng = np.random.default_rng(8)
    bits = np.ascontiguousarray(rng.integers(0, 2, 5000, dtype=np.uint8))
    ref = bits ^ PRBS[:5000]
    lib.l2h_descramble(bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       5000, LFSR_IV)
    np.testing.assert_array_equal(bits, ref)


def _meta_frames(n: int, seed: int):
    """(MsgMetadata, frame) pairs with every field drawn from ``seed``."""
    r = np.random.default_rng(seed)
    for i in range(n):
        md = MsgMetadata(
            version=int(r.integers(0, 3)),
            station_id=None if i % 3 else "ST-%d" % i,
            freq=int(r.integers(0, 1 << 31)),
            frame_pwr_dbfs=float(r.normal()) if i % 2 else 0.0,
            nf_pwr_dbfs=float(r.normal()),
            ppm_error=float(r.normal()),
            burst_timestamp=float(r.integers(0, 1 << 40)) / 64.0,
            datalen_octets=int(r.integers(0, 4000)),
            synd_weight=int(r.integers(0, 3)),
            num_fec_corrections=int(r.integers(0, 30)),
            idx=int(r.integers(0, 8)))
        yield md, r.integers(0, 256, int(r.integers(0, 300)),
                             dtype=np.uint8).tobytes()


_FIELDS = ("version", "station_id", "freq", "datalen_octets", "synd_weight",
           "num_fec_corrections", "idx", "frame_pwr_dbfs", "nf_pwr_dbfs",
           "ppm_error", "burst_timestamp")


def _decoded(d) -> tuple:
    return (bytes(d.frame),) + tuple(getattr(d.metadata, f) for f in _FIELDS)


def test_raw_frame_parser_matches_spec(lib, monkeypatch):
    """Every field equal, the floats as the wire's float32, the
    timestamp as sec + usec / 1e6 in both; a truncated body raises the
    spec's IndexError with the library on and off."""
    bodies = [rf.encode_raw_frame(md, fr)
              for md, fr in _meta_frames(200, seed=9)]
    before = native.calls["l2h_parse_raw_frame"]
    nat = [_decoded(rf.decode_raw_frame(b)) for b in bodies]
    assert native.calls["l2h_parse_raw_frame"] - before == len(bodies)
    monkeypatch.setattr(rf, "_NATIVE_LIB", None)     # the Python spec
    assert nat == [_decoded(rf.decode_raw_frame(b)) for b in bodies]
    with pytest.raises(IndexError):
        rf.decode_raw_frame(b"\xff\xff\xff\xff")
    monkeypatch.setattr(rf, "_NATIVE_LIB", lib)
    with pytest.raises(IndexError):
        rf.decode_raw_frame(b"\xff\xff\xff\xff")


def test_raw_frame_parser_fuzz_no_crash(lib):
    """Random bytes, truncations at every byte and length varints with
    bit 63 set never crash the parser; where it accepts a body, its
    offsets lie inside it and the decoded frame is the Python spec's."""
    m = rf._RawMeta()
    r = np.random.default_rng(0xF00D)
    bodies = [r.integers(0, 256, int(n), dtype=np.uint8).tobytes()
              for n in r.integers(0, 64, 300)]
    bodies += [b"\x0a" + b"\xff" * 9 + b"\x01" + b"payload",
               b"\x0a\xff\xff\xff\xff\x0f" + b"x",
               b"\x12" + b"\xff" * 9 + b"\x01"]
    inner = b"\x0a" + b"\xff" * 9 + b"\x01"
    bodies.append(bytes([0x0a, len(inner)]) + inner)
    good = rf.encode_raw_frame(MsgMetadata(freq=136975000, station_id="XX",
                                           burst_timestamp=1.5), b"frame!")
    bodies += [good[:k] for k in range(len(good))]
    accepted = 0
    for body in bodies:
        rc = lib.l2h_parse_raw_frame(body, len(body), ctypes.byref(m))
        assert rc in (0, -1)
        if rc == 0:
            accepted += 1
            assert 0 <= m.frame_off <= len(body)
            assert 0 <= m.frame_len <= len(body) - m.frame_off
            assert 0 <= m.station_off <= len(body)
            assert 0 <= m.station_len <= len(body) - m.station_off
            assert body[m.frame_off:m.frame_off + m.frame_len] == \
                _spec_frame(body)
    assert accepted > 0


def _spec_frame(body: bytes) -> bytes:
    saved = rf._NATIVE_LIB
    rf._NATIVE_LIB = None
    try:
        return bytes(rf.decode_raw_frame(body).frame)
    finally:
        rf._NATIVE_LIB = saved


def test_raw_meta_layout():
    assert rf._RAWMETA_FMT.format == jrf._RAWMETA_FMT.format == "=d3f4x6Q4i"
    assert ctypes.sizeof(rf._RawMeta) == rf._RAWMETA_FMT.size == 88
    assert [f[0] for f in rf._RawMeta._fields_] == \
        [f[0] for f in jrf._RawMeta._fields_]


# ------------------------------------------------------ port vs JAX
def test_decode_raw_frame_matches_jax(lib, monkeypatch):
    """An archive the port's frame_record writes decodes to the same
    frames through the port's parser (C and Python) and the JAX
    package's."""
    import io
    archive = b"".join(rf.frame_record(md, fr)
                       for md, fr in _meta_frames(150, seed=21))
    port = [_decoded(d) for d in rf.read_records(io.BytesIO(archive))]
    jax_ = [_decoded(d) for d in jrf.read_records(io.BytesIO(archive))]
    assert port == jax_ and len(port) == 150
    monkeypatch.setattr(rf, "_NATIVE_LIB", None)     # the Python spec
    assert [_decoded(d) for d in rf.read_records(io.BytesIO(archive))] \
        == port


# ------------------------------------------------------ end to end
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def vector_runs(lib):
    """The correctness vector through JAX's gated pipeline (device L2)
    and the port's, once with the library and once without."""
    from dumpvdl2_tpu.core.pipeline import VDL2Pipeline as JaxPipeline
    from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
    sig, fs, os_, freqs, vector = _chip_smoke().vector_signal()
    block = 20_000 * os_

    def feed(pipe):
        out = []
        for off in range(0, sig.size, block):
            out += pipe.feed(sig[off:off + block])
        return out + pipe.finish()

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DUMPVDL2_TPU_L2", "1")
            mp.delenv("DUMPVDL2_TPU_GATE", raising=False)
            jp = JaxPipeline(freqs, CENTER, fs, os_)
            assert jp.use_device_l2 and jp.use_device_gate
            runs["jax"] = feed(jp)
            before = dict(native.calls)
            runs["port"] = feed(VDL2Pipeline(freqs, CENTER, fs, os_,
                                             device="cpu"))
            runs["port_calls"] = native.calls["l2h_unstuff_frames"] \
                - before["l2h_unstuff_frames"]
            mp.setenv("DUMPVDL2_TPU_NATIVE", "0")
            mp.setattr(native, "_lib", None)
            mp.setattr(native, "_tried", False)
            py_calls = []
            orig = unstuff._frames_py
            mp.setattr(unstuff, "_frames_py",
                       lambda b: py_calls.append(1) or orig(b))
            runs["spec"] = feed(VDL2Pipeline(freqs, CENTER, fs, os_,
                                             device="cpu"))
            runs["spec_calls"] = len(py_calls)
    finally:
        torch.set_num_threads(threads)
    runs["vector"] = vector
    return runs


def test_vector_frames_native_equal_jax_and_spec(vector_runs):
    from dumpvdl2_tpu_torch.sim import frame_with_fcs
    port, jax_, spec = (vector_runs[k] for k in ("port", "jax", "spec"))
    assert_frames_match(port, jax_)
    assert_frames_match(spec, jax_)
    got = {(bytes(f.frame), f.metadata.freq) for f in port}
    for _, payload, _, off in vector_runs["vector"]:
        assert (frame_with_fcs(payload), int(CENTER + off)) in got
    # each run went through the path it names
    assert vector_runs["port_calls"] >= 3
    assert vector_runs["spec_calls"] >= 3


@pytest.fixture(scope="module")
def replay_runs(lib, tmp_path_factory):
    """A --raw-frames-file replay of the committed corpus through both
    CLIs, in process, each writing text and JSON; the port once with
    the library and once with DUMPVDL2_TPU_NATIVE=0."""
    from test_golden_full import FIXTURES

    from dumpvdl2_tpu import config as jconfig
    from dumpvdl2_tpu.app import cli as jcli
    from dumpvdl2_tpu_torch import config
    from dumpvdl2_tpu_torch.app import cli
    corpus = os.path.join(FIXTURES, "proto_corpus.frames")
    d = tmp_path_factory.mktemp("replay")
    out = {}
    jconfig.reset_config()
    config.reset_config()
    try:
        for name, mod, off in (("jax", jcli, False), ("port", cli, False),
                               ("spec", cli, True)):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(mod, "setup_signals", lambda: None)
                if off:
                    mp.setenv("DUMPVDL2_TPU_NATIVE", "0")
                    mp.setattr(native, "_lib", None)
                    mp.setattr(native, "_tried", False)
                    mp.setattr(crc, "_LIB_TRIED", False)
                    mp.setattr(crc, "_CRC_FN", None)
                    mp.setattr(rf, "_NATIVE_LIB", False)
                txt, js = d / f"{name}.txt", d / f"{name}.json"
                argv = ["--raw-frames-file", corpus, "--extended-header",
                        "--utc", "--output", f"decoded:text:file:path={txt}",
                        "--output", f"decoded:json:file:path={js}"]
                if mod is cli:
                    argv = ["--platform", "cpu"] + argv
                before = dict(native.calls)
                assert mod.main(argv) == 0
                out[name] = (txt.read_bytes(), js.read_bytes(),
                             {k: native.calls[k] - before[k]
                              for k in before})
    finally:
        jconfig.reset_config()
        config.reset_config()
    return out


@pytest.mark.parametrize("run", ["port", "spec"])
def test_raw_frames_replay_equals_jax_cli(replay_runs, run):
    txt, js, calls = replay_runs[run]
    assert txt == replay_runs["jax"][0] and len(txt) > 10_000
    assert js == replay_runs["jax"][1] and len(js) > 10_000
    if run == "port":
        assert calls["l2h_parse_raw_frame"] > 0
        assert calls["l2h_crc16_ccitt"] > 0
    else:
        assert not any(calls.values()), calls


# ------------------------------------------------------ the loader
def test_library_lands_in_build_under_a_hashed_name(lib, monkeypatch):
    path = native.lib_path()
    assert path.parent == native.BUILD
    assert native.BUILD.name == "_build" and \
        native.BUILD.parent.name == "dumpvdl2_tpu_torch"
    assert re.fullmatch(r"l2host\.[0-9a-f]{12}\.so", path.name)
    assert path.exists() and lib._name == str(path)
    monkeypatch.setattr(native, "CFLAGS", native.CFLAGS + ["-g"])
    assert native.lib_path() != path


def test_build_into_a_fresh_directory(lib, fresh):
    info = native.build()
    assert info["compiler"] in (os.environ.get("CC"), "cc", "gcc", "clang")
    assert info["path"] == str(native.lib_path())
    assert [p.name for p in fresh.iterdir()] == [native.lib_path().name]
    again = native.build()
    assert again["compiler"] is None and again["path"] == info["path"]
    assert native.load_l2host()._name == info["path"]


def test_failed_build_raises_and_nothing_falls_back(fresh, monkeypatch,
                                                     tmp_path_factory):
    from dumpvdl2_tpu_torch.app.parallel_decoder import ParallelFrameDecoder
    monkeypatch.setenv("CC", "/bin/false")
    monkeypatch.setenv("PATH", str(tmp_path_factory.mktemp("empty")))
    monkeypatch.delenv("DUMPVDL2_TPU_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="cannot build") as e:
        native.load_l2host()
    assert "/bin/false exited 1" in str(e.value)
    assert "cc:" in str(e.value)
    bits = stuff_frames([b"frame"])
    with pytest.raises(RuntimeError, match="cannot build"):
        list(unstuff.frames_from_bits(bits))
    for _ in range(2):        # a failure is not remembered as "Python"
        with pytest.raises(RuntimeError, match="cannot build"):
            crc.crc16_ccitt(b"frame")
        with pytest.raises(RuntimeError, match="cannot build"):
            rf.decode_raw_frame(rf.encode_raw_frame(MsgMetadata(), b"x"))
    with pytest.raises(RuntimeError, match="cannot build"):
        ParallelFrameDecoder([], workers=1)
    assert native._tried is False and native._lib is None
    assert list(fresh.iterdir()) == []


def test_native_off_builds_nothing_and_runs_the_spec(fresh, monkeypatch):
    monkeypatch.setenv("DUMPVDL2_TPU_NATIVE", "0")
    monkeypatch.setenv("CC", "/bin/false")
    before = dict(native.calls)
    py_calls = []
    orig = unstuff._frames_py
    monkeypatch.setattr(unstuff, "_frames_py",
                        lambda b: py_calls.append(1) or orig(b))
    assert native.load_l2host() is None
    frames = [b"spec path", b"\x7e\x7e\xff"]
    bits = stuff_frames(frames)
    got = [np.packbits(f, bitorder="little").tobytes()
           for f in unstuff.frames_from_bits(bits) if f.size]
    assert got == frames and py_calls == [1]
    assert crc.crc16_ccitt(b"spec path") == _crc_py(b"spec path")
    body = rf.encode_raw_frame(MsgMetadata(freq=136975000), b"spec")
    assert bytes(rf.decode_raw_frame(body).frame) == b"spec"
    assert native.calls == before
    assert list(fresh.iterdir()) == []


# ------------------------------------------------------ the NCO-mix oracle
@pytest.mark.parametrize("os_,fs", [(10, 1.05e6), (20, 2.1e6)])
def test_mix_oracle_matches_jax_and_the_channelizer(os_, fs):
    """tests/test_dsp.py's inputs: the port's mix_nco and
    mix_filter_decimate_impl equal the JAX package's within atol 2e-5,
    and the port's bandpass_channelize equals the port's oracle within
    atol 2e-5, its raw carry exactly."""
    import jax.numpy as jnp
    taps_np = jfe.prepare_taps(fir_taps(fs), os_)
    T = taps_np.size
    dphi_np = np.array([jfe.nco_dphi(CENTER, CENTER - 25e3 * i, fs)
                        for i in range(3)], np.uint32)
    rng = np.random.default_rng(1)
    N = 200 * os_
    iq_np = rng.standard_normal((2, N)).astype(np.float32)
    prev_np = rng.standard_normal((2, T - 1)).astype(np.float32)
    n0 = 12345
    n_prev = (n0 - (T - 1)) & 0xFFFFFFFF

    j_carry = jfe.mix_nco(jnp.asarray(prev_np), jnp.asarray(dphi_np),
                          jnp.uint32(n_prev))
    j_dec, j_new = jfe.mix_filter_decimate_impl(
        jnp.asarray(iq_np), jnp.asarray(taps_np), jnp.asarray(dphi_np),
        jnp.uint32(n0), j_carry, os_)

    taps, dphi = torch.as_tensor(taps_np), torch.as_tensor(
        dphi_np.astype(np.int64))
    iq, prev = torch.as_tensor(iq_np), torch.as_tensor(prev_np)
    t_carry = tfe.mix_nco(prev, dphi, n_prev)
    assert t_carry.shape == (2, 3, T - 1) and t_carry.dtype == torch.float32
    np.testing.assert_allclose(t_carry.numpy(), np.asarray(j_carry),
                               atol=2e-5)
    t_dec, t_new = tfe.mix_filter_decimate_impl(iq, taps, dphi, n0,
                                                t_carry, os_)
    assert t_dec.shape == (2, 3, N // os_)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), atol=2e-5)
    np.testing.assert_allclose(t_new.numpy(), np.asarray(j_new), atol=2e-5)

    b_dec, b_carry = tfe.bandpass_channelize(iq, taps, dphi, n0, prev, os_)
    np.testing.assert_allclose(b_dec.numpy(), t_dec.numpy(), atol=2e-5)
    np.testing.assert_array_equal(b_carry.numpy(), iq_np[:, N - (T - 1):])
