"""The SDR drivers (io/rtl, mirics, sdrplay, sdrplay3, sdr): the JAX
package's and the port's copies give the same calls.

The tests need no radio: the drivers run against the fake devices of
tests/test_rtl.py, test_mirics.py, test_sdrplay.py and
test_soapysdr.py, imported from there.  Each check
of those files runs parametrized over the JAX package's module and the
port's, and the configure sequences of both must be equal call for
call.  The read loops (RTL-SDR and Mirics through a fake vendor
library, SoapySDR through the fake module) feed a synthesized burst to
the port's VDL2Pipeline (device="cpu"), which must decode it, and both
packages' drivers must hand it the same blocks.
"""
import ctypes
import importlib
import sys

import numpy as np
import pytest
from _torch_port import one_torch_thread  # noqa: F401
from test_mirics import FakeMiri
from test_rtl import FakeDev
from test_sdrplay import _fake_params
from test_soapysdr import Args, FakeDecoder, FakePipeline  # noqa: F401
from test_soapysdr import fake_soapy  # noqa: F401

from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
from dumpvdl2_tpu_torch.sim import frame_with_fcs, synthesize_iq_raw

CENTER = 136975000
PKGS = ("dumpvdl2_tpu", "dumpvdl2_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.io.{name}")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


# --------------------------------------------------------------- RTL-SDR
def test_rtl_device_search(pkg):
    rtl = _mod(pkg, "rtl")
    dev = FakeDev()
    assert rtl.verbose_device_search("1", dev) == 1
    assert rtl.verbose_device_search("0x0", dev) == 0
    dev = FakeDev(serials=["00000001", "DV123456", "ABCD9999"])
    assert rtl.verbose_device_search("DV123456", dev) == 1   # exact
    assert rtl.verbose_device_search("ABCD", dev) == 2       # prefix
    assert rtl.verbose_device_search("9999", dev) == 2       # suffix
    assert rtl.verbose_device_search("XYZZY", dev) == -1
    # 8-char numeric strings try serial match first (rtl.c:76-77)
    dev = FakeDev(serials=["00000001", "00000000"])
    assert rtl.verbose_device_search("00000000", dev) == 1


def test_rtl_nearest_gain(pkg):
    rtl = _mod(pkg, "rtl")
    dev = FakeDev()
    assert [rtl.nearest_gain(dev, g) for g in (280, 300, 10000, -50)] == \
        [280, 297, 496, 0]


@pytest.mark.parametrize("gain,bias", [(29.7, 1), (-100.0, 0), (20.0, 0)])
def test_rtl_configure_sequences_equal(gain, bias):
    calls = []
    for pkg in PKGS:
        dev = FakeDev()
        _mod(pkg, "rtl").rtl_configure(dev, 0, 1050000, CENTER, 0, gain,
                                       1, bias)
        calls.append(dev.calls)
    assert calls[0] == calls[1]
    names = [c[0] for c in calls[1]]
    for name in ("set_sample_rate", "set_center_freq",
                 "set_freq_correction", "set_agc_mode", "reset_buffer"):
        assert name in names
    assert ("set_bias_tee", bias) in calls[1]
    if gain == -100.0:
        assert ("set_tuner_gain_mode", 0) in calls[1]
        assert "set_tuner_gain" not in names
    elif gain == 29.7:
        assert ("set_tuner_gain", 297) in calls[1]


def test_rtl_configure_failure_raises(pkg):
    dev = FakeDev()
    dev.fail.add("set_center_freq")
    with pytest.raises(RuntimeError):
        _mod(pkg, "rtl").rtl_configure(dev, 0, 1050000, CENTER, 0, 20.0,
                                       0, 0)


def test_rtl_constants(pkg):
    rtl = _mod(pkg, "rtl")
    assert (rtl.RTL_BUFSIZE, rtl.RTL_OVERSAMPLE) == (320000, 10)


# ---------------------------------------------------------------- Mirics
@pytest.mark.parametrize("hw,usb,gain,corr", [(1, 1, 40.0, 100),
                                              (0, 0, -100.0, 0)])
def test_mirics_configure_sequences_equal(hw, usb, gain, corr):
    calls = []
    for pkg in PKGS:
        dev = FakeMiri()
        _mod(pkg, "mirics").mirics_configure(dev, 0, hw, usb, 1365000,
                                             CENTER, gain, corr)
        calls.append(dev.calls)
    assert calls[0] == calls[1]
    assert ("set_transfer", b"BULK" if usb else b"ISOC") in calls[1]
    assert ("set_center_freq", CENTER - corr) in calls[1]
    if gain > 0:
        assert ("set_tuner_gain", 40) in calls[1]
    else:
        assert ("set_tuner_gain_mode", 0) in calls[1]


def test_mirics_invalid_params_and_constants(pkg):
    mirics = _mod(pkg, "mirics")
    for hw, usb in ((7, 0), (0, 9)):
        with pytest.raises(RuntimeError):
            mirics.mirics_configure(FakeMiri(), 0, hw, usb, 1365000,
                                    CENTER, 40.0, 0)
    assert (mirics.MIRISDR_BUFSIZE, mirics.MIRISDR_OVERSAMPLE) == \
        (320000, 13)


# ----------------------------------------------------- SDRPlay v2 and v3
def test_sdrplay_v2_gain_and_device_search(pkg):
    sp = _mod(pkg, "sdrplay")
    assert [sp.hw_type_from_hwver(v) for v in (1, 2, 3, 254, 255, 4)] == \
        [sp.HW_RSP1, sp.HW_RSP2, sp.HW_RSPDUO, sp.HW_RSP1A, sp.HW_RSP1A,
         None]
    for hw, gr, want in ((sp.HW_RSP1A, 40, (40, 0)),
                         (sp.HW_RSP1A, 70, (58, 2)),
                         (sp.HW_RSP1, 20, (20, 0)),
                         (sp.HW_RSP2, 85, (51, 5)),
                         (sp.HW_RSPDUO, 121, (59, 9))):
        assert sp.select_gain_reduction(hw, gr) == want
    with pytest.raises(ValueError, match="min=20 max=102"):
        sp.select_gain_reduction(sp.HW_RSP1, 150)
    with pytest.raises(ValueError, match="min=20 max=140"):
        sp.select_gain_reduction(sp.HW_RSP1A, 19)
    devices = [("1234567890", True, 2), ("ABCDEF", True, 3)]
    assert [sp.verbose_device_search(s, devices)
            for s in ("1", "ABCDEF", "1234567890", "nope", "5")] == \
        [1, 1, 0, -1, -1]
    assert sp.verbose_device_search("0", [("SN1", False, 2)]) == -1
    assert sp.verbose_device_search("0", [("SN1", True, 77)]) == -1
    assert (sp.SDRPLAY_OVERSAMPLE, sp.SDRPLAY_DEFAULT_AGC_SETPOINT) == \
        (20, -30)


def test_sdrplay_v3_parameter_routing(pkg):
    sp3 = _mod(pkg, "sdrplay3")
    for hwver, target in ((sp3.RSP2_ID, "ch.rsp2TunerParams.biasTEnable"),
                          (sp3.RSP1A_ID, "ch.rsp1aTunerParams.biasTEnable"),
                          (sp3.RSPduo_ID,
                           "ch.rspDuoTunerParams.biasTEnable"),
                          (sp3.RSPdx_ID, "dev.rspDxParams.biasTEnable")):
        dev, ch = _fake_params()
        assert sp3.set_biast(dev, ch, hwver)
        assert eval(target, {"dev": dev, "ch": ch}) == 1
    dev, ch = _fake_params()
    assert not sp3.set_biast(dev, ch, sp3.RSP1_ID)
    assert sp3.set_notch_filter(dev, ch, sp3.RSP1A_ID)
    assert dev.rsp1aParams.rfNotchEnable == 1
    assert sp3.set_dab_notch_filter(dev, ch, sp3.RSPduo_ID)
    assert ch.rspDuoTunerParams.rfDabNotchEnable == 1
    assert sp3.select_antenna(dev, ch, sp3.RSP2_ID, "B")
    assert ch.rsp2TunerParams.antennaSel == 6
    assert not sp3.select_antenna(dev, ch, sp3.RSP1A_ID, "A")


def test_sdrplay_v3_gain_and_device_search(pkg):
    sp3 = _mod(pkg, "sdrplay3")
    dev, ch = _fake_params()
    sp3.configure_gain(ch, -100, 0, 0)
    assert (ch.ctrlParams.agc.enable, ch.ctrlParams.agc.setPoint_dBfs) == \
        (3, -30)
    sp3.configure_gain(ch, 40, 3, 0)
    assert (ch.ctrlParams.agc.enable, ch.tunerParams.gain.gRdB,
            ch.tunerParams.gain.LNAstate) == (0, 40, 3)
    devices = [("1", sp3.RSPdx_ID), ("SN9", sp3.RSP1A_ID)]
    assert [sp3.verbose_device_search(s, devices)
            for s in ("1", "SN9", "0", "XX")] == [0, 1, 0, -1]
    assert ctypes.sizeof(sp3._StreamCbParamsT) == 24
    assert sp3._DeviceParamsT.rxChannelA.offset == \
        ctypes.sizeof(ctypes.c_void_p)


def test_stream_bridge(pkg):
    bridge = _mod(pkg, "sdrplay_common").StreamBridge()
    xi = (ctypes.c_short * 4)(1000, 2000, 3000, 4000)
    xq = (ctypes.c_short * 4)(-1000, -2000, -3000, -4000)
    bridge.push(xi, xq, 4)
    bridge.stop()
    blocks = list(bridge.blocks(lambda: False, min_samples=1))
    assert len(blocks) == 1 and blocks[0].dtype == np.complex64
    np.testing.assert_allclose(blocks[0] * 32768.0,
                               np.array([1, 2, 3, 4]) * (1000 - 1000j),
                               atol=1e-3)


def test_sdrplay_runners_fail_without_library(pkg, capsys, monkeypatch):
    from dumpvdl2_tpu_torch.app import cli
    args = cli.build_parser().parse_args(
        ["--sdrplay3", "XX123", "--ifgr", "40", "--lna-state", "2",
         "--agc", "-35", "--biast", "1", "--dab-notch-filter", "1",
         "--tuner", "2", "--sdrplay", "0", "--gr", "50"])
    sp, sp3 = _mod(pkg, "sdrplay"), _mod(pkg, "sdrplay3")
    monkeypatch.setattr(sp3, "load_sdrplay_api", lambda: None)
    monkeypatch.setattr(sp, "load_libmirsdr", lambda: None)
    assert sp3.run_sdrplay3(args, None, None) == 1
    assert sp.run_sdrplay(args, None, None) == 1
    assert "not found" in capsys.readouterr().err


# -------------------------------------------------------------- SoapySDR
def test_soapy_configure_sequences_equal(fake_soapy):  # noqa: F811
    cases = [Args(gain=32.8, correction=1.5, bandwidth=300000,
                  antenna="Tuner 1 50 ohm",
                  device_settings="biastee=true,rfnotch_ctrl=false"),
             Args(gain=20.0, antenna="A", soapy_antenna="RX2"),
             Args(), Args(gain=40.0, soapy_gain="LNA=20,VGA=12.5")]
    for args in cases:
        calls, oks = [], []
        for pkg in PKGS:
            dev = fake_soapy.Device(args.soapysdr)
            oks.append(_mod(pkg, "sdr").configure_device(
                fake_soapy, dev, args, FakePipeline()))
            calls.append(dev.calls)
        assert oks == [True, True] and calls[0] == calls[1]
    assert ("setGainElement", "VGA", 12.5) in calls[1]
    dev = fake_soapy.Device("x")
    assert not _mod(PKGS[1], "sdr").configure_device(
        fake_soapy, dev, Args(soapy_gain="LNA20"), FakePipeline())
    dev.has_gain_mode = False
    assert not _mod(PKGS[1], "sdr").configure_device(
        fake_soapy, dev, Args(), FakePipeline())


def test_soapy_failures(pkg, fake_soapy, monkeypatch):  # noqa: F811
    sdr = _mod(pkg, "sdr")
    orig = fake_soapy.Device

    def failing(query):
        dev = orig(query)
        dev.read_plan = [-1]
        return dev

    fake_soapy.Device = failing
    assert sdr.run_soapysdr(Args(gain=10.0), FakeDecoder(),
                            FakePipeline()) == 1
    monkeypatch.setitem(sys.modules, "SoapySDR", None)
    assert sdr.run_soapysdr(Args(), FakeDecoder(), FakePipeline()) == 1


# ------------------------------------------------------------ read loops
PAYLOAD = b"sdr read loop through the port pipeline"


class Recorder:
    """The port's VDL2Pipeline on the CPU, recording each block fed."""

    def __init__(self, oversample):
        self.pipe = VDL2Pipeline([CENTER], CENTER, 105000 * oversample,
                                 oversample, device="cpu")
        self.sample_rate, self.centerfreq = self.pipe.sample_rate, CENTER
        self.blocks = []

    def feed(self, iq, eof=False):
        self.blocks.append(np.array(iq))
        return self.pipe.feed(iq, eof=eof)

    def finish(self):
        return self.pipe.finish()


class Collect:
    def __init__(self):
        self.frames = []

    def process_all(self, frames):
        self.frames += list(frames)


def _signal(oversample, n):
    rng = np.random.default_rng(3)
    sig = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
           * 0.01).astype(np.complex64)
    burst = synthesize_iq_raw([PAYLOAD], oversample=oversample, seed=4)
    sig[40_000:40_000 + burst.size] += burst * 0.4
    return sig


class FakeVendorLib:
    """librtlsdr / libmirisdr-4 as the drivers call them: one device,
    reads served from ``chunks``; ``stop`` runs after the last."""

    def __init__(self, prefix, chunks, stop):
        self.prefix, self.chunks, self.stop = prefix, list(chunks), stop

    def __getattr__(self, name):
        op = name[len(self.prefix):]
        if op == "get_device_count":
            return lambda: 1
        if op == "get_device_usb_strings":
            def strings(i, v, p, s):
                v.value, p.value, s.value = b"Vendor", b"Fake", b"00000001"
                return 0
            return strings
        if op == "get_device_name":
            return lambda i: b"Fake device"
        if op == "read_sync":
            def read(dev, buf, size, n_read):
                chunk = self.chunks.pop(0)
                ctypes.memmove(buf, chunk.ctypes.data, chunk.nbytes)
                n_read._obj.value = chunk.nbytes
                if not self.chunks:
                    self.stop()
                return 0
            return read
        return lambda *a: 0


@pytest.mark.parametrize("driver", ["rtl", "mirics"])
def test_vendor_read_loop_feeds_port_pipeline(driver, monkeypatch):
    blocks = []
    for pkg in PKGS:
        mod = _mod(pkg, driver)
        cli = importlib.import_module(f"{pkg}.app.cli")
        if driver == "rtl":
            os_, size = mod.RTL_OVERSAMPLE, mod.RTL_BUFSIZE
            sig = _signal(os_, 2 * size // 2)
            raw = np.clip(np.round(np.stack([sig.real, sig.imag], 1)
                                   .reshape(-1) * 127.5 + 127.5), 0, 255)
            raw = raw.astype(np.uint8)
            args = cli.build_parser().parse_args(["--rtlsdr", "0"])
            args.gain, prefix, load, run = (mod.SDR_AUTO_GAIN, "rtlsdr_",
                                            "load_librtlsdr", "run_rtlsdr")
        else:
            os_, size = mod.MIRISDR_OVERSAMPLE, mod.MIRISDR_BUFSIZE
            sig = _signal(os_, 2 * size // 4)
            raw = np.round(np.stack([sig.real, sig.imag], 1).reshape(-1)
                           * 32767).astype("<i2")
            args = cli.build_parser().parse_args(["--mirisdr", "0"])
            args.gain, prefix, load, run = (mod.SDR_AUTO_GAIN, "mirisdr_",
                                            "load_libmirisdr", "run_mirics")
        chunks = np.split(raw, 2)
        lib = FakeVendorLib(prefix, chunks,
                            lambda: monkeypatch.setattr(cli, "_do_exit", 1))
        monkeypatch.setattr(mod, load, lambda: lib)
        monkeypatch.setattr(cli, "_do_exit", 0)
        pipe, dec = Recorder(os_), Collect()
        assert getattr(mod, run)(args, dec, pipe) == 0
        assert [bytes(f.frame) for f in dec.frames] == \
            [frame_with_fcs(PAYLOAD)]
        blocks.append(pipe.blocks)
    assert len(blocks[0]) == len(blocks[1]) == 2
    for a, b in zip(*blocks):
        np.testing.assert_array_equal(a, b)


def test_soapy_read_loop_feeds_port_pipeline(fake_soapy):  # noqa: F811
    sig = _signal(10, 300_000)
    inter = np.round(np.stack([sig.real, sig.imag], 1).reshape(-1)
                     * 32767).astype(np.int16)
    blocks = []
    for pkg in PKGS:
        orig = fake_soapy.Device

        def device(query, orig=orig):
            dev = orig(query)
            dev.read_plan = np.split(inter, 3)   # then KeyboardInterrupt
            return dev

        fake_soapy.Device = device
        pipe, dec = Recorder(10), Collect()
        assert _mod(pkg, "sdr").run_soapysdr(Args(gain=30.0), dec, pipe) \
            == 0
        fake_soapy.Device = orig
        assert [bytes(f.frame) for f in dec.frames] == \
            [frame_with_fcs(PAYLOAD)]
        blocks.append(pipe.blocks)
    assert len(blocks[0]) == len(blocks[1]) == 3
    for a, b in zip(*blocks):
        np.testing.assert_array_equal(a, b)
