"""Native RTL-SDR input via ctypes-bound librtlsdr.

Re-implements the reference's RTL driver behavior (rtl.c:30-205):
verbose device search by index / exact / prefix / suffix serial match,
nearest-gain selection from the tuner's supported gain list, frequency
correction (ppm), tuner bandwidth, bias-T, AGC off, and a synchronous
read loop delivering unsigned-8-bit IQ at 1.05 Msps
(RTL_OVERSAMPLE 10, rtl.h:21-23) into the block pipeline.

The librtlsdr handle is injected (``lib=``) so the search/gain logic is
unit-testable without hardware; at runtime the system librtlsdr.so is
loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import sys

import numpy as np

RTL_BUFSIZE = 320000          # bytes per read  (rtl.h:21)
RTL_BUFCNT = 15               # librtlsdr buffer count (rtl.h:22)
RTL_OVERSAMPLE = 10           # 10500*10*10 = 1.05 Msps (rtl.h:23)
SDR_AUTO_GAIN = -100.0


def load_librtlsdr():
    """ctypes-bind the system librtlsdr; None when absent."""
    name = ctypes.util.find_library("rtlsdr") or "librtlsdr.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.rtlsdr_get_device_count.restype = ctypes.c_uint32
    lib.rtlsdr_get_device_name.restype = ctypes.c_char_p
    lib.rtlsdr_get_device_name.argtypes = [ctypes.c_uint32]
    lib.rtlsdr_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                ctypes.c_uint32]
    return lib


class _CtypesRtl:
    """Thin adapter presenting librtlsdr as plain-python calls."""

    def __init__(self, lib) -> None:
        self.lib = lib
        self.dev = ctypes.c_void_p(None)

    def device_count(self) -> int:
        return int(self.lib.rtlsdr_get_device_count())

    def device_usb_strings(self, i: int):
        v = ctypes.create_string_buffer(256)
        p = ctypes.create_string_buffer(256)
        s = ctypes.create_string_buffer(256)
        if self.lib.rtlsdr_get_device_usb_strings(i, v, p, s) != 0:
            return None
        return (v.value.decode(errors="replace"),
                p.value.decode(errors="replace"),
                s.value.decode(errors="replace"))

    def device_name(self, i: int) -> str:
        return (self.lib.rtlsdr_get_device_name(i) or b"?").decode(
            errors="replace")

    def open(self, index: int) -> int:
        return self.lib.rtlsdr_open(ctypes.byref(self.dev), index)

    def __getattr__(self, name):
        fn = getattr(self.lib, "rtlsdr_" + name)
        return lambda *a: fn(self.dev, *a)


def nearest_gain(dev, target_gain_tenths: int):
    """Closest supported tuner gain (rtl.c:30-54); None on failure."""
    if dev.set_tuner_gain_mode(1) < 0:
        print("WARNING: Failed to enable manual gain.", file=sys.stderr)
        return None
    gains = dev.get_tuner_gains_list()
    if not gains:
        return None
    return min(gains, key=lambda g: abs(target_gain_tenths - g))


def verbose_device_search(spec: str, dev) -> int:
    """Device search by index or serial, reference rtl.c:57-121:
    8-char strings try serial matching first; otherwise a numeric
    string selects by index; then exact, prefix and suffix serial
    matches, in that order.  Returns -1 when nothing matches."""
    count = dev.device_count()
    if count == 0:
        print("No supported devices found.", file=sys.stderr)
        return -1
    serials = []
    print(f"Found {count} device(s):", file=sys.stderr)
    for i in range(count):
        strings = dev.device_usb_strings(i)
        if strings is not None:
            vendor, product, serial = strings
            print(f"  {i}:  {vendor}, {product}, SN: {serial}",
                  file=sys.stderr)
        else:
            serial = ""
            print(f"  {i}:  Failed to query data", file=sys.stderr)
        serials.append(serial)

    def use(i: int) -> int:
        print(f"Using device {i}: {dev.device_name(i)}", file=sys.stderr)
        return i

    if len(spec) != 8:              # raw index?
        try:
            idx = int(spec, 0)
        except ValueError:
            idx = -1
        else:
            if 0 <= idx < count:
                return use(idx)
    for i, serial in enumerate(serials):        # exact
        if spec == serial:
            return use(i)
    for i, serial in enumerate(serials):        # prefix
        if serial.startswith(spec):
            return use(i)
    for i, serial in enumerate(serials):        # suffix
        if serial.endswith(spec):
            return use(i)
    print("No matching devices found.", file=sys.stderr)
    return -1


def rtl_configure(dev, device_index: int, sample_rate: int, freq: int,
                  bw: int, gain: float, correction: int,
                  bias: int) -> None:
    """Configure an opened device exactly as rtl_init (rtl.c:123-190)."""
    if dev.set_sample_rate(int(sample_rate)) < 0:
        raise RuntimeError("Failed to set sample rate")
    if dev.set_center_freq(int(freq)) < 0:
        raise RuntimeError("Failed to set frequency")
    print(f"Center frequency set to {freq} Hz", file=sys.stderr)
    r = dev.set_freq_correction(int(correction))
    if r < 0 and r != -2:
        raise RuntimeError("Failed to set freq correction")
    if dev.set_tuner_bandwidth(int(bw)) == 0:
        print(f"Bandwidth set to {bw} Hz", file=sys.stderr)
    if gain == SDR_AUTO_GAIN:
        if dev.set_tuner_gain_mode(0) < 0:
            raise RuntimeError("Failed to set automatic gain")
        print(f"Device #{device_index}: gain set to automatic",
              file=sys.stderr)
    else:
        ngain = nearest_gain(dev, int(gain * 10.0))
        if ngain is None:
            raise RuntimeError("Failed to read supported gain list")
        r = dev.set_tuner_gain_mode(1)
        r |= dev.set_tuner_gain(ngain)
        if r < 0:
            raise RuntimeError(f"Failed to set gain to {ngain / 10.0:.2f}")
        print(f"Device #{device_index}: gain set to "
              f"{dev.get_tuner_gain() / 10.0:.2f} dB", file=sys.stderr)
    if dev.set_agc_mode(0) < 0:
        raise RuntimeError("Failed to disable AGC")
    if dev.set_bias_tee(int(bias)) < 0:
        raise RuntimeError("Failed to set bias tee")
    print(f"Device {device_index} bias tee set to {bias}", file=sys.stderr)
    dev.reset_buffer()


def run_rtlsdr(args, decoder, pipeline) -> int:
    """CLI entry: stream u8 IQ blocks into the pipeline until a signal.

    Uses rtlsdr_read_sync in a loop (block-based pipeline pulls data;
    the reference's async callback model maps to this pull loop)."""
    from ..app.cli import exit_requested
    from ..utils.debug import D_SDR, debug_print

    lib = load_librtlsdr()
    if lib is None:
        print("error: librtlsdr not found on this system", file=sys.stderr)
        return 1
    dev = _CtypesRtl(lib)

    # adapter for nearest_gain's gain-list read
    def gains_list():
        n = lib.rtlsdr_get_tuner_gains(dev.dev, None)
        if n <= 0:
            return []
        arr = (ctypes.c_int * n)()
        lib.rtlsdr_get_tuner_gains(dev.dev, arr)
        return list(arr)
    dev.get_tuner_gains_list = gains_list

    index = verbose_device_search(args.rtlsdr, dev)
    if index < 0:
        return 1
    if dev.open(index) != 0:
        print(f"Failed to open rtlsdr device #{index}", file=sys.stderr)
        return 1
    try:
        rtl_configure(dev, index, pipeline.sample_rate,
                      pipeline.centerfreq, args.bandwidth or 0,
                      args.gain, int(args.correction), int(args.bias))
        debug_print(D_SDR, "rtlsdr #%d streaming at %d sps", index,
                    pipeline.sample_rate)
        buf = (ctypes.c_ubyte * RTL_BUFSIZE)()
        n_read = ctypes.c_int(0)
        while not exit_requested():
            r = lib.rtlsdr_read_sync(dev.dev, buf, RTL_BUFSIZE,
                                     ctypes.byref(n_read))
            if r < 0:
                print(f"Device #{index}: read failed ({r})",
                      file=sys.stderr)
                return 1
            raw = np.frombuffer(buf, np.uint8, count=n_read.value)
            iq = (raw.astype(np.float32) - 127.5) / 127.5
            decoder.process_all(pipeline.feed(
                iq[0::2] + 1j * iq[1::2]))
        decoder.process_all(pipeline.finish())
        return 0
    finally:
        dev.close()
