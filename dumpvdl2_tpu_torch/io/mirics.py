"""Native Mirics (MSi2500/MSi001) input via ctypes-bound libmirisdr-4.

Re-implements the reference's Mirics driver behavior (mirics.c:70-210):
device search by index/serial (exact/prefix/suffix), hardware flavour
selection (generic vs SDRplay-branded), ISOC/BULK USB transfer mode,
nearest-gain selection, the 252_S16 sample format, and a synchronous
S16 read loop at 1.365 Msps (MIRISDR_OVERSAMPLE 13, mirics.h:21-23).
Note the reference applies `--correction` as an absolute frequency
offset in Hz here (freq - correction, mirics.c:165), unlike the ppm
semantics of the other drivers — behavior preserved.

The library handle is injected for unit tests; the search and gain
logic is shared with the RTL driver (io/rtl.py) since libmirisdr-4
clones the librtlsdr calling convention.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import sys

import numpy as np

from .rtl import nearest_gain, verbose_device_search

MIRISDR_BUFSIZE = 320000      # bytes per read (mirics.h:21)
MIRISDR_BUFCNT = 32           # (mirics.h:22)
MIRISDR_OVERSAMPLE = 13       # 10500*10*13 = 1.365 Msps (mirics.h:23)
SDR_AUTO_GAIN = -100.0

HW_FLAVOURS = {0: "MIRISDR_HW_DEFAULT", 1: "MIRISDR_HW_SDRPLAY"}
USB_XFER_MODES = {0: "ISOC", 1: "BULK"}


def load_libmirisdr():
    name = ctypes.util.find_library("mirisdr") or "libmirisdr.so.4"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.mirisdr_get_device_count.restype = ctypes.c_uint32
    lib.mirisdr_get_device_name.restype = ctypes.c_char_p
    lib.mirisdr_get_device_name.argtypes = [ctypes.c_uint32]
    lib.mirisdr_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.c_uint32]
    lib.mirisdr_get_transfer.restype = ctypes.c_char_p
    return lib


class _CtypesMiri:
    """Adapter giving libmirisdr the same face io/rtl.py expects."""

    def __init__(self, lib) -> None:
        self.lib = lib
        self.dev = ctypes.c_void_p(None)

    def device_count(self) -> int:
        return int(self.lib.mirisdr_get_device_count())

    def device_usb_strings(self, i: int):
        v = ctypes.create_string_buffer(256)
        p = ctypes.create_string_buffer(256)
        s = ctypes.create_string_buffer(256)
        if self.lib.mirisdr_get_device_usb_strings(i, v, p, s) != 0:
            return None
        return (v.value.decode(errors="replace"),
                p.value.decode(errors="replace"),
                s.value.decode(errors="replace"))

    def device_name(self, i: int) -> str:
        return (self.lib.mirisdr_get_device_name(i) or b"?").decode(
            errors="replace")

    def open(self, index: int) -> int:
        return self.lib.mirisdr_open(ctypes.byref(self.dev), index)

    def get_tuner_gains_list(self):
        n = self.lib.mirisdr_get_tuner_gains(self.dev, None)
        if n <= 0:
            return []
        arr = (ctypes.c_int * n)()
        self.lib.mirisdr_get_tuner_gains(self.dev, arr)
        return list(arr)

    def __getattr__(self, name):
        fn = getattr(self.lib, "mirisdr_" + name)
        return lambda *a: fn(self.dev, *a)


def mirics_configure(dev, device_index: int, flavour: int,
                     usb_xfer_mode: int, sample_rate: int, freq: int,
                     gain: float, freq_offset: int) -> None:
    """Configure per mirisdr_init (mirics.c:115-203)."""
    if flavour not in HW_FLAVOURS:
        raise RuntimeError(f"Unknown device variant {flavour}")
    if usb_xfer_mode not in USB_XFER_MODES:
        raise RuntimeError("Invalid USB transfer mode")
    if dev.set_hw_flavour(flavour) < 0:
        raise RuntimeError("Could not set hardware type")
    if dev.set_transfer(USB_XFER_MODES[usb_xfer_mode].encode()) < 0:
        raise RuntimeError("Failed to set transfer mode")
    if dev.set_sample_rate(int(sample_rate)) < 0:
        raise RuntimeError("Failed to set sample rate")
    # reference: --correction is an absolute Hz offset for this driver
    if dev.set_center_freq(int(freq - freq_offset)) < 0:
        raise RuntimeError("Failed to set frequency")
    print(f"Center frequency set to {freq - freq_offset} Hz",
          file=sys.stderr)
    if gain == SDR_AUTO_GAIN:
        if dev.set_tuner_gain_mode(0) < 0:
            raise RuntimeError("Failed to set automatic gain")
        print(f"Device #{device_index}: gain set to automatic",
              file=sys.stderr)
    else:
        # libmirisdr gains are whole dB (not tenths like librtlsdr)
        ngain = nearest_gain(dev, int(gain))
        if ngain is None:
            raise RuntimeError("Failed to read supported gain list")
        r = dev.set_tuner_gain_mode(1)
        r |= dev.set_tuner_gain(ngain)
        if r < 0:
            raise RuntimeError(f"Failed to set gain to {ngain}")
        print(f"Device #{device_index}: gain set to "
              f"{dev.get_tuner_gain()} dB", file=sys.stderr)
    if dev.set_sample_format(b"252_S16") < 0:
        raise RuntimeError("Failed to set sample format")
    dev.reset_buffer()


def run_mirics(args, decoder, pipeline) -> int:
    """CLI entry: stream S16 IQ blocks into the pipeline."""
    from ..app.cli import exit_requested
    from ..utils.debug import D_SDR, debug_print

    lib = load_libmirisdr()
    if lib is None:
        print("error: libmirisdr-4 not found on this system",
              file=sys.stderr)
        return 1
    dev = _CtypesMiri(lib)
    index = verbose_device_search(args.mirisdr, dev)
    if index < 0:
        return 1
    if dev.open(index) != 0:
        print(f"Failed to open mirisdr device #{index}", file=sys.stderr)
        return 1
    try:
        mirics_configure(dev, index, args.mirisdr_hw_flavour,
                         args.mirisdr_usb_xfer_mode,
                         pipeline.sample_rate, pipeline.centerfreq,
                         args.gain, int(args.correction))
        debug_print(D_SDR, "mirisdr #%d streaming at %d sps", index,
                    pipeline.sample_rate)
        buf = (ctypes.c_ubyte * MIRISDR_BUFSIZE)()
        n_read = ctypes.c_int(0)
        while not exit_requested():
            r = lib.mirisdr_read_sync(dev.dev, buf, MIRISDR_BUFSIZE,
                                      ctypes.byref(n_read))
            if r < 0:
                print(f"Device #{index}: read failed ({r})",
                      file=sys.stderr)
                return 1
            raw = np.frombuffer(buf, np.int16,
                                count=n_read.value // 2)
            iq = raw.astype(np.float32) / 32768.0
            decoder.process_all(pipeline.feed(
                iq[0::2] + 1j * iq[1::2]))
        decoder.process_all(pipeline.finish())
        return 0
    finally:
        dev.close()
