"""Live SDR ingest via SoapySDR (generic driver).

Mirrors the reference's soapysdr.c:43-230 configure sequence: device
open by query string, sample rate / frequency / ppm correction, tuner
bandwidth, automatic DC offset mode when supported, per-element gains
(``--soapy-gain name1=v1,...``, taking precedence over ``--gain``) or
auto gain mode when no gain is given, antenna selection, device
settings key=values, then a CS16 read loop.  A read failure exits
non-zero so a supervisor can restart the process (the reference's
soapysdr.c:174-178 behavior).  Requires the SoapySDR python module;
inputs fail gracefully when it is absent.
"""
from __future__ import annotations

import sys

import numpy as np

SOAPY_OVERSAMPLE = 20

# reference dumpvdl2.h:173 — "gain not specified" (auto gain requested)
SDR_AUTO_GAIN = -100.0


def configure_device(SoapySDR, dev, args, pipeline) -> bool:
    """Apply the reference's configure sequence to an open device.

    Returns False on a fatal misconfiguration (caller exits non-zero).
    Split from the read loop so a fake-module test can assert the full
    sequence without streaming.
    """
    from ..utils.debug import D_SDR, debug_print
    from SoapySDR import SOAPY_SDR_RX

    rate = pipeline.sample_rate
    dev.setSampleRate(SOAPY_SDR_RX, 0, rate)
    dev.setFrequency(SOAPY_SDR_RX, 0, pipeline.centerfreq)
    if args.correction:
        dev.setFrequencyCorrection(SOAPY_SDR_RX, 0, float(args.correction))
    bw = getattr(args, "bandwidth", 0)
    if bw:
        try:
            dev.setBandwidth(SOAPY_SDR_RX, 0, bw)
            print(f"Bandwidth set to {bw} Hz", file=sys.stderr)
        except Exception:
            pass                       # ignore error (soapysdr.c:66-67)
    try:
        if dev.hasDCOffsetMode(SOAPY_SDR_RX, 0):
            dev.setDCOffsetMode(SOAPY_SDR_RX, 0, True)
    except AttributeError:
        pass

    # --soapy-gain takes precedence over --gain (soapysdr.c:75-76)
    soapy_gain = getattr(args, "soapy_gain", None)
    if soapy_gain:
        pairs = [kv.partition("=") for kv in soapy_gain.split(",") if kv]
        if not all(k and v for k, _, v in pairs):
            print("Unable to parse gains string, must be a sequence of "
                  "'name1=value1,name2=value2,...'.", file=sys.stderr)
            return False
        for k, _, v in pairs:
            dev.setGainElement(SOAPY_SDR_RX, 0, k, float(v))
            debug_print(D_SDR, "Set gain %s to %.2f", k, float(v))
            got = dev.getGainElement(SOAPY_SDR_RX, 0, k)
            print(f"Gain element {k} set to {got:.2f} dB", file=sys.stderr)
    elif args.gain is None or args.gain == SDR_AUTO_GAIN:
        if not dev.hasGainMode(SOAPY_SDR_RX, 0):
            print("Selected device does not support auto gain. Please "
                  "specify manual gain with --gain or --soapy-gain option",
                  file=sys.stderr)
            return False
        dev.setGainMode(SOAPY_SDR_RX, 0, True)
        print("Auto gain enabled", file=sys.stderr)
    else:
        dev.setGain(SOAPY_SDR_RX, 0, float(args.gain))
        print(f"Gain set to {float(args.gain):.2f} dB", file=sys.stderr)

    # --soapy-antenna is the reference's dedicated flag (soapysdr.c:91);
    # --antenna (shared with the SDRPlay drivers) works as a fallback.
    antenna = getattr(args, "soapy_antenna", None) or args.antenna
    if antenna:
        dev.setAntenna(SOAPY_SDR_RX, 0, antenna)
    try:
        print(f"Antenna: {dev.getAntenna(SOAPY_SDR_RX, 0)}",
              file=sys.stderr)
    except AttributeError:
        pass
    if args.device_settings:
        for kv in args.device_settings.split(","):
            k, _, v = kv.partition("=")
            dev.writeSetting(k, v)
    return True


def run_soapysdr(args, decoder, pipeline) -> int:
    from ..utils.debug import D_SDR, debug_print
    debug_print(D_SDR, "starting SoapySDR input: %r", args.soapysdr)
    try:
        import SoapySDR
        from SoapySDR import SOAPY_SDR_RX, SOAPY_SDR_CS16
    except ImportError:
        print("error: SoapySDR python module not available in this "
              "environment; use --iq-file or --raw-frames-file",
              file=sys.stderr)
        return 1

    dev = SoapySDR.Device(args.soapysdr)
    if not configure_device(SoapySDR, dev, args, pipeline):
        return 1

    stream = dev.setupStream(SOAPY_SDR_RX, SOAPY_SDR_CS16)
    dev.activateStream(stream)
    bufsize = 1 << 18
    buf = np.empty(2 * bufsize, dtype=np.int16)
    try:
        while True:
            sr = dev.readStream(stream, [buf], bufsize)
            n = sr.ret
            if n <= 0:
                # exit so a supervisor restarts us (soapysdr.c:174-178)
                print(f"SoapySDR read failed: {n}", file=sys.stderr)
                return 1
            flat = buf[: 2 * n].astype(np.float32) / 32768.0
            iq = (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)
            decoder.process_all(pipeline.feed(iq))
    except KeyboardInterrupt:
        decoder.process_all(pipeline.finish())
        return 0
    finally:
        dev.deactivateStream(stream)
        dev.closeStream(stream)
