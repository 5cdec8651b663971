"""Native SDRPlay RSP input via the legacy binary API v2
(libmirsdrapi-rsp), ctypes-bound.

Re-implements the reference's SDRPlay v2 driver behavior
(sdrplay.c:41-422): device search by index or serial with
availability check, hardware-type detection from the reported hwVer
(1=RSP1, 2=RSP2, 3=RSPduo, >253=RSP1A), the per-hardware LNA
gain-reduction tables that split a requested *system* gain reduction
into an LNA state plus IF gain reduction, RSP2 antenna/bias-T/notch
control, RSP1A bias-T/broadcast-notch, RSPduo tuner select, DC offset
and IQ imbalance compensation, ppm correction, AGC with configurable
set point (default -30 dBFS), and a 2.1 Msps stream
(SDRPLAY_OVERSAMPLE 20, sdrplay.h:22).

The gain-reduction and search logic is pure and unit-testable; only
``run_sdrplay`` touches the vendor library.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import sys

from .sdrplay_common import SDR_AUTO_GAIN, StreamBridge

SDRPLAY_OVERSAMPLE = 20             # 10500*10*20 = 2.1 Msps (sdrplay.h:22)
SDRPLAY_DEFAULT_AGC_SETPOINT = -30  # sdrplay.c:33
MAX_IF_GR = 59                      # sdrplay.c:28
MIN_IF_GR = 20                      # sdrplay.c:29
MIXER_GR = 19                       # sdrplay.c:30

HW_RSP1, HW_RSP2, HW_RSP1A, HW_RSPDUO = "RSP1", "RSP2", "RSP1A", "RSPduo"

# Per-hardware LNA-state → LNA gain reduction (dB) tables (sdrplay.c:53-64)
LNA_GR_TABLES = {
    HW_RSP1: [0, 24, 19, 43],
    HW_RSP2: [0, 10, 15, 21, 24, 34, 39, 45, 64],
    HW_RSP1A: [0, 6, 12, 18, 20, 26, 32, 38, 57, 62],
    HW_RSPDUO: [0, 6, 12, 18, 20, 26, 32, 38, 57, 62],
}

# mirsdrapi-rsp.h enum values
_BW_1_536 = 1536
_IF_ZERO = 0
_USE_RSP_SET_GR = 2
_AGC_DISABLE = 0
_AGC_5HZ = 3
_RSPII_ANTENNA_A = 5
_RSPII_ANTENNA_B = 6


def hw_type_from_hwver(hwver: int):
    """hwVer byte → hardware family (sdrplay.c:199-211); None=unsupported."""
    if hwver == 1:
        return HW_RSP1
    if hwver == 2:
        return HW_RSP2
    if hwver == 3:
        return HW_RSPDUO
    if hwver > 253:
        return HW_RSP1A
    return None


def gain_reduction_range(hw_type: str) -> tuple:
    """Valid system gain-reduction bounds for a hardware type
    (sdrplay.c:362-369)."""
    table = LNA_GR_TABLES[hw_type]
    min_gr = MIN_IF_GR + table[0]
    max_gr = MAX_IF_GR + table[-1]
    if hw_type == HW_RSP1A:
        max_gr += MIXER_GR  # others include mixer GR in the top LNA state
    return min_gr, max_gr


def select_gain_reduction(hw_type: str, gr_system: int) -> tuple:
    """Split a system gain reduction into (IF GR, LNA state), starting
    from the lowest LNA gain reduction (sdrplay.c:349-360).  Raises
    ValueError with the valid range when unreachable."""
    table = LNA_GR_TABLES[hw_type]
    for state, lna_gr in enumerate(table):
        if lna_gr + MIN_IF_GR <= gr_system <= lna_gr + MAX_IF_GR:
            return gr_system - lna_gr, state
    min_gr, max_gr = gain_reduction_range(hw_type)
    raise ValueError(f"Gain reduction value is out of range "
                     f"(min={min_gr} max={max_gr})")


def verbose_device_search(spec: str, devices) -> int:
    """Device search, reference sdrplay.c:143-219: ``devices`` is a
    list of (serial, available, hwver) tuples.  A numeric string
    selects by index first, then exact serial match; the selected
    device must be available and of a supported hardware type.
    Returns the index, or -1 when nothing usable matches."""
    if spec is None or not devices:
        print("No RSP devices found", file=sys.stderr)
        return -1
    print(f"\nFound {len(devices)} device(s):", file=sys.stderr)
    for i, (serial, avail, _hw) in enumerate(devices):
        tag = "        " if avail else "(in use)"
        print(f"  {tag} {i}:  SN: {serial or '<none>'}", file=sys.stderr)

    idx = -1
    try:
        num = int(spec, 0)
    except ValueError:
        num = -1
    if 0 <= num < len(devices):
        idx = num
    else:
        for i, (serial, _avail, _hw) in enumerate(devices):
            if serial and spec == serial:
                idx = i
                break
    if idx < 0:
        print("No matching devices found", file=sys.stderr)
        return -1
    serial, avail, hwver = devices[idx]
    if not avail:
        print(f"Selected device #{idx} is not available", file=sys.stderr)
        return -1
    hw_type = hw_type_from_hwver(hwver)
    if hw_type is None:
        print(f"Selected device #{idx} is unsupported: hardware version "
              f"{hwver}", file=sys.stderr)
        return -1
    print(f"Selected device #{idx} (type: {hw_type} SN: "
          f"{serial or 'unknown'})", file=sys.stderr)
    return idx


class _MirDeviceT(ctypes.Structure):
    _fields_ = [("SerNo", ctypes.c_char_p),
                ("DevNm", ctypes.c_char_p),
                ("hwVer", ctypes.c_ubyte),
                ("devAvail", ctypes.c_ubyte)]


_STREAM_CB = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_short), ctypes.POINTER(ctypes.c_short),
    ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p)
_GAIN_CB = ctypes.CFUNCTYPE(None, ctypes.c_uint, ctypes.c_uint,
                            ctypes.c_void_p)


def load_libmirsdr():
    """ctypes-bind libmirsdrapi-rsp; None when absent."""
    name = (ctypes.util.find_library("mirsdrapi-rsp")
            or "libmirsdrapi-rsp.so.2")
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.mir_sdr_ApiVersion.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.mir_sdr_SetPpm.argtypes = [ctypes.c_double]
    lib.mir_sdr_StreamInit.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), _STREAM_CB, _GAIN_CB, ctypes.c_void_p]
    return lib


def enumerate_devices(lib):
    """mir_sdr_GetDevices → [(serial, available, hwver)]."""
    devs = (_MirDeviceT * 4)()
    n = ctypes.c_uint(0)
    if lib.mir_sdr_GetDevices(devs, ctypes.byref(n), 4) != 0:
        print("Unable to enumerate connected SDRPlay devices",
              file=sys.stderr)
        return []
    return [((devs[i].SerNo or b"").decode(errors="replace"),
             bool(devs[i].devAvail), int(devs[i].hwVer))
            for i in range(n.value)]


def run_sdrplay(args, decoder, pipeline) -> int:
    """CLI entry: configure the RSP per sdrplay_init (sdrplay.c:221-415)
    and stream S16 IQ blocks into the pipeline until a signal."""
    from ..app.cli import exit_requested
    from ..utils.debug import D_SDR, debug_print

    lib = load_libmirsdr()
    if lib is None:
        print("error: libmirsdrapi-rsp not found on this system",
              file=sys.stderr)
        return 1
    ver = ctypes.c_float(0.0)
    if lib.mir_sdr_ApiVersion(ctypes.byref(ver)) != 0:
        print("Incorrect API version", file=sys.stderr)
        return 1
    print(f"Using SDRPlay API version {ver.value:.3f}", file=sys.stderr)

    devices = enumerate_devices(lib)
    idx = verbose_device_search(args.sdrplay, devices)
    if idx < 0:
        return 1
    hw_type = hw_type_from_hwver(devices[idx][2])
    if lib.mir_sdr_SetDeviceIdx(idx) != 0:
        print(f"Unable to select device #{idx}", file=sys.stderr)
        return 1

    try:
        # Hardware-specific controls (sdrplay.c:252-324)
        if hw_type == HW_RSP2:
            if args.biast and lib.mir_sdr_RSPII_BiasTControl(1) != 0:
                print("Unable to activate Bias-T", file=sys.stderr)
                return 1
            ant = args.antenna or "A"
            sel = {"A": _RSPII_ANTENNA_A, "B": _RSPII_ANTENNA_B}.get(ant)
            if sel is None:
                print("Invalid antenna port specified", file=sys.stderr)
                return 1
            if lib.mir_sdr_RSPII_AntennaControl(sel) != 0:
                print(f"Unable to select antenna port {ant}",
                      file=sys.stderr)
                return 1
            print(f"Using antenna port {ant}", file=sys.stderr)
            if args.notch_filter and lib.mir_sdr_RSPII_RfNotchEnable(1) != 0:
                print("Unable to activate RF notch filter", file=sys.stderr)
                return 1
        elif hw_type == HW_RSP1A:
            if args.biast and lib.mir_sdr_rsp1a_BiasT(1) != 0:
                print("Unable to activate Bias-T", file=sys.stderr)
                return 1
            if (args.notch_filter
                    and lib.mir_sdr_rsp1a_BroadcastNotch(1) != 0):
                print("Unable to activate broadcast notch filter",
                      file=sys.stderr)
                return 1
        elif hw_type == HW_RSPDUO:
            if lib.mir_sdr_rspDuo_TunerSel(int(args.tuner)) != 0:
                print(f"Unable to select tuner {args.tuner}",
                      file=sys.stderr)
                return 1
            print(f"RSPduo: selected tuner {args.tuner}", file=sys.stderr)
            if args.biast and lib.mir_sdr_rspDuo_BiasT(1) != 0:
                print("Unable to activate Bias-T", file=sys.stderr)
                return 1
            if (args.notch_filter
                    and lib.mir_sdr_rspDuo_BroadcastNotch(1) != 0):
                print("Unable to activate broadcast notch filter",
                      file=sys.stderr)
                return 1

        if lib.mir_sdr_DCoffsetIQimbalanceControl(1, 0) != 0:
            print("Failed to set DC/IQ correction", file=sys.stderr)
            return 1
        if lib.mir_sdr_SetPpm(float(args.correction)) != 0:
            print("Unable to set frequency correction", file=sys.stderr)
            return 1
        print(f"Frequency correction set to {int(args.correction)} ppm",
              file=sys.stderr)

        # Gain-reduction split (sdrplay.c:342-370)
        gr = int(args.gr) if args.gr is not None else SDR_AUTO_GAIN
        gr_system = MIN_IF_GR if gr == SDR_AUTO_GAIN else gr
        try:
            if_gr, lna_state = select_gain_reduction(hw_type, gr_system)
        except ValueError as exc:
            print(str(exc), file=sys.stderr)
            return 1
        print(f"Selected IF gain reduction: {if_gr} dB, LNA gain "
              f"reduction: {LNA_GR_TABLES[hw_type][lna_state]} dB",
              file=sys.stderr)

        bridge = StreamBridge()
        stream_cb = _STREAM_CB(
            lambda xi, xq, first, grch, rfch, fsch, n, reset, hwrm, cbc:
            bridge.push(xi, xq, n))
        gain_cb = _GAIN_CB(
            lambda grdb, lnagrdb, cbc:
            debug_print(D_SDR, "Gain change: gRdb=%u lnaGRdB=%u",
                        grdb, lnagrdb))

        grdb = ctypes.c_int(if_gr)
        grdb_system = ctypes.c_int(gr_system)
        spp = ctypes.c_int(0)
        err = lib.mir_sdr_StreamInit(
            ctypes.byref(grdb), pipeline.sample_rate / 1e6,
            pipeline.centerfreq / 1e6, _BW_1_536, _IF_ZERO, lna_state,
            ctypes.byref(grdb_system), _USE_RSP_SET_GR, ctypes.byref(spp),
            stream_cb, gain_cb, None)
        if err != 0:
            print(f"Unable to initialize RSP stream, error {err}",
                  file=sys.stderr)
            return 1
        debug_print(D_SDR, "Stream initialized (samplesPerPacket=%d "
                    "gRdB=%d gRdBsystem=%d)", spp.value, grdb.value,
                    grdb_system.value)

        # AGC defaulting (sdrplay.c:386-404)
        agc = int(args.agc)
        if gr == SDR_AUTO_GAIN and agc == 0:
            agc = SDRPLAY_DEFAULT_AGC_SETPOINT
        if agc != 0:
            if lib.mir_sdr_AgcControl(_AGC_5HZ, agc, 0, 0, 0, 0, 0) != 0:
                print("Unable to activate AGC", file=sys.stderr)
                return 1
            print(f"AGC activated with set point at {agc} dBFS",
                  file=sys.stderr)
        elif lib.mir_sdr_AgcControl(_AGC_DISABLE,
                                    SDRPLAY_DEFAULT_AGC_SETPOINT,
                                    0, 0, 0, 0, 0) != 0:
            print("Unable to deactivate AGC", file=sys.stderr)
            return 1
        if (lib.mir_sdr_SetDcMode(4, 0) != 0
                or lib.mir_sdr_SetDcTrackTime(63) != 0):
            print("Set DC tracking failed", file=sys.stderr)
            return 1

        print(f"Device #{idx} started", file=sys.stderr)
        try:
            for blk in bridge.blocks(exit_requested):
                decoder.process_all(pipeline.feed(blk))
            decoder.process_all(pipeline.finish())
        finally:
            bridge.stop()
            lib.mir_sdr_StreamUninit()
        return 0
    finally:
        lib.mir_sdr_ReleaseDeviceIdx()
