"""Native SDRPlay RSP input via the sdrplay_api service (API v3),
ctypes-bound.

Re-implements the reference's SDRPlay v3 driver behavior
(sdrplay3.c:39-509): device enumeration and search by serial or index,
hardware detection (RSP1/RSP1A/RSP1B/RSP2/RSPduo/RSPdx/RSPdxR2),
per-hardware bias-T / RF-notch / DAB-notch / antenna-port parameter
routing, RSPduo master-availability check + single-tuner selection,
manual gain (per-stage IF gain reduction + LNA state) or AGC with a
configurable set point (default -30 dBFS, sdrplay3.c:30), ppm
correction, power-overload acknowledgement, and a 2.1 Msps stream
(SDRPLAY3_OVERSAMPLE 20, sdrplay3.h:24).

ctypes struct layouts match the published sdrplay_api.h 3.08+ ABI (the
``valid`` member of sdrplay_api_DeviceT appeared in 3.08; older
services are rejected at runtime like the reference's compile-time
version check, sdrplay3.c:341-350).

The per-hardware decision tables are pure functions over any object
exposing the parameter fields, so they are unit-testable with fakes.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import sys

from .sdrplay_common import SDR_AUTO_GAIN, StreamBridge

SDRPLAY3_OVERSAMPLE = 20             # 2.1 Msps (sdrplay3.h:24)
SDRPLAY3_DEFAULT_AGC_SETPOINT = -30  # sdrplay3.c:30
SDRPLAY_MAX_DEVICES = 16
SER_NO_LEN = 64

# Hardware version ids (sdrplay_api.h)
RSP1_ID, RSP2_ID, RSPduo_ID, RSPdx_ID = 1, 2, 3, 4
RSP1B_ID, RSPdxR2_ID, RSP1A_ID = 6, 7, 255

HW_NAMES = {
    RSP1_ID: "RSP1", RSP2_ID: "RSP2", RSP1A_ID: "RSP1A",
    RSPduo_ID: "RSPduo", RSPdx_ID: "RSPdx", RSP1B_ID: "RSP1B",
    RSPdxR2_ID: "RSPdxR2",
}

# sdrplay_api enums
_BW_1_536 = 1536
_IF_ZERO = 0
_AGC_DISABLE = 0
_AGC_5HZ = 3
_TUNER_A, _TUNER_B = 1, 2
_RSPDUO_MODE_SINGLE_TUNER = 1
_RSPDUO_MODE_MASTER = 4
_RSP2_ANTENNA = {"A": 5, "B": 6}
_RSPDX_ANTENNA = {"A": 0, "B": 1, "C": 2}
_EVENT_GAIN_CHANGE = 0
_EVENT_POWER_OVERLOAD = 1
_EVENT_DEVICE_REMOVED = 2
_EVENT_RSPDUO_MODE_CHANGE = 3
_UPDATE_CTRL_OVERLOAD_MSG_ACK = 0x04000000
_UPDATE_EXT1_NONE = 0


def hw_name(hwver: int) -> str:
    return HW_NAMES.get(hwver, "<unknown>")


def set_biast(dev_params, ch_params, hwver: int) -> bool:
    """Enable Bias-T on the right parameter block for the hardware
    (sdrplay3.c:165-191).  Returns False when unsupported."""
    if hwver == RSP1_ID:
        print(f"{hw_name(hwver)}: Not enabling Bias-T: feature not "
              "supported", file=sys.stderr)
        return False
    if hwver == RSP2_ID:
        ch_params.rsp2TunerParams.biasTEnable = 1
    elif hwver in (RSP1A_ID, RSP1B_ID):
        ch_params.rsp1aTunerParams.biasTEnable = 1
    elif hwver == RSPduo_ID:
        ch_params.rspDuoTunerParams.biasTEnable = 1
    elif hwver in (RSPdx_ID, RSPdxR2_ID):
        dev_params.rspDxParams.biasTEnable = 1
    else:
        print(f"Not enabling Bias-T: unknown device type {hwver}",
              file=sys.stderr)
        return False
    print(f"{hw_name(hwver)}: Enabling Bias-T", file=sys.stderr)
    return True


def set_notch_filter(dev_params, ch_params, hwver: int) -> bool:
    """Enable the AM/FM/broadcast RF notch (sdrplay3.c:193-219)."""
    if hwver == RSP1_ID:
        print(f"{hw_name(hwver)}: Not enabling notch filter: feature "
              "not supported", file=sys.stderr)
        return False
    if hwver == RSP2_ID:
        ch_params.rsp2TunerParams.rfNotchEnable = 1
    elif hwver in (RSP1A_ID, RSP1B_ID):
        dev_params.rsp1aParams.rfNotchEnable = 1
    elif hwver == RSPduo_ID:
        ch_params.rspDuoTunerParams.rfNotchEnable = 1
    elif hwver in (RSPdx_ID, RSPdxR2_ID):
        dev_params.rspDxParams.rfNotchEnable = 1
    else:
        print(f"Not enabling notch filter: unknown device type {hwver}",
              file=sys.stderr)
        return False
    print(f"{hw_name(hwver)}: Enabling notch filter", file=sys.stderr)
    return True


def set_dab_notch_filter(dev_params, ch_params, hwver: int) -> bool:
    """Enable the DAB notch (sdrplay3.c:221-245)."""
    if hwver in (RSP1_ID, RSP2_ID):
        print(f"{hw_name(hwver)}: Not enabling DAB notch filter: "
              "feature not supported", file=sys.stderr)
        return False
    if hwver in (RSP1A_ID, RSP1B_ID):
        dev_params.rsp1aParams.rfDabNotchEnable = 1
    elif hwver == RSPduo_ID:
        ch_params.rspDuoTunerParams.rfDabNotchEnable = 1
    elif hwver in (RSPdx_ID, RSPdxR2_ID):
        dev_params.rspDxParams.rfDabNotchEnable = 1
    else:
        print(f"Not enabling DAB notch filter: unknown device type "
              f"{hwver}", file=sys.stderr)
        return False
    print(f"{hw_name(hwver)}: Enabling DAB notch filter", file=sys.stderr)
    return True


def select_antenna(dev_params, ch_params, hwver: int,
                   antenna: str) -> bool:
    """Route the antenna-port selection (sdrplay3.c:247-285)."""
    if hwver == RSP2_ID:
        sel = _RSP2_ANTENNA.get(antenna)
        if sel is None:
            print(f"{hw_name(hwver)}: Invalid antenna port specified",
                  file=sys.stderr)
            return False
        ch_params.rsp2TunerParams.antennaSel = sel
    elif hwver in (RSPdx_ID, RSPdxR2_ID):
        sel = _RSPDX_ANTENNA.get(antenna)
        if sel is None:
            print(f"{hw_name(hwver)}: Invalid antenna port specified",
                  file=sys.stderr)
            return False
        dev_params.rspDxParams.antennaSel = sel
    elif hwver in (RSP1_ID, RSP1A_ID, RSPduo_ID):
        print(f"{hw_name(hwver)}: Cannot select antenna port: feature "
              "not supported", file=sys.stderr)
        return False
    else:
        print(f"Cannot select antenna port: unknown device type {hwver}",
              file=sys.stderr)
        return False
    print(f"{hw_name(hwver)}: Selecting antenna port {antenna}",
          file=sys.stderr)
    return True


def configure_gain(ch_params, ifgr: int, lna_state: int,
                   agc_set_point: int) -> None:
    """AGC when either manual component is unset, else manual IFGR +
    LNA state with AGC disabled (sdrplay3.c:448-458)."""
    if ifgr < 0 or lna_state < 0:
        sp = (agc_set_point if agc_set_point < 0
              else SDRPLAY3_DEFAULT_AGC_SETPOINT)
        ch_params.ctrlParams.agc.setPoint_dBfs = sp
        ch_params.ctrlParams.agc.enable = _AGC_5HZ
        print(f"Enabling AGC with set point at {sp} dBFS", file=sys.stderr)
    else:
        print("Disabling AGC", file=sys.stderr)
        ch_params.ctrlParams.agc.enable = _AGC_DISABLE
        print(f"Setting gain reduction components: IFGR={ifgr} "
              f"LNAState={lna_state}", file=sys.stderr)
        ch_params.tunerParams.gain.gRdB = ifgr
        ch_params.tunerParams.gain.LNAstate = lna_state


def verbose_device_search(spec: str, devices) -> int:
    """Search order per sdrplay3.c:287-323: exact serial first, then a
    raw index number.  ``devices`` is a list of (serial, hwver)."""
    if spec is None:
        return -1
    print(f"\nFound {len(devices)} device(s):", file=sys.stderr)
    for i, (serial, hwver) in enumerate(devices):
        print(f"  {i}: Type: {hw_name(hwver)} SN: {serial}",
              file=sys.stderr)
    for i, (serial, _hw) in enumerate(devices):
        if spec == serial:
            return _found(i, devices)
    try:
        num = int(spec, 0)
    except ValueError:
        num = -1
    if 0 <= num < len(devices):
        return _found(num, devices)
    print("No matching devices found", file=sys.stderr)
    return -1


def _found(i: int, devices) -> int:
    serial, hwver = devices[i]
    print(f"Selected device #{i} (type: {hw_name(hwver)} SN: {serial})",
          file=sys.stderr)
    return i


# ------------------------------------------------------------- ctypes ABI

HANDLE = ctypes.c_void_p


class _FsFreqT(ctypes.Structure):
    _fields_ = [("fsHz", ctypes.c_double), ("syncUpdate", ctypes.c_ubyte),
                ("reCal", ctypes.c_ubyte)]


class _SyncUpdateT(ctypes.Structure):
    _fields_ = [("sampleNum", ctypes.c_uint), ("period", ctypes.c_uint)]


class _ResetFlagsT(ctypes.Structure):
    _fields_ = [("resetGainUpdate", ctypes.c_ubyte),
                ("resetRfUpdate", ctypes.c_ubyte),
                ("resetFsUpdate", ctypes.c_ubyte)]


class _Rsp1aParamsT(ctypes.Structure):
    _fields_ = [("rfNotchEnable", ctypes.c_ubyte),
                ("rfDabNotchEnable", ctypes.c_ubyte)]


class _Rsp2ParamsT(ctypes.Structure):
    _fields_ = [("extRefOutputEn", ctypes.c_ubyte)]


class _RspDuoParamsT(ctypes.Structure):
    _fields_ = [("extRefOutputEn", ctypes.c_int)]


class _RspDxParamsT(ctypes.Structure):
    _fields_ = [("hdrEnable", ctypes.c_ubyte),
                ("biasTEnable", ctypes.c_ubyte),
                ("antennaSel", ctypes.c_int),
                ("rfNotchEnable", ctypes.c_ubyte),
                ("rfDabNotchEnable", ctypes.c_ubyte)]


class _DevParamsT(ctypes.Structure):
    _fields_ = [("ppm", ctypes.c_double), ("fsFreq", _FsFreqT),
                ("syncUpdate", _SyncUpdateT), ("resetFlags", _ResetFlagsT),
                ("mode", ctypes.c_int), ("samplesPerPkt", ctypes.c_uint),
                ("rsp1aParams", _Rsp1aParamsT),
                ("rsp2Params", _Rsp2ParamsT),
                ("rspDuoParams", _RspDuoParamsT),
                ("rspDxParams", _RspDxParamsT)]


class _GainValuesT(ctypes.Structure):
    _fields_ = [("curr", ctypes.c_float), ("max", ctypes.c_float),
                ("min", ctypes.c_float)]


class _GainT(ctypes.Structure):
    _fields_ = [("gRdB", ctypes.c_int), ("LNAstate", ctypes.c_ubyte),
                ("syncUpdate", ctypes.c_ubyte), ("minGr", ctypes.c_int),
                ("gainVals", _GainValuesT)]


class _RfFreqT(ctypes.Structure):
    _fields_ = [("rfHz", ctypes.c_double), ("syncUpdate", ctypes.c_ubyte)]


class _DcOffsetTunerT(ctypes.Structure):
    _fields_ = [("dcCal", ctypes.c_ubyte), ("speedUp", ctypes.c_ubyte),
                ("trackTime", ctypes.c_int),
                ("refreshRateTime", ctypes.c_int)]


class _TunerParamsT(ctypes.Structure):
    _fields_ = [("bwType", ctypes.c_int), ("ifType", ctypes.c_int),
                ("loMode", ctypes.c_int), ("gain", _GainT),
                ("rfFreq", _RfFreqT), ("dcOffsetTuner", _DcOffsetTunerT)]


class _DcOffsetT(ctypes.Structure):
    _fields_ = [("DCenable", ctypes.c_ubyte), ("IQenable", ctypes.c_ubyte)]


class _DecimationT(ctypes.Structure):
    _fields_ = [("enable", ctypes.c_ubyte),
                ("decimationFactor", ctypes.c_ubyte),
                ("wideBandSignal", ctypes.c_ubyte)]


class _AgcT(ctypes.Structure):
    _fields_ = [("enable", ctypes.c_int), ("setPoint_dBfs", ctypes.c_int),
                ("attack_ms", ctypes.c_ushort),
                ("decay_ms", ctypes.c_ushort),
                ("decay_delay_ms", ctypes.c_ushort),
                ("decay_threshold_dB", ctypes.c_ushort),
                ("syncUpdate", ctypes.c_int)]


class _CtrlParamsT(ctypes.Structure):
    _fields_ = [("dcOffset", _DcOffsetT), ("decimation", _DecimationT),
                ("agc", _AgcT), ("adsbMode", ctypes.c_int)]


class _Rsp1aTunerParamsT(ctypes.Structure):
    _fields_ = [("biasTEnable", ctypes.c_ubyte)]


class _Rsp2TunerParamsT(ctypes.Structure):
    _fields_ = [("biasTEnable", ctypes.c_ubyte),
                ("amPortSel", ctypes.c_int), ("antennaSel", ctypes.c_int),
                ("rfNotchEnable", ctypes.c_ubyte)]


class _RspDuoTunerParamsT(ctypes.Structure):
    _fields_ = [("biasTEnable", ctypes.c_ubyte),
                ("tuner1AmPortSel", ctypes.c_int),
                ("tuner1AmNotchEnable", ctypes.c_ubyte),
                ("rfNotchEnable", ctypes.c_ubyte),
                ("rfDabNotchEnable", ctypes.c_ubyte)]


class _RspDxTunerParamsT(ctypes.Structure):
    _fields_ = [("hdrBw", ctypes.c_int)]


class _RxChannelParamsT(ctypes.Structure):
    _fields_ = [("tunerParams", _TunerParamsT),
                ("ctrlParams", _CtrlParamsT),
                ("rsp1aTunerParams", _Rsp1aTunerParamsT),
                ("rsp2TunerParams", _Rsp2TunerParamsT),
                ("rspDuoTunerParams", _RspDuoTunerParamsT),
                ("rspDxTunerParams", _RspDxTunerParamsT)]


class _DeviceParamsT(ctypes.Structure):
    _fields_ = [("devParams", ctypes.POINTER(_DevParamsT)),
                ("rxChannelA", ctypes.POINTER(_RxChannelParamsT)),
                ("rxChannelB", ctypes.POINTER(_RxChannelParamsT))]


class _DeviceT(ctypes.Structure):
    # 3.08+ layout: ``valid`` follows rspDuoMode
    _fields_ = [("SerNo", ctypes.c_char * SER_NO_LEN),
                ("hwVer", ctypes.c_ubyte), ("tuner", ctypes.c_int),
                ("rspDuoMode", ctypes.c_int), ("valid", ctypes.c_ubyte),
                ("rspDuoSampleFreq", ctypes.c_double), ("dev", HANDLE)]


class _StreamCbParamsT(ctypes.Structure):
    _fields_ = [("firstSampleNum", ctypes.c_uint),
                ("grChanged", ctypes.c_int), ("rfChanged", ctypes.c_int),
                ("fsChanged", ctypes.c_int), ("numSamples", ctypes.c_uint),
                ("reset", ctypes.c_uint)]


_STREAM_CB = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_short), ctypes.POINTER(ctypes.c_short),
    ctypes.POINTER(_StreamCbParamsT), ctypes.c_uint, ctypes.c_uint,
    ctypes.c_void_p)
_EVENT_CB = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p)


class _CallbackFnsT(ctypes.Structure):
    _fields_ = [("StreamACbFn", _STREAM_CB), ("StreamBCbFn", _STREAM_CB),
                ("EventCbFn", _EVENT_CB)]


def load_sdrplay_api():
    """ctypes-bind libsdrplay_api; None when absent."""
    name = ctypes.util.find_library("sdrplay_api") or "libsdrplay_api.so.2"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        try:
            lib = ctypes.CDLL("libsdrplay_api.so")
        except OSError:
            return None
    lib.sdrplay_api_GetErrorString.restype = ctypes.c_char_p
    lib.sdrplay_api_ApiVersion.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.sdrplay_api_GetDeviceParams.argtypes = [
        HANDLE, ctypes.POINTER(ctypes.POINTER(_DeviceParamsT))]
    lib.sdrplay_api_Init.argtypes = [HANDLE,
                                     ctypes.POINTER(_CallbackFnsT),
                                     ctypes.c_void_p]
    lib.sdrplay_api_Uninit.argtypes = [HANDLE]
    lib.sdrplay_api_Update.argtypes = [HANDLE, ctypes.c_int,
                                       ctypes.c_uint, ctypes.c_int]
    return lib


def _errstr(lib, err: int) -> str:
    s = lib.sdrplay_api_GetErrorString(err)
    return (s or b"?").decode(errors="replace")


def run_sdrplay3(args, decoder, pipeline) -> int:
    """CLI entry mirroring sdrplay3_init (sdrplay3.c:325-505)."""
    from ..app.cli import exit_requested
    from ..utils.debug import D_SDR, debug_print

    lib = load_sdrplay_api()
    if lib is None:
        print("error: libsdrplay_api not found on this system",
              file=sys.stderr)
        return 1
    err = lib.sdrplay_api_Open()
    if err != 0:
        print(f"sdrplay_api_Open failed: {_errstr(lib, err)}",
              file=sys.stderr)
        return 1
    selected = None
    try:
        ver = ctypes.c_float(0.0)
        err = lib.sdrplay_api_ApiVersion(ctypes.byref(ver))
        if err != 0:
            print(f"sdrplay_api_ApiVersion failed: {_errstr(lib, err)}",
                  file=sys.stderr)
            return 1
        # ver is a C float: 3.08 stores as ~3.0799999, so a plain
        # `< 3.08` double compare would reject the minimum version itself.
        if round(ver.value, 2) < 3.08:
            print(f"SDRplay service version {ver.value:.2f} is older "
                  "than the 3.08 ABI this driver binds", file=sys.stderr)
            return 1
        print(f"Using SDRPlay API version {ver.value:f}", file=sys.stderr)

        lib.sdrplay_api_LockDeviceApi()
        devs = (_DeviceT * SDRPLAY_MAX_DEVICES)()
        ndev = ctypes.c_uint(0)
        err = lib.sdrplay_api_GetDevices(devs, ctypes.byref(ndev),
                                         SDRPLAY_MAX_DEVICES)
        if err != 0 or ndev.value < 1:
            print("No SDRplay devices found" if err == 0 else
                  f"Unable to enumerate connected SDRPlay devices: "
                  f"{_errstr(lib, err)}", file=sys.stderr)
            lib.sdrplay_api_UnlockDeviceApi()
            return 1
        table = [(devs[i].SerNo.decode(errors="replace"),
                  int(devs[i].hwVer)) for i in range(ndev.value)]
        idx = verbose_device_search(args.sdrplay3, table)
        if idx < 0:
            lib.sdrplay_api_UnlockDeviceApi()
            return 1
        device = devs[idx]
        err = lib.sdrplay_api_SelectDevice(ctypes.byref(device))
        lib.sdrplay_api_UnlockDeviceApi()
        if err != 0:
            print(f"Unable to select device {table[idx][0]}: "
                  f"{_errstr(lib, err)}", file=sys.stderr)
            return 1
        selected = device

        params = ctypes.POINTER(_DeviceParamsT)()
        err = lib.sdrplay_api_GetDeviceParams(device.dev,
                                              ctypes.byref(params))
        if err != 0 or not params:
            print(f"Unable to read device parameters: "
                  f"{_errstr(lib, err)}", file=sys.stderr)
            return 1
        dev_params = params.contents.devParams.contents
        ch_params = params.contents.rxChannelA.contents
        dev_params.fsFreq.fsHz = float(pipeline.sample_rate)
        dev_params.ppm = float(args.correction)
        ch_params.tunerParams.bwType = _BW_1_536
        ch_params.tunerParams.ifType = _IF_ZERO
        ch_params.tunerParams.rfFreq.rfHz = float(pipeline.centerfreq)

        hwver = int(device.hwVer)
        if args.biast:
            set_biast(dev_params, ch_params, hwver)
        if args.notch_filter:
            set_notch_filter(dev_params, ch_params, hwver)
        if args.dab_notch_filter:
            set_dab_notch_filter(dev_params, ch_params, hwver)
        if args.antenna is not None:
            select_antenna(dev_params, ch_params, hwver, args.antenna)

        if hwver == RSPduo_ID:
            # single-tuner mode requires master availability
            # (sdrplay3.c:426-446)
            if not (device.rspDuoMode & _RSPDUO_MODE_MASTER):
                print(f"{hw_name(hwver)}: Master device not available\n"
                      "This device can only be used in single tuner mode",
                      file=sys.stderr)
                return 1
            device.rspDuoMode = _RSPDUO_MODE_SINGLE_TUNER
            if args.tuner == 1:
                device.tuner = _TUNER_A
            elif args.tuner == 2:
                device.tuner = _TUNER_B
            else:
                print(f"{hw_name(hwver)}: Invalid tuner specified",
                      file=sys.stderr)
                return 1
            print(f"{hw_name(hwver)}: Using tuner {args.tuner}",
                  file=sys.stderr)

        ifgr = int(args.ifgr) if args.ifgr is not None else SDR_AUTO_GAIN
        lna = (int(args.lna_state) if args.lna_state is not None
               else SDR_AUTO_GAIN)
        configure_gain(ch_params, ifgr, lna, int(args.agc))

        bridge = StreamBridge()

        def _on_stream(xi, xq, cbparams, n, reset, cbc):
            bridge.push(xi, xq, n)

        def _on_event(event_id, tuner, evparams, cbc):
            if event_id == _EVENT_POWER_OVERLOAD:
                # acknowledge, or the service stops streaming
                # (sdrplay3.c:126-136)
                lib.sdrplay_api_Update(device.dev, tuner,
                                       _UPDATE_CTRL_OVERLOAD_MSG_ACK,
                                       _UPDATE_EXT1_NONE)
            else:
                debug_print(D_SDR, "sdrplay_api event %d (tuner %d)",
                            event_id, tuner)

        # Tuner B stream stays disconnected (reference sdrplay3.c:462
        # passes NULL): wiring it to the same queue would interleave two
        # tuners' samples into one IQ stream.
        callbacks = _CallbackFnsT(_STREAM_CB(_on_stream),
                                  ctypes.cast(None, _STREAM_CB),
                                  _EVENT_CB(_on_event))
        err = lib.sdrplay_api_Init(device.dev, ctypes.byref(callbacks),
                                   None)
        if err != 0:
            print(f"SDRplay: device initialization failed: "
                  f"{_errstr(lib, err)}", file=sys.stderr)
            return 1
        print(f"Device {table[idx][0]} started", file=sys.stderr)
        try:
            for blk in bridge.blocks(exit_requested):
                decoder.process_all(pipeline.feed(blk))
            decoder.process_all(pipeline.finish())
        finally:
            bridge.stop()
            print("SDRplay: stopping device", file=sys.stderr)
            err = lib.sdrplay_api_Uninit(device.dev)
            if err != 0:
                print(f"Could not uninitialize SDRplay API: "
                      f"{_errstr(lib, err)}", file=sys.stderr)
        return 0
    finally:
        if selected is not None:
            err = lib.sdrplay_api_ReleaseDevice(ctypes.byref(selected))
            if err != 0:
                print(f"Could not release SDRplay device: "
                      f"{_errstr(lib, err)}", file=sys.stderr)
        lib.sdrplay_api_Close()
