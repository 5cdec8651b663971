"""Debug tracing subsystem (`--debug <classes>`).

Mirrors the reference's compile-time debug facility at runtime
(reference dumpvdl2.c:557-586, dumpvdl2.h:155-168, debug_print /
debug_print_buf_hex macros dumpvdl2.h:251-274): 12 bitmask classes
selected by a comma list with '-' negation, last match wins; messages
go to stderr prefixed with the class name.  Because this framework is
Python, the gate is a cheap integer test — no build flag needed.
"""
from __future__ import annotations

import sys

D_NONE = 0
D_ALL = 0xFFFFFFFF
D_SDR = 1 << 0
D_DEMOD = 1 << 1
D_DEMOD_DETAIL = 1 << 2
D_BURST = 1 << 3
D_BURST_DETAIL = 1 << 4
D_PROTO = 1 << 5
D_PROTO_DETAIL = 1 << 6
D_STATS = 1 << 7
D_CACHE = 1 << 8
D_OUTPUT = 1 << 9
D_MISC = 1 << 31

# name -> (mask, description); mirrors debug_filters[] dumpvdl2.c:558-573
DEBUG_FILTERSPEC = {
    "none": (D_NONE, "No messages"),
    "all": (D_ALL, "All messages"),
    "sdr": (D_SDR, "SDR device handling"),
    "demod": (D_DEMOD, "DSP and demodulation"),
    "demod_detail": (D_DEMOD_DETAIL,
                     "DSP and demodulation - details with raw data dumps"),
    "burst": (D_BURST, "VDL2 burst decoding"),
    "burst_detail": (D_BURST_DETAIL,
                     "VDL2 burst decoding - details with raw data dumps"),
    "proto": (D_PROTO, "Frame payload decoding"),
    "proto_detail": (D_PROTO_DETAIL,
                     "Frame payload decoding - details with raw data dumps"),
    "stats": (D_STATS, "Statistics generation"),
    "cache": (D_CACHE, "AC and GS data cache operations"),
    "output": (D_OUTPUT, "Data output operations"),
    "misc": (D_MISC, "Messages not falling into other categories"),
}

_CLASS_NAMES = {v[0]: k for k, v in DEBUG_FILTERSPEC.items()
                if v[0] not in (D_NONE, D_ALL)}

debug_mask = D_NONE


def parse_debug_filterspec(spec: str) -> int:
    """Comma list with '-' negation, last match wins (dumpvdl2.c:607)."""
    mask = D_NONE
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        negate = token.startswith("-")
        name = token[1:] if negate else token
        if name not in DEBUG_FILTERSPEC:
            raise ValueError(f"unknown debug class: {name!r}")
        bit = DEBUG_FILTERSPEC[name][0]
        mask = (mask & ~bit) if negate else (mask | bit)
    return mask


def set_debug_mask(mask: int) -> None:
    global debug_mask
    debug_mask = mask


def debug_enabled(cls: int) -> bool:
    return bool(debug_mask & cls)


def debug_print(cls: int, msg: str, *args) -> None:
    if not (debug_mask & cls):
        return
    name = _CLASS_NAMES.get(cls, "misc")
    if args:
        msg = msg % args
    sys.stderr.write(f"[{name}] {msg.rstrip()}\n")


def debug_print_buf_hex(cls: int, buf, msg: str) -> None:
    if not (debug_mask & cls):
        return
    data = bytes(bytearray(buf))
    name = _CLASS_NAMES.get(cls, "misc")
    sys.stderr.write(f"[{name}] {msg.rstrip()}\n")
    for off in range(0, len(data), 16):
        row = data[off:off + 16]
        sys.stderr.write("[%s]   %04x: %s\n" % (
            name, off, " ".join(f"{b:02x}" for b in row)))
