"""Global runtime configuration (the reference's dumpvdl2_config_t).

A module-level singleton mirrors the reference's ``Config`` global
(dumpvdl2.h:205-218, dumpvdl2.c:65): parsers and formatters consult it
for filtering, verbosity, and output tweaks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional


class MsgFilter:
    ALL = 0xFFFFFFFF
    NONE = 0
    SRC_GND = 1 << 0
    SRC_AIR = 1 << 1
    AVLC_S = 1 << 2
    AVLC_U = 1 << 3
    AVLC_I = 1 << 4
    ACARS_NODATA = 1 << 5
    ACARS_DATA = 1 << 6
    XID_NO_GSIF = 1 << 7
    XID_GSIF = 1 << 8
    X25_CONTROL = 1 << 9
    X25_DATA = 1 << 10
    IDRP_NO_KEEPALIVE = 1 << 11
    IDRP_KEEPALIVE = 1 << 12
    ESIS = 1 << 13
    CM = 1 << 14
    CPDLC = 1 << 15
    ADSC = 1 << 16


# token -> (mask, description); '-' prefix removes, last match wins
MSG_FILTERSPEC = {
    "all": (MsgFilter.ALL, "all messages"),
    "none": (MsgFilter.NONE, "no messages"),
    "uplink": (MsgFilter.SRC_GND, "messages from ground stations"),
    "downlink": (MsgFilter.SRC_AIR, "messages from aircraft"),
    "avlc_s": (MsgFilter.AVLC_S, "AVLC Supervisory frames"),
    "avlc_u": (MsgFilter.AVLC_U, "AVLC Unnumbered Control frames"),
    "avlc_i": (MsgFilter.AVLC_I, "AVLC Information frames"),
    "acars_nodata": (MsgFilter.ACARS_NODATA, "ACARS frames without data (eg. empty ACKs)"),
    "acars_data": (MsgFilter.ACARS_DATA, "ACARS frames with data"),
    "gsif": (MsgFilter.XID_GSIF, "Ground Station Information Frames"),
    "xid_no_gsif": (MsgFilter.XID_NO_GSIF, "XID frames other than GSIF"),
    "x25_control": (MsgFilter.X25_CONTROL, "X.25 Control packets"),
    "x25_data": (MsgFilter.X25_DATA, "X.25 Data packets"),
    "idrp_keepalive": (MsgFilter.IDRP_KEEPALIVE, "IDRP Keepalive PDUs"),
    "idrp_no_keepalive": (MsgFilter.IDRP_NO_KEEPALIVE, "IDRP PDUs other than Keepalive"),
    "esis": (MsgFilter.ESIS, "ES-IS PDUs"),
    "cm": (MsgFilter.CM, "ICAO Context Management Protocol PDUs"),
    "cpdlc": (MsgFilter.CPDLC, "Controller-Pilot Data Link Communication PDUs"),
    "adsc": (MsgFilter.ADSC, "Automatic Dependent Surveillance - Contract messages"),
}


def parse_msg_filterspec(spec: str) -> int:
    """Comma list with '-' negation, last match wins (dumpvdl2.c:607-646)."""
    flt = 0
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        negate = token.startswith("-")
        name = token[1:] if negate else token
        if name not in MSG_FILTERSPEC:
            raise ValueError(f"unknown message filter: {name!r}")
        mask = MSG_FILTERSPEC[name][0]
        flt = (flt & ~mask) if negate else (flt | mask)
    return flt


class AddrInfoVerbosity(IntEnum):
    TERSE = 0
    NORMAL = 1
    VERBOSE = 2


@dataclass
class Dumpvdl2Config:
    msg_filter: int = MsgFilter.ALL
    max_ppm: float = 0.0
    output_queue_hwm: int = 1000
    station_id: Optional[str] = None
    hourly: bool = False
    daily: bool = False
    utc: bool = False
    milliseconds: bool = False
    output_raw_frames: bool = False
    dump_asn1: bool = False
    extended_header: bool = False
    decode_fragments: bool = False
    # "auto": decode MIAM with this framework's RECONSTRUCTED CORE
    # codec (see proto/miam.py provenance note); "off": show MIAM
    # frames' text raw, for operators who prefer no conjectural decode
    miam: str = "auto"
    prettify_xml: bool = False
    prettify_json: bool = False
    ac_addrinfo_db_available: bool = False
    gs_addrinfo_db_available: bool = False
    addrinfo_verbosity: AddrInfoVerbosity = AddrInfoVerbosity.NORMAL


Config = Dumpvdl2Config()


def reset_config() -> None:
    """Restore defaults (used by tests)."""
    global Config
    Config.__init__()
