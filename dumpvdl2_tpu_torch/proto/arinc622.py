"""ARINC 622 ATS applications carried inside ACARS text.

CPDLC (FANS-1/A), ADS-C v1 and friends ride on ACARS labels A6/AA/B6/BA
etc. as an "ATS unit": ``/<facility>.<IMI><registration><binary><CRC>``.
The reference obtains detection, CRC check and payload decode from
libacars (reference src/acars.c:100-114; the decoders lived in dumpvdl2
itself until v1.5.0, doc/NEWS.md:238-241).  Here:

* the IMI table sets the msg_type filter bits,
* the 16-bit ATS-unit CRC is actually computed (CRC-16-CCITT over the
  unit starting after the '/').  The canonical convention — init
  0xFFFF, little-endian byte order, matching the one libacars
  enforces — is tried FIRST; the other conventions seen from deployed
  ARINC 622 implementations are accepted as a fallback, recorded in
  the output, and counted in the ``arinc622.crc.noncanonical`` metric
  so a station can see when its traffic diverges,
* ADS/DIS payloads decode via proto/adsc_v1.py; AT1 and the
  connection-management IMIs CR1/CC1/DR1 decode as FANS-1/A CPDLC
  messages via proto/fans.py (libacars routes all four through the
  same CPDLC decoder).
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

from ..app.stats import stats
from ..config import MsgFilter
from ..link.crc import crc16_ccitt
from .base import JsonObj, ProtoNode, TextOut, hex_str

# IMI -> (application name, msg_type filter bit)
_IMI_TABLE = {
    "AT1": ("CPDLC", MsgFilter.CPDLC),
    "CR1": ("CPDLC Connect Request", MsgFilter.CPDLC),
    "CC1": ("CPDLC Connect Confirm", MsgFilter.CPDLC),
    "DR1": ("CPDLC Disconnect Request", MsgFilter.CPDLC),
    "ADS": ("ADS-C", MsgFilter.ADSC),
    "DIS": ("ADS-C Disconnect", MsgFilter.ADSC),
}

_ATS_LABELS = {"A6", "AA", "B6", "BA", "H1"}

# "/<addr>.<IMI>" at any offset in the text (raw bytes).
_ATS_RE = re.compile(rb"/([A-Z0-9]{3,8})\.(AT1|CR1|CC1|DR1|ADS|DIS)")
# fixed 7-character registration field, e.g. ".N123AB" / "N1234  "
_REG_RE = re.compile(rb"[. ]?[A-Z0-9. -]{6}")


CANONICAL_CRC = "ccitt_ffff_inv_le"


def _crc_check(unit: bytes) -> tuple[bool, str]:
    """Verify the trailing 16-bit CRC of an ATS unit.

    ``unit`` = bytes from the character after '/' through the CRC.
    Conventions are tried in a fixed order with the canonical one
    first — init 0xFFFF, HDLC-style one's complement, little-endian,
    the convention this framework's own encoder (sim / fixtures) uses —
    so it always wins ties; a non-canonical match is counted via
    statsd.
    """
    if len(unit) < 3:
        return False, ""
    body, stored = unit[:-2], unit[-2:]
    candidates = []
    for init, name in ((0xFFFF, "ccitt_ffff"), (0x0000, "ccitt_0000")):
        crc = crc16_ccitt(body, init)
        inv = crc ^ 0xFFFF
        candidates += [
            (bytes((inv & 0xFF, inv >> 8)), name + "_inv_le"),
            (bytes((inv >> 8, inv & 0xFF)), name + "_inv_be"),
            (bytes((crc & 0xFF, crc >> 8)), name + "_le"),
            (bytes((crc >> 8, crc & 0xFF)), name + "_be"),
        ]
    for want, name in candidates:
        if stored == want:
            if name != CANONICAL_CRC:
                stats.increment("arinc622.crc.noncanonical")
            return True, name
    return False, ""


class Arinc622Node(ProtoNode):
    json_key = "arinc622"

    def __init__(self, imi: str, app_name: str, addr: str, reg: str,
                 payload: bytes, crc_ok: bool, crc_convention: str) -> None:
        super().__init__()
        self.imi = imi
        self.app_name = app_name
        self.addr = addr                 # ground facility address
        self.reg = reg                   # aircraft registration field
        self.payload = payload           # binary ATS data (sans CRC)
        self.crc_ok = crc_ok
        self.crc_convention = crc_convention

    def format_text(self, out: TextOut, indent: int) -> None:
        out.iline(indent, f"{self.app_name} message:")
        if self.addr:
            out.iline(indent + 1, f"Ground terminal: {self.addr}")
        if self.reg:
            out.iline(indent + 1, f"Aircraft: {self.reg}")
        if not self.crc_ok:
            out.iline(indent + 1, "-- CRC check failed")
        if self.next is None and self.payload:
            out.iline(indent + 1, f"Data: {hex_str(self.payload)}")

    def format_json(self, obj: JsonObj) -> None:
        obj["imi"] = self.imi
        obj["app"] = self.app_name
        if self.addr:
            obj["gs_addr"] = self.addr
        if self.reg:
            obj["reg"] = self.reg
        obj["crc_ok"] = self.crc_ok
        if self.crc_ok and self.crc_convention:
            obj["crc_convention"] = self.crc_convention
        if self.next is None and self.payload:
            obj["data"] = hex_str(self.payload)


def maybe_parse_arinc622(acars_node, msg_type: int
                         ) -> Tuple[Optional[ProtoNode], int]:
    """Detect and decode an ARINC 622 ATS unit in the ACARS text.

    Uses the raw (8-bit) text bytes — ATS binary payloads use the full
    octet range on VDL2 and must not be parity-masked.
    """
    label = acars_node.label
    raw = getattr(acars_node, "txt_raw", None)
    if raw is None:
        raw = acars_node.txt.encode("latin-1", "replace")
    if label not in _ATS_LABELS or not raw:
        return None, msg_type

    m = _ATS_RE.search(raw)
    if m is None:
        # ACARS media with character parity deliver the unit with bit 8
        # used as parity; retry on the parity-stripped text.
        raw = bytes(b & 0x7F for b in raw)
        m = _ATS_RE.search(raw)
    if m is None:
        return None, msg_type
    addr = m.group(1).decode("ascii")
    imi = m.group(2).decode("ascii")
    rest = raw[m.end():]

    # Aircraft registration field right after the IMI: FIXED seven
    # characters (e.g. ".N123AB") per the ARINC 622 message layout — a
    # greedy match would swallow a printable first byte of the binary
    # ATS payload.
    reg = ""
    if len(rest) >= 7 and _REG_RE.fullmatch(rest[:7]):
        reg = rest[:7].decode("ascii").strip(". ")
        rest = rest[7:]

    app_name, flt_bit = _IMI_TABLE[imi]
    msg_type |= flt_bit

    unit = raw[m.start() + 1:]           # after '/' through CRC
    crc_ok, convention = _crc_check(unit)
    payload = rest[:-2] if crc_ok and len(rest) >= 2 else rest

    node = Arinc622Node(imi, app_name, addr, reg, payload,
                        crc_ok, convention)

    from ..proto.acars import MSG_DIR_AIR2GND, MSG_DIR_GND2AIR
    downlink = acars_node.msg_dir == MSG_DIR_AIR2GND
    if payload:
        if imi in ("ADS", "DIS"):
            from .adsc_v1 import adsc_parse
            node.next = adsc_parse(payload, downlink=downlink)
        elif imi in ("AT1", "CR1", "CC1", "DR1"):
            # libacars decodes the connection-management units with the
            # same FANS CPDLC codec as AT1 (la_arinc_parse imi table).
            from .fans import cpdlc_fans_parse
            node.next = cpdlc_fans_parse(payload, uplink=not downlink)
    return node, msg_type
