"""AVLC (Aviation VHF Link Control) frame parser — the L3 entry point.

Behavioral model: reference avlc.c.  An AVLC frame is
[4B dst addr][4B src addr][1B link control][info...][2B FCS].
Addresses are 28-bit fields transmitted bit-reversed across 4 octets;
bit 27 is the air/ground or command/response status bit and bits 24-26
the address type (avlc.c:159-162, avlc.h bitfields).
"""
from __future__ import annotations

from typing import Optional

from ..app.stats import stats
from ..config import Config, MsgFilter
from ..core.metadata import MsgMetadata
from ..link.crc import GOOD_FCS, crc16_ccitt
from . import enrich
from .base import JsonObj, ProtoNode, TextOut, UnknownProtoNode, hexdump

# L3 payload parsers, bound lazily ONCE (they import avlc helpers
# inside their own functions, so importing them at first use avoids
# the cycle while keeping the per-frame dispatch import-free — the
# repeated in-function imports were a few percent of bulk replay).
_xid_parse = _parse_acars = _x25_parse = None


def _bind_l3():
    global _xid_parse, _parse_acars, _x25_parse
    from .acars import parse_acars
    from .x25 import x25_parse
    from .xid import xid_parse
    _xid_parse, _parse_acars, _x25_parse = (xid_parse, parse_acars,
                                            x25_parse)

MIN_AVLC_LEN = 11

ADDRTYPE_AIRCRAFT = 1
ADDRTYPE_GS_ADM = 4
ADDRTYPE_GS_DEL = 5
ADDRTYPE_ALL = 7

ADDRTYPE_DESCR = ("reserved", "Aircraft", "reserved", "reserved",
                  "Ground station", "Ground station", "reserved",
                  "All stations")
STATUS_AG_DESCR = ("Airborne", "On ground")
STATUS_CR_DESCR = ("Command", "Response")

S_CMD = ("Receive Ready", "Receive not Ready", "Reject", "Selective Reject")

_U_NAMES = {0x00: "UI", 0x03: "DM", 0x10: "DISC", 0x18: "UA",
            0x21: "FRMR", 0x2b: "XID", 0x38: "TEST"}
UI, DM, DISC, UA, FRMR, XID, TEST = 0x00, 0x03, 0x10, 0x18, 0x21, 0x2b, 0x38


def u_cmd_name(mfunc: int) -> str:
    return _U_NAMES.get(mfunc, f"(0x{mfunc:02x})")


class AvlcAddr:
    """Parsed 28-bit DLC address.  addr/type/status are precomputed:
    they are read several times per frame (format + JSON + enrichment)
    and this is one of the hottest objects in bulk replay."""

    __slots__ = ("val", "addr", "type", "status")

    def __init__(self, val: int) -> None:
        self.val = val
        self.addr = val & 0xFFFFFF
        self.type = (val >> 24) & 0x7
        self.status = (val >> 27) & 0x1

    @property
    def is_aircraft(self) -> bool:
        return self.type == ADDRTYPE_AIRCRAFT

    @property
    def is_gs(self) -> bool:
        return self.type in (ADDRTYPE_GS_ADM, ADDRTYPE_GS_DEL)


# byte bit-reversal table; rev28(x) == rev32(x) >> 4 for x < 2**28
_REV8 = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def parse_dlc_addr(buf: bytes) -> AvlcAddr:
    packed = (buf[0] >> 1) | (buf[1] << 6) | (buf[2] << 13) | \
        ((buf[3] & 0xFE) << 20)
    rev32 = ((_REV8[packed & 0xFF] << 24)
             | (_REV8[(packed >> 8) & 0xFF] << 16)
             | (_REV8[(packed >> 16) & 0xFF] << 8)
             | _REV8[(packed >> 24) & 0xFF])
    return AvlcAddr(rev32 >> 4)


class AvlcFrameNode(ProtoNode):
    json_key = "avlc"

    def __init__(self, src: AvlcAddr, dst: AvlcAddr, lcf: int,
                 raw_frame: bytes) -> None:
        super().__init__()
        self.src = src
        self.dst = dst
        self.lcf = lcf
        self.raw_frame = raw_frame

    # link-control field accessors (avlc.c:49-92)
    @property
    def is_i(self) -> bool:
        return (self.lcf & 0x1) == 0

    @property
    def is_s(self) -> bool:
        return (self.lcf & 0x3) == 0x1

    @property
    def is_u(self) -> bool:
        return (self.lcf & 0x3) == 0x3

    @property
    def u_mfunc(self) -> int:
        return ((self.lcf >> 2) & 0x3F) & 0x3B

    @property
    def u_pf(self) -> int:
        return (self.lcf >> 4) & 0x1

    def _addrinfo_text(self, out: TextOut, indent: int, addr: AvlcAddr,
                       inline: bool) -> None:
        enrich.addrinfo_format_text(out, indent, addr, inline)

    def format_text(self, out: TextOut, indent: int) -> None:
        if Config.output_raw_frames and self.raw_frame:
            out.multiline(indent + 1, hexdump(self.raw_frame))
        out.iappend(indent, "%06X (%s, %s)" % (
            self.src.addr, ADDRTYPE_DESCR[self.src.type],
            STATUS_AG_DESCR[self.dst.status]))
        inline_info = Config.addrinfo_verbosity == 0
        if inline_info:
            self._addrinfo_text(out, indent, self.src, True)
        out.append(" -> %06X (%s)" % (self.dst.addr,
                                      ADDRTYPE_DESCR[self.dst.type]))
        if inline_info:
            self._addrinfo_text(out, indent, self.dst, True)
        out.append(": %s\n" % STATUS_CR_DESCR[self.src.status])
        if not inline_info:
            self._addrinfo_text(out, indent, self.src, False)
            self._addrinfo_text(out, indent, self.dst, False)
        if self.is_s:
            out.iline(indent, "AVLC type: S (%s) P/F: %x rseq: %x" % (
                S_CMD[(self.lcf >> 2) & 0x3], (self.lcf >> 4) & 1,
                (self.lcf >> 5) & 0x7))
        elif self.is_u:
            out.iline(indent, "AVLC type: U (%s) P/F: %x" % (
                u_cmd_name(self.u_mfunc), self.u_pf))
        else:
            out.iline(indent, "AVLC type: I sseq: %x rseq: %x poll: %x" % (
                (self.lcf >> 1) & 0x7, (self.lcf >> 5) & 0x7,
                (self.lcf >> 4) & 1))

    def _addr_json(self, addr: AvlcAddr, ag_status: int) -> JsonObj:
        obj = JsonObj()
        obj["addr"] = "%06X" % addr.addr
        obj["type"] = ADDRTYPE_DESCR[addr.type]
        if 0 <= ag_status <= 1:
            obj["status"] = STATUS_AG_DESCR[ag_status]
        enrich.addrinfo_format_json(obj, addr)
        return obj

    def format_json(self, obj: JsonObj) -> None:
        # the A/G bit applies to src but is carried in the dst field
        obj["src"] = self._addr_json(self.src, self.dst.status)
        obj["dst"] = self._addr_json(self.dst, -1)
        obj["cr"] = STATUS_CR_DESCR[self.src.status]
        if self.is_s:
            obj["frame_type"] = "S"
            obj["cmd"] = S_CMD[(self.lcf >> 2) & 0x3]
            obj["pf"] = bool((self.lcf >> 4) & 1)
            obj["rseq"] = (self.lcf >> 5) & 0x7
        elif self.is_u:
            obj["frame_type"] = "U"
            obj["cmd"] = u_cmd_name(self.u_mfunc)
            obj["pf"] = bool(self.u_pf)
        else:
            obj["frame_type"] = "I"
            obj["rseq"] = (self.lcf >> 1) & 0x7
            obj["sseq"] = (self.lcf >> 5) & 0x7
            obj["poll"] = bool((self.lcf >> 4) & 1)


_DST_CLASS_FROM_AIR = {ADDRTYPE_GS_ADM: "air2gnd",
                       ADDRTYPE_GS_DEL: "air2gnd",
                       ADDRTYPE_AIRCRAFT: "air2air",
                       ADDRTYPE_ALL: "air2all"}
_DST_CLASS_FROM_GND = {ADDRTYPE_AIRCRAFT: "gnd2air",
                       ADDRTYPE_GS_ADM: "gnd2gnd",
                       ADDRTYPE_GS_DEL: "gnd2gnd",
                       ADDRTYPE_ALL: "gnd2all"}


def avlc_parse(frame: bytes, metadata: MsgMetadata, reasm_ctx=None
               ) -> tuple[Optional[ProtoNode], int]:
    """Parse one AVLC frame; returns (proto tree root, msg_type bits)."""
    msg_type = 0
    freq = metadata.freq
    if len(frame) < MIN_AVLC_LEN:
        stats.increment_per_channel(freq, "avlc.errors.too_short")
        return None, msg_type
    if crc16_ccitt(frame) != GOOD_FCS:
        stats.increment_per_channel(freq, "avlc.errors.bad_fcs")
        return None, msg_type
    stats.increment_per_channel(freq, "avlc.frames.good")
    buf = bytes(frame[:-2])

    dst = parse_dlc_addr(buf[0:4])
    src = parse_dlc_addr(buf[4:8])
    if src.type == ADDRTYPE_AIRCRAFT:
        msg_type |= MsgFilter.SRC_AIR
        dst_class = _DST_CLASS_FROM_AIR.get(dst.type)
        if dst_class:
            stats.increment_per_channel(freq, "avlc.msg." + dst_class)
    elif src.type in (ADDRTYPE_GS_ADM, ADDRTYPE_GS_DEL):
        msg_type |= MsgFilter.SRC_GND
        dst_class = _DST_CLASS_FROM_GND.get(dst.type)
        if dst_class:
            stats.increment_per_channel(freq, "avlc.msg." + dst_class)

    lcf = buf[8]
    info = buf[9:]
    node = AvlcFrameNode(src, dst, lcf, bytes(frame))

    if _x25_parse is None:
        _bind_l3()
    if node.is_s:
        msg_type |= MsgFilter.AVLC_S
        if info:
            node.next = UnknownProtoNode(info)
    elif node.is_u:
        msg_type |= MsgFilter.AVLC_U
        if node.u_mfunc == XID:
            child, msg_type = _xid_parse(src.status, node.u_pf, info,
                                         msg_type)
            node.next = child
        else:
            node.next = UnknownProtoNode(info) if info else None
    else:
        msg_type |= MsgFilter.AVLC_I
        if len(info) > 3 and info[0] == 0xFF and info[1] == 0xFF \
                and info[2] == 0x01:
            child, msg_type = _parse_acars(
                info[3:], msg_type, reasm_ctx,
                metadata.burst_timestamp)
            node.next = child
        else:
            child, msg_type = _x25_parse(
                info, msg_type, reasm_ctx, metadata.burst_timestamp,
                src.addr, dst.addr)
            node.next = child
    return node, msg_type
