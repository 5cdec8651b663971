"""X.25 / ISO 8208 packet layer (the ATN subnetwork layer of VDL2).

Behavioral model: reference x25.c.  Handles mod-8 packets: Call
Request/Accepted (BCD address block, facilities with the non-standard
2-bit length encoding, SNDCF), Data (M-bit sequence reassembly keyed on
the AVLC address pair, 3-bit sequence wrap, 3 s timeout), Clear/Reset/
Restart with cause+diagnostic dictionaries (ITU-T X.25 Annex E, ISO
8208, ICAO Doc 9705 table 5.7-3), Diag, RR/REJ, and the SNDCF error
report (which re-parses the errored PDU with flipped direction).
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..config import Config, MsgFilter
from ..app.stats import stats
from .base import (JsonObj, ProtoNode, TextOut, UnknownProtoNode,
                   bitfield_format_json, bitfield_format_text, hex_str)
from .reasm import ReasmStatus
from .tlv import (NO_VALUE, TlvTypeDescriptor, fmt_octet_string,
                  fmt_octet_string_with_ascii, json_octet_string,
                  parse_noop, parse_octet_string, single_tag_parse,
                  tlv_list_format_json, tlv_list_format_text)

X25_MIN_LEN = 3
GFI_X25_MOD8 = 1
X25_SNDCF_ID = 0xC1
X25_SNDCF_VERSION = 1
MIN_X25_SNDCF_LEN = 4

SN_PROTO_CLNP = 0x81
SN_PROTO_ESIS = 0x82
SN_PROTO_IDRP = 0x85

X25_CALL_REQUEST = 0x0B
X25_CALL_ACCEPTED = 0x0F
X25_CLEAR_REQUEST = 0x13
X25_CLEAR_CONFIRM = 0x17
X25_DATA = 0x00
X25_RR = 0x01
X25_REJ = 0x09
X25_RESET_REQUEST = 0x1B
X25_RESET_CONFIRM = 0x1F
X25_RESTART_REQUEST = 0xFB
X25_RESTART_CONFIRM = 0xFF
X25_DIAG = 0xF1

X25_REASM_TIMEOUT = 3.0

PKTTYPE_NAMES = {
    X25_CALL_REQUEST: "Call Request",
    X25_CALL_ACCEPTED: "Call Accepted",
    X25_CLEAR_REQUEST: "Clear Request",
    X25_CLEAR_CONFIRM: "Clear Confirm",
    X25_DATA: "Data",
    X25_RR: "Receive Ready",
    X25_REJ: "Receive Reject",
    X25_RESET_REQUEST: "Reset Request",
    X25_RESET_CONFIRM: "Reset Confirm",
    X25_RESTART_REQUEST: "Restart Request",
    X25_RESTART_CONFIRM: "Restart Confirm",
    X25_DIAG: "Diagnostics",
}

COMP_ALGOS = [(0x40, "ACA"), (0x20, "DEFLATE"), (0x02, "LREF"),
              (0x01, "LREF-CAN")]

CLR_CAUSES = {
    0x00: "DTE originated", 0x01: "Number busy",
    0x03: "Invalid facility request", 0x05: "Network congestion",
    0x09: "Remote procedure error", 0x0D: "Not obtainable",
    0x13: "Local procedure error", 0x15: "ROA out of order",
    0x19: "Reverse charging acceptance not subscribed",
    0x21: "Incompatible destination",
    0x29: "Fast select acceptance not subscribed", 0x39: "Ship absent",
}

RESET_CAUSES = {
    0x00: "DTE originated", 0x01: "Out of order",
    0x03: "Remote procedure error", 0x05: "Local procedure error",
    0x07: "Network congestion", 0x09: "Remote DTE operational",
    0x0F: "Network operational", 0x11: "Incompatible destination",
    0x1D: "Network out of order",
}

RESTART_CAUSES = {
    0x01: "Local procedure error", 0x03: "Network congestion",
    0x07: "Network operational",
}

# ITU-T X.25 Annex E + ICAO Doc 9705 Tab. 5.7-3 + ISO 8208 + Doc 9880
DIAG_CODES = {
    0x00: "Cleared by system management",
    0x01: "Invalid P(S)", 0x02: "Invalid P(R)",
    0x10: "Packet type invalid",
    0x11: "Packet type invalid for state r1",
    0x12: "Packet type invalid for state r2",
    0x13: "Packet type invalid for state r3",
    0x14: "Packet type invalid for state p1",
    0x15: "Packet type invalid for state p2",
    0x16: "Packet type invalid for state p3",
    0x17: "Packet type invalid for state p4",
    0x18: "Packet type invalid for state p5",
    0x19: "Packet type invalid for state p6",
    0x1A: "Packet type invalid for state p7",
    0x1B: "Packet type invalid for state d1",
    0x1C: "Packet type invalid for state d2",
    0x1D: "Packet type invalid for state d3",
    0x20: "Packet not allowed", 0x21: "Unidentifiable packet",
    0x22: "Call on one-way logical channel",
    0x23: "Invalid packet type on a PVC",
    0x24: "Packet on unassigned logical channel",
    0x25: "Reject not subscribed to",
    0x26: "Packet too short", 0x27: "Packet too long",
    0x28: "Invalid general format identifier",
    0x29: "Restart packet with non-zero reserved bits",
    0x2A: "Packet type not compatible with facility",
    0x2B: "Unauthorized interrupt confirmation",
    0x2C: "Unauthorized interrupt", 0x2D: "Unauthorized reject",
    0x2E: "TOA/NPI address subscription facility not subscribed to",
    0x30: "Time expired", 0x31: "Time expired for incoming call",
    0x32: "Time expired for clear indication",
    0x33: "Time expired for reset indication",
    0x34: "Time expired for restart indication",
    0x35: "Time expired for call deflection",
    0x40: "Call setup or call clearing problem",
    0x41: "Facility code not allowed",
    0x42: "Facility parameter not allowed",
    0x43: "Invalid called DTE address",
    0x44: "Invalid calling DTE address",
    0x45: "Invalid facility length", 0x46: "Incoming call barred",
    0x47: "No logical channel available", 0x48: "Call collision",
    0x49: "Duplicate facility requested", 0x4A: "Non-zero address length",
    0x4B: "Non-zero facility length",
    0x4C: "Facility not provided when expected",
    0x4D: "Invalid ITU-T specified DTE facility",
    0x4E: "Max number of call redirections or deflections exceeded",
    0x50: "Miscellaneous", 0x51: "Improper cause code from DTE",
    0x52: "Not aligned octet", 0x53: "Inconsistent Q-bit setting",
    0x54: "NUI problem", 0x55: "ICRD problem",
    0x70: "International problem", 0x71: "Remote network problem",
    0x72: "International protocol problem",
    0x73: "International link out of order",
    0x74: "International link busy",
    0x75: "Transit network facility problem",
    0x76: "Remote network facility problem",
    0x77: "International routing problem",
    0x78: "Temporary routing problem", 0x79: "Unknown called DNIC",
    0x7A: "Maintenance action",
    0x80: "Version number not supported", 0x81: "Invalid length field",
    0x82: "Call collision resolution",
    0x83: "Proposed directory size too large",
    0x84: "LREF cancellation not supported",
    0x85: "Received DTE refused, received NET refused or invalid NET selector",
    0x86: "Invalid SNCR field", 0x87: "ACA compression not supported",
    0x88: "LREF compression not supported",
    0x8F: "Deflate compression not supported",
    0x90: "Idle timer expired", 0x91: "Need to reuse the circuit",
    0x92: "System local error",
    0x93: "Invalid SEL field value in received NET",
    0xE1: "OSI network disconnect (transient)",
    0xE2: "OSI network disconnect (permanent)",
    0xE3: "OSI network reject - reason unspecified (transient)",
    0xE4: "OSI network reject - reason unspecified (permanent)",
    0xE5: "OSI network reject - QoS not available (transient)",
    0xE6: "OSI network reject - QoS not available (permanent)",
    0xE7: "OSI network reject - NSAP unreachable (transient)",
    0xE8: "OSI network reject - NSAP unreachable (permanent)",
    0xE9: "OSI network reset - no reason given",
    0xEA: "OSI network reset - congestion",
    0xEB: "OSI network reject - NSAP address unknown (permanent)",
    0xF0: "System lack of resources",
    0xF1: "Higher level initiated disconnect (normal)",
    0xF2: "Incompatible information in user data",
    0xF3: "Higher level initiated disconnect - incompatible data",
    0xF4: "Higher level initiated reject - no reason given (transient)",
    0xF5: "Higher level initiated reject - no reason given (permanent)",
    0xF6: "Higher level initiated reject - QoS not available (transient)",
    0xF7: "Higher level initiated reject - QoS not available (permanent)",
    0xF8: "Higher level initiated reject - incompatible data",
    0xF9: "Unrecognized protocol ID",
    0xFA: "Higher level initiated reset - user resync",
}

SNDCF_ERROR_DESCRIPTIONS = (
    "Compressed NPDU with unrecognized Local Reference",
    "Creation of directory entry outside of sender's permitted range",
    "Directory entry exists",
    "Local Reference greater than maximum value accepted",
    "Data Unit Identifier missing when SP=1",
    "reserved", "reserved",
    "Compressed CLNP PDU with unrecognized type",
    "Local Reference cancellation error",
)


# ------------------------------------------------------- facility TLV table

def _fmt_pkt_size(out: TextOut, indent: int, label: str, data) -> None:
    out.iline(indent, f"{label}:")
    out.iline(indent + 1, "From calling DTE: %u bytes" % data[0])
    out.iline(indent + 1, "From called  DTE: %u bytes" % data[1])


def _fmt_win_size(out: TextOut, indent: int, label: str, data) -> None:
    out.iline(indent, f"{label}:")
    out.iline(indent + 1, "From calling DTE: %u packets" % data[0])
    out.iline(indent + 1, "From called  DTE: %u packets" % data[1])


def _parse_pkt_size(code: int, buf: bytes):
    if len(buf) < 2 or buf[0] > 0xF or buf[1] > 0xF:
        return None
    return (1 << buf[1], 1 << buf[0])   # (from_calling, from_called)


def _parse_win_size(code: int, buf: bytes):
    if len(buf) < 2 or not (1 <= buf[0] <= 127) or not (1 <= buf[1] <= 127):
        return None
    return (buf[1], buf[0])


def _parse_fast_select(code: int, buf: bytes):
    if len(buf) < 1:
        return None
    return (bool(buf[0] & 0x80), bool(buf[0] & 0x40))


def _fmt_fast_select(out: TextOut, indent: int, label: str, data) -> None:
    out.iline(indent, "%s: %srequested" % (label, "" if data[0] else "not "))


X25_FACILITIES = {
    0x00: TlvTypeDescriptor(label="", parse=parse_noop,
                            format_text=None, format_json=None),
    0x01: TlvTypeDescriptor(
        label="Fast Select", json_key="fast_select",
        parse=_parse_fast_select, format_text=_fmt_fast_select,
        format_json=lambda d: d[0]),
    0x08: TlvTypeDescriptor(
        label="Called line address modified",
        json_key="called_line_addr_modified", parse=parse_octet_string,
        format_text=fmt_octet_string, format_json=json_octet_string),
    0x42: TlvTypeDescriptor(
        label="Max. packet size", json_key="max_pkt_size",
        parse=_parse_pkt_size, format_text=_fmt_pkt_size,
        format_json=lambda d: JsonObj(from_calling_dte=d[0],
                                      from_called_dte=d[1])),
    0x43: TlvTypeDescriptor(
        label="Window size", json_key="window_size",
        parse=_parse_win_size, format_text=_fmt_win_size,
        format_json=lambda d: JsonObj(from_calling_dte=d[0],
                                      from_called_dte=d[1])),
    0xC9: TlvTypeDescriptor(
        label="Called address extension", json_key="called_addr_extension",
        parse=parse_octet_string,
        format_text=fmt_octet_string_with_ascii,
        format_json=json_octet_string),
}


def fmt_x25_addr(addr: bytes, nibbles: int) -> Optional[str]:
    if nibbles == 0 or not addr:
        return None
    digits = []
    for i in range(nibbles):
        byte = addr[i // 2]
        digits.append("%x" % ((byte >> 4) & 0xF if i % 2 == 0 else byte & 0xF))
    return "".join(digits)


class SndcfErrorReportNode(ProtoNode):
    json_key = "sndcf_error_report"

    def __init__(self) -> None:
        super().__init__()
        self.err = True
        self.error_code = 0
        self.local_ref = 0
        self.errored_pdu_present = False

    def format_text(self, out: TextOut, indent: int) -> None:
        if self.err:
            out.iline(indent, "-- Unparseable SNDCF Error Report")
            return
        out.iline(indent, "SNDCF Error Report:")
        descr = SNDCF_ERROR_DESCRIPTIONS[self.error_code] \
            if self.error_code < len(SNDCF_ERROR_DESCRIPTIONS) else "unknown"
        out.iline(indent + 1, "Cause: 0x%02x (%s)" % (self.error_code, descr))
        out.iline(indent + 1, "Local Reference: 0x%02x" % self.local_ref)
        if self.errored_pdu_present:
            out.iline(indent, "Erroneous PDU:")

    def format_json(self, obj: JsonObj) -> None:
        obj["err"] = self.err
        if self.err:
            return
        obj["cause_code"] = self.error_code
        if self.error_code < len(SNDCF_ERROR_DESCRIPTIONS):
            obj["cause_descr"] = SNDCF_ERROR_DESCRIPTIONS[self.error_code]
        obj["local_ref"] = self.local_ref
        obj["erroneous_pdu_present"] = self.errored_pdu_present


class X25PacketNode(ProtoNode):
    json_key = "x25"

    def __init__(self) -> None:
        super().__init__()
        self.err = True
        self.type = 0
        self.chan_group = 0
        self.chan_num = 0
        self.hdr_type_val = 0
        self.addr_block_present = False
        self.calling: Tuple[bytes, int] = (b"", 0)
        self.called: Tuple[bytes, int] = (b"", 0)
        self.facilities = None
        self.compression = 0
        self.clr_cause = 0
        self.diag_code = 0
        self.diag_code_present = False
        self.diag_data = b""
        self.reasm_status = ReasmStatus.UNKNOWN

    # data-packet subfields of the type octet
    @property
    def sseq(self) -> int:
        return (self.hdr_type_val >> 1) & 0x7

    @property
    def more(self) -> int:
        return (self.hdr_type_val >> 4) & 0x1

    @property
    def rseq(self) -> int:
        return (self.hdr_type_val >> 5) & 0x7

    def format_text(self, out: TextOut, indent: int) -> None:
        if self.err:
            out.iline(indent, "-- Unparseable X.25 packet")
            return
        name = PKTTYPE_NAMES.get(self.type)
        out.iappend(indent, "X.25 %s: grp: %u chan: %u" % (
            name, self.chan_group, self.chan_num))
        if self.addr_block_present:
            calling = fmt_x25_addr(*self.calling)
            called = fmt_x25_addr(*self.called)
            out.append(" src: %s dst: %s" % (calling or "none",
                                             called or "none"))
        elif self.type == X25_DATA:
            out.append(" sseq: %u rseq: %u more: %u" % (
                self.sseq, self.rseq, self.more))
        elif self.type in (X25_RR, X25_REJ):
            out.append(" rseq: %u" % self.rseq)
        out.append("\n")
        indent += 1
        cause_dict = None
        if self.type in (X25_CALL_REQUEST, X25_CALL_ACCEPTED):
            out.iline(indent, "Facilities:")
            tlv_list_format_text(out, self.facilities, indent + 1)
            out.iappend(indent, "Compression support: ")
            bitfield_format_text(out, self.compression, COMP_ALGOS)
            out.append("\n")
            out.iline(indent, "M/I: %u" % ((self.compression & 0x10) != 0))
        elif self.type == X25_DATA:
            out.iline(indent, "X.25 reasm status: %s"
                      % self.reasm_status.value)
        elif self.type == X25_CLEAR_REQUEST:
            cause_dict = CLR_CAUSES
        elif self.type == X25_RESET_REQUEST:
            cause_dict = RESET_CAUSES
        elif self.type == X25_RESTART_REQUEST:
            cause_dict = RESTART_CAUSES
        if cause_dict is not None:
            out.iline(indent, "Cause: 0x%02x (%s)" % (
                self.clr_cause, cause_dict.get(self.clr_cause, "unknown")))
        if self.diag_code_present:
            out.iline(indent, "Diagnostic code: 0x%02x (%s)" % (
                self.diag_code, DIAG_CODES.get(self.diag_code, "unknown")))
        if self.type == X25_DIAG and self.diag_data:
            out.iline(indent, "Erroneous packet header: %s"
                      % hex_str(self.diag_data))

    def format_json(self, obj: JsonObj) -> None:
        obj["err"] = self.err
        if self.err:
            return
        obj["pkt_type"] = self.type
        name = PKTTYPE_NAMES.get(self.type)
        if name:
            obj["pkt_type_name"] = name
        obj["chan_group"] = self.chan_group
        obj["chan_num"] = self.chan_num
        if self.addr_block_present:
            calling = fmt_x25_addr(*self.calling)
            called = fmt_x25_addr(*self.called)
            if calling:
                obj["calling_addr"] = calling
            if called:
                obj["called_addr"] = called
        elif self.type == X25_DATA:
            obj["sseq"] = self.sseq
            obj["rseq"] = self.rseq
            obj["more"] = bool(self.more)
        elif self.type in (X25_RR, X25_REJ):
            obj["rseq"] = self.rseq
        cause_dict = None
        if self.type in (X25_CALL_REQUEST, X25_CALL_ACCEPTED):
            obj["facilities"] = tlv_list_format_json(self.facilities)
            obj["compression_options"] = self.compression
            bitfield_format_json(obj, "compression_algos",
                                 self.compression, COMP_ALGOS)
        elif self.type == X25_DATA:
            obj["reasm_status"] = self.reasm_status.value
        elif self.type == X25_CLEAR_REQUEST:
            cause_dict = CLR_CAUSES
        elif self.type == X25_RESET_REQUEST:
            cause_dict = RESET_CAUSES
        elif self.type == X25_RESTART_REQUEST:
            cause_dict = RESTART_CAUSES
        if cause_dict is not None:
            obj["clear_cause"] = self.clr_cause
            if self.clr_cause in cause_dict:
                obj["clear_cause_descr"] = cause_dict[self.clr_cause]
        if self.diag_code_present:
            obj["diag_code"] = self.diag_code
            if self.diag_code in DIAG_CODES:
                obj["diag_code_descr"] = DIAG_CODES[self.diag_code]
        if self.type == X25_DIAG and self.diag_data:
            obj["erroneous_pkt_hdr"] = self.diag_data.hex()


def _parse_address_block(pkt: X25PacketNode, buf: bytes) -> int:
    """BCD calling/called address block; returns bytes consumed or -1."""
    if not buf:
        return -1
    calling_len = (buf[0] & 0xF0) >> 4          # nibbles
    called_len = buf[0] & 0x0F
    addr_len = (calling_len + called_len) >> 1
    addr_len += (calling_len & 1) ^ (called_len & 1)
    rest = buf[1:]
    if len(rest) < addr_len:
        return -1
    # nibble streams: called first, then calling (packed back to back)
    nibbles = []
    for byte in rest[:addr_len]:
        nibbles.append((byte >> 4) & 0xF)
        nibbles.append(byte & 0xF)
    called_nib = nibbles[:called_len]
    calling_nib = nibbles[called_len:called_len + calling_len]

    def pack(nib: list[int]) -> bytes:
        out = bytearray()
        for i in range(0, len(nib), 2):
            hi = nib[i] << 4
            lo = nib[i + 1] if i + 1 < len(nib) else 0
            out.append(hi | lo)
        return bytes(out)

    pkt.called = (pack(called_nib), called_len)
    pkt.calling = (pack(calling_nib), calling_len)
    pkt.addr_block_present = True
    return 1 + addr_len


def _parse_facility_field(pkt: X25PacketNode, buf: bytes) -> int:
    """Facilities with the 2-bit-in-typecode length encoding."""
    if not buf:
        return -1
    fac_len = buf[0]
    if len(buf) - 1 < fac_len:
        return -1
    field = buf[1:1 + fac_len]
    tags = []
    i = 0
    while i < len(field):
        code = field[i]
        i += 1
        param_len = (code >> 6) & 3
        if param_len < 3:
            param_len += 1
        else:
            if i >= len(field):
                return -1
            param_len = field[i]
            i += 1
        if len(field) - i < param_len:
            return -1
        tags = single_tag_parse(code, field[i:i + param_len],
                                X25_FACILITIES, tags)
        i += param_len
    pkt.facilities = tags
    return 1 + fac_len


def _parse_callreq_sndcf(pkt: X25PacketNode, buf: bytes) -> int:
    if len(buf) < 2 or buf[0] != X25_SNDCF_ID:
        return -1
    sndcf_len = buf[1]
    rest = buf[2:]
    if sndcf_len < MIN_X25_SNDCF_LEN or not rest or \
            rest[0] != X25_SNDCF_VERSION or len(rest) < sndcf_len:
        return -1
    pkt.compression = rest[3]
    return 2 + sndcf_len


# lazily-bound L4 parsers (cycle-safe; avoids per-packet imports)
_clnp_parse = _clnp_compressed = _esis_parse = None


def parse_x25_user_data(buf: bytes, msg_type: int, reasm_ctx, rx_time,
                        src_addr: int, dst_addr: int
                        ) -> tuple[Optional[ProtoNode], int]:
    if not buf:
        return None, msg_type
    global _clnp_parse, _clnp_compressed, _esis_parse
    if _clnp_parse is None:
        from .clnp import clnp_compressed_data_pdu_parse, clnp_pdu_parse
        from .esis import esis_pdu_parse
        _clnp_parse = clnp_pdu_parse
        _clnp_compressed = clnp_compressed_data_pdu_parse
        _esis_parse = esis_pdu_parse
    proto = buf[0]
    if proto == SN_PROTO_CLNP:
        return _clnp_parse(buf, msg_type, reasm_ctx, rx_time,
                           src_addr, dst_addr)
    if proto == SN_PROTO_ESIS:
        return _esis_parse(buf, msg_type)
    pdu_type = proto >> 4
    if pdu_type < 0x4 or pdu_type in (0x6, 0x7, 0x9, 0xA):
        return _clnp_compressed(buf, msg_type, reasm_ctx,
                                rx_time, src_addr, dst_addr)
    if proto == 0xE0:
        return sndcf_error_report_parse(buf, msg_type, reasm_ctx, rx_time,
                                        src_addr, dst_addr)
    return UnknownProtoNode(buf), msg_type


def sndcf_error_report_parse(buf: bytes, msg_type: int, reasm_ctx, rx_time,
                             src_addr: int, dst_addr: int
                             ) -> tuple[ProtoNode, int]:
    node = SndcfErrorReportNode()
    if len(buf) < 3:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    node.error_code = buf[1]
    node.local_ref = buf[2]
    if len(buf) > 3:
        # The errored PDU travelled the opposite direction: flip the
        # direction bits while parsing it (x25.c:363-366).
        flipped = msg_type ^ (MsgFilter.SRC_AIR | MsgFilter.SRC_GND)
        child, flipped = parse_x25_user_data(buf[3:], flipped, reasm_ctx,
                                             rx_time, src_addr, dst_addr)
        msg_type = flipped ^ (MsgFilter.SRC_AIR | MsgFilter.SRC_GND)
        node.next = child
        node.errored_pdu_present = True
    node.err = False
    return node, msg_type


def x25_parse(buf: bytes, msg_type: int, reasm_ctx, rx_time,
              src_addr: int, dst_addr: int) -> tuple[ProtoNode, int]:
    node = X25PacketNode()
    if len(buf) < X25_MIN_LEN:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    gfi = (buf[0] >> 4) & 0xF
    if gfi != GFI_X25_MOD8:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    node.chan_group = buf[0] & 0xF
    node.chan_num = buf[1]
    node.hdr_type_val = buf[2]
    ptr = buf[3:]

    pkttype = buf[2]
    if (pkttype & 1) == 0:
        node.type = X25_DATA
        msg_type |= MsgFilter.X25_DATA
    else:
        node.type = pkttype
        masked = pkttype & 0x1F
        if masked in (X25_RR, X25_REJ):
            node.type = masked
        msg_type |= MsgFilter.X25_CONTROL

    if node.type in (X25_CALL_REQUEST, X25_CALL_ACCEPTED):
        ret = _parse_address_block(node, ptr)
        if ret < 0:
            node.next = UnknownProtoNode(buf)
            return node, msg_type
        ptr = ptr[ret:]
        ret = _parse_facility_field(node, ptr)
        if ret < 0:
            node.next = UnknownProtoNode(buf)
            return node, msg_type
        ptr = ptr[ret:]
        if node.type == X25_CALL_REQUEST:
            ret = _parse_callreq_sndcf(node, ptr)
            if ret < 0:
                node.next = UnknownProtoNode(buf)
                return node, msg_type
            ptr = ptr[ret:]
        else:
            if not ptr:
                node.next = UnknownProtoNode(buf)
                return node, msg_type
            node.compression = ptr[0]
            ptr = ptr[1:]
        # Fast Select: a data PDU may follow in call req/accept
        child, msg_type = parse_x25_user_data(ptr, msg_type, reasm_ctx,
                                              rx_time, src_addr, dst_addr)
        node.next = child
    elif node.type == X25_DATA:
        x25_data = bytes(ptr)
        node.reasm_status = ReasmStatus.UNKNOWN
        decode_user_data = True
        if reasm_ctx is not None:
            table = reasm_ctx.seq_table("x25")
            key = (src_addr, dst_addr)
            node.reasm_status = table.add_fragment(
                key, x25_data, seq_num=node.sseq,
                is_final=not node.more, rx_time=rx_time,
                timeout=X25_REASM_TIMEOUT, seq_num_wrap=8)
            if node.reasm_status is ReasmStatus.COMPLETE:
                payload = table.payload_get(key)
                if payload:
                    x25_data = payload
            elif node.reasm_status in (ReasmStatus.IN_PROGRESS,
                                       ReasmStatus.DUPLICATE) \
                    and not Config.decode_fragments:
                decode_user_data = False
            _update_x25_reasm_stats(node.reasm_status, msg_type)
        if decode_user_data:
            child, msg_type = parse_x25_user_data(
                x25_data, msg_type, reasm_ctx, rx_time, src_addr, dst_addr)
            node.next = child
        else:
            node.next = UnknownProtoNode(x25_data)
    elif node.type in (X25_CLEAR_REQUEST, X25_RESET_REQUEST,
                       X25_RESTART_REQUEST):
        if not ptr:
            node.next = UnknownProtoNode(buf)
            return node, msg_type
        node.clr_cause = ptr[0]
        # bit 8 set: network-relayed DTE cause; collapse to 0 for lookup
        if node.clr_cause & 0x80:
            node.clr_cause = 0
        ptr = ptr[1:]
        if ptr:
            node.diag_code = ptr[0]
            node.diag_code_present = True
    elif node.type == X25_DIAG:
        if not ptr:
            node.next = UnknownProtoNode(buf)
            return node, msg_type
        node.diag_code = ptr[0]
        node.diag_code_present = True
        node.diag_data = bytes(ptr[1:])
    elif node.type in (X25_CLEAR_CONFIRM, X25_RR, X25_REJ,
                       X25_RESET_CONFIRM, X25_RESTART_CONFIRM):
        pass
    else:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    node.err = False
    return node, msg_type


def _update_x25_reasm_stats(status: ReasmStatus, msg_type: int) -> None:
    names = {
        ReasmStatus.UNKNOWN: "x25.reasm.unknown",
        ReasmStatus.COMPLETE: "x25.reasm.complete",
        ReasmStatus.SKIPPED: "x25.reasm.skipped",
        ReasmStatus.DUPLICATE: "x25.reasm.duplicate",
        ReasmStatus.FRAG_OUT_OF_SEQUENCE: "x25.reasm.out_of_seq",
        ReasmStatus.ARGS_INVALID: "x25.reasm.invalid_args",
    }
    metric = names.get(status)
    if metric:
        direction = "air2gnd" if msg_type & MsgFilter.SRC_AIR else "gnd2air"
        stats.increment_per_msgdir(direction, metric)
