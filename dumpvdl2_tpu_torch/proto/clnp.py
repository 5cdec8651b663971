"""CLNP (ISO 8473 / X.233) network layer — full and LREF-compressed NPDUs.

Behavioral model: reference clnp.c.  Uncompressed NPDUs carry the X.233
fixed header, NSAP address part, optional segmentation part and an
options TLV (incl. the ATN security label); compressed NPDUs use the
ICAO Doc 9705 LREF header.  Segmented PDUs go through offset-based
reassembly keyed on (AVLC src, AVLC dst, PDU id) with the PDU lifetime
as the timeout.  Payload dispatch: ES-IS / IDRP / COTP.
"""
from __future__ import annotations

from typing import Optional, Tuple

from .base import (JsonObj, ProtoNode, TextOut, UnknownProtoNode, hex_str,
                   printable)
from .atn import (atn_sec_label_format_json, atn_sec_label_format_text,
                  atn_sec_label_parse)
from .reasm import ReasmStatus
from .tlv import (TlvTypeDescriptor, fmt_octet_string, fmt_single_octet,
                  json_octet_string, parse_octet_string, tlv_list_format_json,
                  tlv_list_format_text, tlv_parse)

SN_PROTO_CLNP = 0x81
SN_PROTO_ESIS = 0x82
SN_PROTO_IDRP = 0x85

CLNP_NPDU_DT = 0x1C
CLNP_NPDU_MD = 0x1D
CLNP_NPDU_ER = 0x01
CLNP_NPDU_ERP = 0x1E
CLNP_NPDU_ERQ = 0x1F

CLNP_MIN_LEN = 9
CLNP_COMPRESSED_MIN_LEN = 4
CLNP_REASM_TABLE = "clnp"

PDU_TYPE_NAMES = {
    CLNP_NPDU_DT: "Data",
    CLNP_NPDU_MD: "Multicast Data",
    CLNP_NPDU_ER: "Error Report",
    CLNP_NPDU_ERP: "Echo Request",
    CLNP_NPDU_ERQ: "Echo Reply",
}

ERROR_CODES = {
    0x00: "Reason not specified",
    0x01: "Protocol procedure error",
    0x02: "Incorrect checksum",
    0x03: "PDU discarded due to congestion",
    0x04: "Header syntax error",
    0x05: "Segmentation needed but not permitted",
    0x06: "Incomplete PDU received",
    0x07: "Duplicate option",
    0x08: "Unknown PDU type",
    0x80: "Destination address unreachable",
    0x81: "Destination address unknown",
    0x90: "Unspecified source routing error",
    0x91: "Syntax error in source routing field",
    0x92: "Unknown address in source routing field",
    0x93: "Path not acceptable",
    0xA0: "Lifetime expired in transit",
    0xA1: "Lifetime expired during reassembly",
    0xB0: "Unsupported option",
    0xB1: "Unsupported protocol version",
    0xB2: "Unsupported security option",
    0xB3: "Unsupported source routing option",
    0xB4: "Unsupported record route option",
    0xB5: "Unsupported or unavailable QoS",
    0xC0: "Reassembly interference",
}


def _parse_error_code(code: int, buf: bytes):
    if len(buf) != 2:
        return None
    return (buf[0], buf[1])


def _fmt_error_code(out: TextOut, indent: int, label: str, data) -> None:
    code, octet = data
    line = "%s: %u (%s)" % (label, code, ERROR_CODES.get(code, "unknown"))
    if octet != 0:
        line += ", erroneous octet value: 0x%02x" % octet
    out.iline(indent, line)


def _json_error_code(data) -> JsonObj:
    code, octet = data
    obj = JsonObj(error_code=code)
    if code in ERROR_CODES:
        obj["error_descr"] = ERROR_CODES[code]
    if octet != 0:
        obj["erroneous_octet"] = octet
    return obj


def _parse_security(code: int, buf: bytes):
    # First octet: security format code (always 0xC0 in ATN); the ATN
    # security label follows.
    if len(buf) < 1:
        return None
    return atn_sec_label_parse(code, buf[1:])


CLNP_OPTIONS = {
    0x05: TlvTypeDescriptor(
        label="LRef", json_key="lref", parse=parse_octet_string,
        format_text=fmt_single_octet, format_json=json_octet_string),
    0xC3: TlvTypeDescriptor(
        label="QoS maintenance", json_key="qos_maintenance",
        parse=parse_octet_string, format_text=fmt_single_octet,
        format_json=json_octet_string),
    0xC1: TlvTypeDescriptor(
        label="Discard reason", json_key="discard_reason",
        parse=_parse_error_code, format_text=_fmt_error_code,
        format_json=_json_error_code),
    0xC4: TlvTypeDescriptor(
        label="Prefix-based scope control",
        json_key="prefix_based_scope_control", parse=parse_octet_string,
        format_text=fmt_octet_string, format_json=json_octet_string),
    0xC5: TlvTypeDescriptor(
        label="Security", json_key="security", parse=_parse_security,
        format_text=atn_sec_label_format_text,
        format_json=atn_sec_label_format_json),
    0xC6: TlvTypeDescriptor(
        label="Radius scope control", json_key="radius_scope_control",
        parse=parse_octet_string, format_text=fmt_octet_string,
        format_json=json_octet_string),
    0xC8: TlvTypeDescriptor(
        label="Source routing", json_key="source_routing",
        parse=parse_octet_string, format_text=fmt_octet_string,
        format_json=json_octet_string),
    0xCB: TlvTypeDescriptor(
        label="Record route", json_key="record_route",
        parse=parse_octet_string, format_text=fmt_octet_string,
        format_json=json_octet_string),
    0xCC: TlvTypeDescriptor(
        label="Padding", json_key="padding", parse=parse_octet_string,
        format_text=fmt_octet_string, format_json=json_octet_string),
    0xCD: TlvTypeDescriptor(
        label="Priority", json_key="priority", parse=parse_octet_string,
        format_text=fmt_single_octet, format_json=json_octet_string),
}


# lazily-bound payload parsers (cycle-safe; avoids per-PDU imports)
_esis_parse = _idrp_parse = _cotp_parse = None


def parse_clnp_pdu_payload(buf: bytes, msg_type: int, reasm_ctx, rx_time,
                           src_addr: int, dst_addr: int
                           ) -> tuple[Optional[ProtoNode], int]:
    if len(buf) == 0:
        return None, msg_type
    global _esis_parse, _idrp_parse, _cotp_parse
    if _cotp_parse is None:
        from .cotp import cotp_concatenated_pdu_parse
        from .esis import esis_pdu_parse
        from .idrp import idrp_pdu_parse
        _esis_parse, _idrp_parse, _cotp_parse = (
            esis_pdu_parse, idrp_pdu_parse, cotp_concatenated_pdu_parse)
    first = buf[0]
    if first == SN_PROTO_ESIS:
        return _esis_parse(buf, msg_type)
    if first == SN_PROTO_IDRP:
        return _idrp_parse(buf, msg_type)
    if first == SN_PROTO_CLNP:
        # CLNP inside CLNP: bail out to avoid loops (clnp.c:97-99)
        return UnknownProtoNode(buf), msg_type
    return _cotp_parse(buf, msg_type, reasm_ctx, rx_time,
                       src_addr, dst_addr)


class ClnpPduNode(ProtoNode):
    """Uncompressed X.233 NPDU."""
    json_key = "clnp"

    def __init__(self) -> None:
        super().__init__()
        self.err = True
        self.type = 0
        self.sp = self.ms = self.er = 0
        self.lifetime = 0.0
        self.seg_len = 0
        self.cksum = 0
        self.src_nsap = b""
        self.dst_nsap = b""
        self.pdu_id = self.offset = self.total_pdu_len = 0
        self.options = None
        self.reasm_status = ReasmStatus.UNKNOWN

    def format_text(self, out: TextOut, indent: int) -> None:
        if self.err:
            out.iline(indent, "-- Unparseable X.233 CLNP PDU")
            return
        name = PDU_TYPE_NAMES.get(self.type)
        if name is not None:
            out.iline(indent, "X.233 CLNP %s:" % name)
        else:
            out.iline(indent, "X.233 CLNP unknown PDU (code=0x%02x):"
                      % self.type)
        indent += 1
        out.iline(indent, 'Src NSAP: %s\t"%s"' % (
            hex_str(self.src_nsap), printable(self.src_nsap)))
        out.iline(indent, 'Dst NSAP: %s\t"%s"' % (
            hex_str(self.dst_nsap), printable(self.dst_nsap)))
        out.iline(indent, "Lifetime: %.1f sec" % self.lifetime)
        out.iline(indent, "Flags:%s%s%s" % (
            " SP" if self.sp else "", " MS" if self.ms else "",
            " E/R" if self.er else ""))
        if self.sp:
            out.iline(indent, "Segmentation:")
            out.iline(indent + 1, "PDU Id: 0x%x" % self.pdu_id)
            out.iline(indent + 1, "Segment offset: %u" % self.offset)
            out.iline(indent + 1, "PDU total length: %u" % self.total_pdu_len)
            out.iline(indent + 1, "CLNP reasm status: %s"
                      % self.reasm_status.value)
        if self.options:
            out.iline(indent, "Options:")
            tlv_list_format_text(out, self.options, indent + 1)
        if self.type == CLNP_NPDU_ER:
            out.iline(indent - 1, "Erroneous NPDU:")

    def format_json(self, obj: JsonObj) -> None:
        obj["err"] = self.err
        if self.err:
            return
        obj["compressed"] = False
        obj["pdu_type"] = self.type
        name = PDU_TYPE_NAMES.get(self.type)
        if name is not None:
            obj["pdu_type_name"] = name
        obj["src_nsap"] = self.src_nsap.hex()
        obj["dst_nsap"] = self.dst_nsap.hex()
        obj["lifetime"] = self.lifetime
        obj["flags"] = JsonObj(SP=bool(self.sp), MS=bool(self.ms),
                               ER=bool(self.er))
        if self.sp:
            obj["segmentation"] = JsonObj(
                pdu_id=self.pdu_id, segment_offset=self.offset,
                pdu_total_len=self.total_pdu_len)
        obj["reasm_status"] = self.reasm_status.value
        if self.options:
            obj["options"] = tlv_list_format_json(self.options)


def _reassemble(pdu, payload: bytes, reasm_ctx, rx_time, src_addr, dst_addr,
                is_final: bool) -> tuple[Optional[bytes], bool]:
    """Returns (reassembled_or_None, decode_payload)."""
    table = reasm_ctx.offset_table(CLNP_REASM_TABLE)
    key = (src_addr, dst_addr, pdu.pdu_id)
    pdu.reasm_status = table.add_fragment(
        key, payload, offset=pdu.offset, is_final=is_final,
        total_len=pdu.total_pdu_len, rx_time=rx_time,
        timeout=pdu.lifetime)
    if pdu.reasm_status is ReasmStatus.COMPLETE:
        joined = table.payload_get(key)
        if joined:
            return joined, True
    elif pdu.reasm_status is ReasmStatus.SKIPPED:
        return None, True
    return None, False


def clnp_pdu_parse(buf: bytes, msg_type: int, reasm_ctx, rx_time,
                   src_addr: int, dst_addr: int) -> Tuple[ProtoNode, int]:
    node = ClnpPduNode()
    if len(buf) < CLNP_MIN_LEN:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    hdr_len = buf[1]
    version = buf[2]
    if hdr_len == 255 or len(buf) < hdr_len or version != 1:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    lifetime_raw = buf[3]
    node.lifetime = lifetime_raw / 2.0          # half-second units
    flags = buf[4]
    node.type = flags & 0x1F
    node.er = (flags >> 5) & 1
    node.ms = (flags >> 6) & 1
    node.sp = (flags >> 7) & 1
    node.seg_len = (buf[5] << 8) | buf[6]
    node.cksum = (buf[7] << 8) | buf[8]
    pos = 9

    # address part: [len][NSAP] x2, destination first
    def read_addr(p: int) -> tuple[Optional[bytes], int]:
        if p >= len(buf):
            return None, p
        alen = buf[p]
        if p + 1 + alen > len(buf):
            return None, p
        return bytes(buf[p + 1:p + 1 + alen]), p + 1 + alen

    node.dst_nsap, pos = read_addr(pos)
    if node.dst_nsap is None:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    node.src_nsap, pos = read_addr(pos)
    if node.src_nsap is None:
        node.next = UnknownProtoNode(buf)
        return node, msg_type

    if node.sp:
        if len(buf) - pos < 6:
            node.next = UnknownProtoNode(buf)
            return node, msg_type
        node.pdu_id = (buf[pos] << 8) | buf[pos + 1]
        node.offset = (buf[pos + 2] << 8) | buf[pos + 3]
        node.total_pdu_len = (buf[pos + 4] << 8) | buf[pos + 5]
        pos += 6

    options_len = hdr_len - pos
    if options_len > 0:
        node.options = tlv_parse(buf[pos:pos + options_len], CLNP_OPTIONS, 1)
        if node.options is None:
            node.next = UnknownProtoNode(buf)
            return node, msg_type

    payload = bytes(buf[hdr_len:])
    if node.type == CLNP_NPDU_ER:
        # data part is the errored NPDU: re-run the CLNP parser
        child, msg_type = clnp_pdu_parse(payload, msg_type, reasm_ctx,
                                         rx_time, src_addr, dst_addr)
        node.next = child
    else:
        decode_payload = True
        if len(payload) == 0:
            node.reasm_status = ReasmStatus.SKIPPED
        elif node.sp and reasm_ctx is not None:
            joined, decode_payload = _reassemble(
                node, payload, reasm_ctx, rx_time, src_addr, dst_addr,
                is_final=not node.ms)
            if joined is not None:
                payload = joined
        if decode_payload:
            child, msg_type = parse_clnp_pdu_payload(
                payload, msg_type, reasm_ctx, rx_time, src_addr, dst_addr)
            node.next = child
        else:
            node.next = UnknownProtoNode(payload)
    node.err = False
    return node, msg_type


class ClnpCompressedPduNode(ProtoNode):
    """LREF-compressed NPDU (ICAO Doc 9705 SNDCF)."""
    json_key = "clnp"

    def __init__(self) -> None:
        super().__init__()
        self.err = True
        self.lref = 0
        self.priority = 0
        self.flags = 0
        self.lifetime = 0.0
        self.pdu_id = self.offset = self.total_pdu_len = 0
        self.derived = False
        self.is_segmentation_permitted = False
        self.more_segments = False
        self.reasm_status = ReasmStatus.UNKNOWN

    def format_text(self, out: TextOut, indent: int) -> None:
        if self.err:
            out.iline(indent,
                      "-- Unparseable X.233 CLNP compressed header PDU")
            return
        out.iline(indent, "X.233 CLNP Data (compressed header):")
        indent += 1
        out.iline(indent, "LRef: 0x%x Prio: %u Flags: 0x%02x" % (
            self.lref, self.priority, self.flags))
        out.iline(indent, "Lifetime: %.1f sec" % self.lifetime)
        if self.is_segmentation_permitted:
            out.iline(indent, "PDU Id: 0x%x" % self.pdu_id)
        if self.derived:
            out.iline(indent, "Segment offset: %u More: %d" % (
                self.offset, self.more_segments))
            out.iline(indent, "PDU total length: %u" % self.total_pdu_len)
            out.iline(indent, "CLNP reasm status: %s"
                      % self.reasm_status.value)

    def format_json(self, obj: JsonObj) -> None:
        obj["err"] = self.err
        if self.err:
            return
        obj["compressed"] = True
        obj["local_ref_a"] = self.lref
        obj["priority"] = self.priority
        obj["lifetime"] = self.lifetime
        obj["flags"] = self.flags
        if self.is_segmentation_permitted:
            obj["pdu_id"] = self.pdu_id
        if self.derived:
            obj["offset"] = self.offset
            obj["pdu_total_len"] = self.total_pdu_len
            obj["more"] = self.more_segments
            obj["reasm_status"] = self.reasm_status.value


def clnp_compressed_data_pdu_parse(buf: bytes, msg_type: int, reasm_ctx,
                                   rx_time, src_addr: int, dst_addr: int
                                   ) -> Tuple[ProtoNode, int]:
    node = ClnpCompressedPduNode()
    if len(buf) < CLNP_COMPRESSED_MIN_LEN:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    pdu_type = (buf[0] >> 4) & 0xF
    node.priority = buf[0] & 0xF
    lifetime_raw = buf[1]
    node.lifetime = lifetime_raw / 2.0
    node.flags = buf[2]
    lref_a = buf[3] & 0x7F
    exp = (buf[3] >> 7) & 1

    node.derived = pdu_type in (0x6, 0x7, 0x9, 0xA)
    node.is_segmentation_permitted = pdu_type in (0x1, 0x3) or node.derived
    node.more_segments = pdu_type in (0x7, 0xA)

    hdrlen = CLNP_COMPRESSED_MIN_LEN + (1 if exp else 0) \
        + (2 if node.is_segmentation_permitted else 0) \
        + (4 if node.derived else 0)
    if len(buf) < hdrlen:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    pos = 4
    if exp:
        node.lref = (lref_a << 8) | buf[pos]
        pos += 1
    else:
        node.lref = lref_a
    if node.is_segmentation_permitted:
        node.pdu_id = (buf[pos] << 8) | buf[pos + 1]
        pos += 2
    if node.derived:
        node.offset = (buf[pos] << 8) | buf[pos + 1]
        node.total_pdu_len = (buf[pos + 2] << 8) | buf[pos + 3]
        pos += 4
        remaining = len(buf) - pos
        # Sanity: offset + data must fit in total length, else this is
        # probably not a derived PDU (clnp.c:642-646).
        if node.offset + remaining > node.total_pdu_len or remaining < 1:
            node.next = UnknownProtoNode(buf)
            return node, msg_type

    payload = bytes(buf[pos:])
    decode_payload = True
    if node.derived and reasm_ctx is not None:
        joined, decode_payload = _reassemble(
            node, payload, reasm_ctx, rx_time, src_addr, dst_addr,
            is_final=not node.more_segments)
        if joined is not None:
            payload = joined
    if decode_payload:
        child, msg_type = parse_clnp_pdu_payload(
            payload, msg_type, reasm_ctx, rx_time, src_addr, dst_addr)
        node.next = child
    else:
        node.next = UnknownProtoNode(payload)
    node.err = False
    return node, msg_type
