"""ES-IS (ISO 9542) hello PDUs: ESH / ISH.

Behavioral model: reference esis.c.  Header: pid, len, version,
reserved, type(5 bits), holdtime(u16), checksum(u16); then the SA/NET
address and an options TLV with the ATN mobile-subnetwork-capabilities
extension.
"""
from __future__ import annotations

from typing import Tuple

from ..config import MsgFilter
from .atn import (ATN_TRAFFIC_TYPES, ATN_TRAFFIC_TYPES_ALL,
                  ATSC_TRAFFIC_CLASSES, ATSC_TRAFFIC_CLASSES_ALL)
from .base import (JsonObj, ProtoNode, TextOut, UnknownProtoNode,
                   bitfield_format_json, hex_str, printable)
from .tlv import (TlvTypeDescriptor, fmt_octet_string, json_octet_string,
                  parse_octet_string, tlv_list_format_json,
                  tlv_list_format_text, tlv_parse)

ESIS_HDR_LEN = 9
ESIS_PDU_TYPE_ESH = 2
ESIS_PDU_TYPE_ISH = 4

PDU_TYPE_NAMES = {ESIS_PDU_TYPE_ESH: "ES Hello",
                  ESIS_PDU_TYPE_ISH: "IS Hello"}


def _parse_subnet_caps(code: int, buf: bytes):
    if len(buf) < 1:
        return None
    traffic_types = buf[0]
    atsc = None
    if buf[0] & 1 and len(buf) > 1:   # ATS allowed -> ATSC classes octet
        atsc = buf[1]
    return (traffic_types, atsc)


def _fmt_subnet_caps(out: TextOut, indent: int, label: str, data) -> None:
    traffic_types, atsc = data
    out.iline(indent, f"{label}:")
    if (traffic_types & ATN_TRAFFIC_TYPES_ALL) == ATN_TRAFFIC_TYPES_ALL:
        permitted = "all"
    else:
        permitted = ", ".join(n for m, n in ATN_TRAFFIC_TYPES
                              if traffic_types & m) or "none"
    out.iline(indent + 1, "Permitted traffic: %s" % permitted)
    if atsc is not None:
        if (atsc & ATSC_TRAFFIC_CLASSES_ALL) == ATSC_TRAFFIC_CLASSES_ALL:
            classes = "all"
        else:
            classes = ", ".join(n for m, n in ATSC_TRAFFIC_CLASSES
                                if atsc & m) or "none"
        out.iline(indent + 1, "Supported ATSC classes: %s" % classes)


def _json_subnet_caps(data) -> JsonObj:
    traffic_types, atsc = data
    obj = JsonObj()
    bitfield_format_json(obj, "permitted_traffic", traffic_types,
                         ATN_TRAFFIC_TYPES)
    if atsc is not None:
        bitfield_format_json(obj, "supported_atsc_classes", atsc,
                             ATSC_TRAFFIC_CLASSES)
    return obj


ESIS_OPTIONS = {
    0xC5: TlvTypeDescriptor(
        label="Security", json_key="security", parse=parse_octet_string,
        format_text=fmt_octet_string, format_json=json_octet_string),
    0xCF: TlvTypeDescriptor(
        label="Priority", json_key="priority", parse=parse_octet_string,
        format_text=fmt_octet_string, format_json=json_octet_string),
    0x81: TlvTypeDescriptor(
        label="Mobile Subnetwork Capabilities",
        json_key="mobile_subnet_caps", parse=_parse_subnet_caps,
        format_text=_fmt_subnet_caps, format_json=_json_subnet_caps),
    0x88: TlvTypeDescriptor(
        label="ATN Data Link Capabilities", json_key="atn_datalink_caps",
        parse=parse_octet_string, format_text=fmt_octet_string,
        format_json=json_octet_string),
}


class EsisPduNode(ProtoNode):
    json_key = "esis"

    def __init__(self) -> None:
        super().__init__()
        self.err = True
        self.type = 0
        self.holdtime = 0
        self.net_addr = b""
        self.options = None

    def format_text(self, out: TextOut, indent: int) -> None:
        if self.err:
            out.iline(indent, "-- Unparseable ES-IS PDU")
            return
        out.iline(indent, "ES-IS %s: Hold Time: %u sec" % (
            PDU_TYPE_NAMES.get(self.type), self.holdtime))
        indent += 1
        prefix = "SA : " if self.type == ESIS_PDU_TYPE_ESH else "NET: "
        out.iline(indent, '%s%s\t"%s"' % (
            prefix, hex_str(self.net_addr), printable(self.net_addr)))
        if self.options is not None:
            out.iline(indent, "Options:")
            tlv_list_format_text(out, self.options, indent + 1)

    def format_json(self, obj: JsonObj) -> None:
        obj["err"] = self.err
        if self.err:
            return
        obj["pdu_type"] = self.type
        obj["pdu_type_name"] = PDU_TYPE_NAMES.get(self.type)
        obj["hold_time"] = self.holdtime
        key = "sa" if self.type == ESIS_PDU_TYPE_ESH else "net"
        obj[key] = self.net_addr.hex()
        if self.options is not None:
            obj["options"] = tlv_list_format_json(self.options)


def esis_pdu_parse(buf: bytes, msg_type: int) -> Tuple[ProtoNode, int]:
    node = EsisPduNode()
    if len(buf) < ESIS_HDR_LEN:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    version = buf[2]
    pdu_len = buf[1]
    if version != 1 or len(buf) < pdu_len:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    node.type = buf[4] & 0x1F
    node.holdtime = (buf[5] << 8) | buf[6]
    pos = ESIS_HDR_LEN
    if pos >= len(buf):
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    alen = buf[pos]
    if pos + 1 + alen > len(buf):
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    node.net_addr = bytes(buf[pos + 1:pos + 1 + alen])
    pos += 1 + alen
    if node.type not in (ESIS_PDU_TYPE_ESH, ESIS_PDU_TYPE_ISH):
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    if pos < len(buf):
        node.options = tlv_parse(buf[pos:], ESIS_OPTIONS, 1)
        if node.options is None:
            node.next = UnknownProtoNode(buf)
            return node, msg_type
    msg_type |= MsgFilter.ESIS
    node.err = False
    return node, msg_type
