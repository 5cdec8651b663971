"""IDRP (ISO 10747) inter-domain routing BISPDUs.

Behavioral model: reference idrp.c.  30-byte header (pid, len, type,
seq, ack, credit offered/available, 16-byte validation), then Open
(holdtime, max PDU, source RDI, RIB-AttsSet, confederation IDs, auth),
Update (withdrawn routes, path attributes incl. RD_PATH segments and
the ATN security label, NLRI list), Error (code/subcode dictionaries
incl. FSM states), Keepalive, Cease and RIB Refresh.

One deliberate divergence: the reference's RD-path RDI list parser
slices each RDI to the end of the buffer (idrp.c:209 passes ``len``
instead of ``rdi_len``); we slice to the declared RDI length.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..config import MsgFilter
from .atn import (atn_sec_label_format_json, atn_sec_label_format_text,
                  atn_sec_label_parse)
from .base import (JsonObj, ProtoNode, TextOut, UnknownProtoNode, hex_str,
                   printable)
from .tlv import (NO_VALUE, TlvTag, TlvTypeDescriptor, fmt_octet_string,
                  fmt_uint, json_octet_string, json_uint, parse_octet_string,
                  parse_uint8, single_tag_parse, tlv_list_format_json,
                  tlv_list_format_text, tlv_parse)

BISPDU_HDR_LEN = 30
BISPDU_OPEN_VERSION = 1

BISPDU_TYPE_OPEN = 1
BISPDU_TYPE_UPDATE = 2
BISPDU_TYPE_ERROR = 3
BISPDU_TYPE_KEEPALIVE = 4
BISPDU_TYPE_CEASE = 5
BISPDU_TYPE_RIBREFRESH = 6

BISPDU_TYPES = {
    BISPDU_TYPE_OPEN: "Open",
    BISPDU_TYPE_UPDATE: "Update",
    BISPDU_TYPE_ERROR: "Error",
    BISPDU_TYPE_KEEPALIVE: "Keepalive",
    BISPDU_TYPE_CEASE: "Cease",
    BISPDU_TYPE_RIBREFRESH: "RIB Refresh",
}

OPEN_PDU_ERRORS = {
    1: "Unsupported version number", 2: "Bad max PDU size",
    3: "Bad peer RD", 4: "Unsupported auth code", 5: "Auth failure",
    6: "Bad RIB-AttsSet", 7: "RDC Mismatch",
}

UPDATE_PDU_ERRORS = {
    1: "Malformed attribute list", 2: "Unrecognized well-known attribute",
    3: "Missing well-known attribute", 4: "Attribute flags error",
    5: "Attribute length error", 6: "RD routing loop",
    7: "Invalid NEXT_HOP attribute", 8: "Optional attribute error",
    9: "Invalid reachability information", 10: "Misconfigured RDCs",
    11: "Malformed NLRI", 12: "Duplicated attributes",
    13: "Illegal RD path segment",
}

FSM_STATES = {1: "CLOSED", 2: "OPEN-RCVD", 3: "OPEN-SENT",
              4: "CLOSE-WAIT", 5: "ESTABLISHED"}

RIB_REFRESH_ERRORS = {1: "Invalid opcode", 2: "Unsupported RIB-Atts"}

AUTH_MECHS = {1: "simple checksum", 2: "auth + data integrity check",
              3: "password"}

BISPDU_ERR_FSM = 4
BISPDU_ERRORS = {
    1: ("Open PDU error", OPEN_PDU_ERRORS),
    2: ("Update PDU error", UPDATE_PDU_ERRORS),
    3: ("Hold timer expired", {}),
    4: ("FSM error", FSM_STATES),
    5: ("RIB Refresh PDU error", RIB_REFRESH_ERRORS),
}

SN_PROTO_CLNP = 0x81


def _u16(buf, i):
    return (buf[i] << 8) | buf[i + 1]


def _u32(buf, i):
    return (buf[i] << 24) | (buf[i + 1] << 16) | (buf[i + 2] << 8) | buf[i + 3]


# ------------------------------------------------------- path attributes

def _parse_route_separator(code: int, buf: bytes):
    if len(buf) != 5:
        return None
    return (_u32(buf, 0), buf[4])


def _fmt_route_separator(out: TextOut, indent: int, label: str, data) -> None:
    out.iline(indent, f"{label}:")
    out.iline(indent + 1, "ID: %u" % data[0])
    out.iline(indent + 1, "Local preference: %u" % data[1])


def _json_route_separator(data) -> JsonObj:
    return JsonObj(id=data[0], localpref=data[1])


def _parse_rd_path_segment(code: int, buf: bytes):
    rdis = []
    pos, end = 0, len(buf)
    while end - pos > 1:
        rdi_len = buf[pos]
        pos += 1
        if rdi_len == 0 or end - pos < rdi_len:
            return None
        rdis.append(bytes(buf[pos:pos + rdi_len]))
        pos += rdi_len
    return rdis


def _fmt_rd_path_segment(out: TextOut, indent: int, label: str, data) -> None:
    out.iline(indent, f"{label}:")
    for rdi in data:
        out.iline(indent + 1, '%s\t"%s"' % (hex_str(rdi), printable(rdi)))


def _json_rd_path_segment(data) -> list:
    return [rdi.hex() for rdi in data]


RD_PATH_SEG_TYPES = {
    1: TlvTypeDescriptor("RD_SET", "rd_set", _parse_rd_path_segment,
                         _fmt_rd_path_segment, _json_rd_path_segment),
    2: TlvTypeDescriptor("RD_SEQ", "rd_seq", _parse_rd_path_segment,
                         _fmt_rd_path_segment, _json_rd_path_segment),
    3: TlvTypeDescriptor("ENTRY_SEQ", "entry_seq", _parse_rd_path_segment,
                         _fmt_rd_path_segment, _json_rd_path_segment),
    4: TlvTypeDescriptor("ENTRY_SET", "entry_set", _parse_rd_path_segment,
                         _fmt_rd_path_segment, _json_rd_path_segment),
}


def _parse_rd_path(code: int, buf: bytes):
    return tlv_parse(buf, RD_PATH_SEG_TYPES, 2)


def _fmt_rd_path(out: TextOut, indent: int, label: str, data) -> None:
    out.iline(indent, f"{label}:")
    tlv_list_format_text(out, data, indent + 1)


def _json_rd_path(data) -> list:
    return tlv_list_format_json(data)


def _ostring(label, json_key):
    return TlvTypeDescriptor(label=label, json_key=json_key,
                             parse=parse_octet_string,
                             format_text=fmt_octet_string,
                             format_json=json_octet_string)


def _uint8(label, json_key):
    return TlvTypeDescriptor(label=label, json_key=json_key,
                             parse=parse_uint8, format_text=fmt_uint,
                             format_json=json_uint)


PATH_ATTRIBUTES = {
    1: TlvTypeDescriptor("Route", "route", _parse_route_separator,
                         _fmt_route_separator, _json_route_separator),
    2: _ostring("Ext. info", "ext_info"),
    3: TlvTypeDescriptor("RD path", "rd_path", _parse_rd_path,
                         _fmt_rd_path, _json_rd_path),
    4: _ostring("Next hop", "next_hop"),
    5: _ostring("Distribute list inclusions", "distribute_list_inclusions"),
    6: _ostring("Distribute list exclusions", "distribute_list_exclusions"),
    7: _uint8("Multi exit discriminator", "multi_exit_discriminator"),
    8: _ostring("Transit delay", "transit_delay"),
    9: _ostring("Residual error", "residual_error"),
    10: _ostring("Expense", "expense"),
    11: _ostring("Locally defined QoS", "locally_defined_qos"),
    12: _ostring("Hierarchical recording", "hierarchical_recording"),
    13: _uint8("RD hop count", "rd_hop_count"),
    14: TlvTypeDescriptor("Security", "security", atn_sec_label_parse,
                          atn_sec_label_format_text,
                          atn_sec_label_format_json),
    15: _uint8("Capacity", "capacity"),
    16: _uint8("Priority", "priority"),
}


# RibAtt wrapper rendered as "RibAtt #n:" with nested attributes
class _RibAtt:
    def __init__(self, num: int, attr_list) -> None:
        self.num = num
        self.attr_list = attr_list


def _fmt_ribatt(out: TextOut, indent: int, label: str, data: _RibAtt) -> None:
    out.iline(indent, "RibAtt #%u:" % data.num)
    tlv_list_format_text(out, data.attr_list, indent + 1)


RIBATT_TD = TlvTypeDescriptor(
    label="", json_key="ribatt", parse=lambda c, b: None,
    format_text=_fmt_ribatt,
    format_json=lambda d: tlv_list_format_json(d.attr_list))


def _parse_ribatt(buf: bytes) -> tuple[Optional[list], int]:
    """One RibAtt: count + presence-only or TLV-encoded attributes."""
    if len(buf) < 1:
        return None, -1
    attrs_cnt = buf[0]
    pos, end = 1, len(buf)
    attr_list: list[TlvTag] = []
    for _ in range(attrs_cnt):
        if pos >= end:
            break
        typecode = buf[pos]
        pos += 1
        if typecode in (11, 14):
            # Locally Defined QoS and Security are full TLVs
            if end - pos < 2:
                return None, -1
            tag_len = _u16(buf, pos)
            pos += 2
            if tag_len > end - pos:
                return None, -1
            attr_list = single_tag_parse(typecode, buf[pos:pos + tag_len],
                                         PATH_ATTRIBUTES, attr_list)
            pos += tag_len
        else:
            td = PATH_ATTRIBUTES.get(typecode)
            if td is not None:
                attr_list.append(TlvTag(typecode, td, NO_VALUE))
    return attr_list, pos


def _parse_ribatts_set(buf: bytes) -> tuple[Optional[list], int]:
    if len(buf) < 1:
        return None, -1
    ribatts_cnt = buf[0]
    pos, end = 1, len(buf)
    ribatt_list: list[TlvTag] = []
    for i in range(ribatts_cnt):
        if pos >= end:
            break
        attr_list, consumed = _parse_ribatt(buf[pos:])
        if consumed < 0:
            return None, -1
        pos += consumed
        ribatt_list.append(TlvTag(i, RIBATT_TD, _RibAtt(i, attr_list)))
    return ribatt_list, pos


def _parse_confed_ids(buf: bytes) -> tuple[Optional[list], int]:
    if len(buf) < 1:
        return None, -1
    cnt = buf[0]
    pos, end = 1, len(buf)
    ids = []
    for i in range(cnt):
        if pos >= end:
            break
        id_len = buf[pos]
        pos += 1
        if end - pos < id_len:
            return None, -1
        ids.append(bytes(buf[pos:pos + id_len]))
        pos += id_len
    return ids, pos


class NlriEntry:
    def __init__(self) -> None:
        self.is_clnp = False
        self.proto_type = 0
        self.proto = b""
        self.prefix_len = 0
        self.prefix = b""


def _parse_nlri_list(buf: bytes) -> tuple[Optional[list], int]:
    nlri = []
    pos, end = 0, len(buf)
    while pos < end:
        if end - pos < 6:
            return None, -1
        entry = NlriEntry()
        nlri.append(entry)
        entry.proto_type = buf[pos]
        proto_len = buf[pos + 1]
        pos += 2
        if end - pos < proto_len:
            return None, -1
        entry.proto = bytes(buf[pos:pos + proto_len])
        pos += proto_len
        entry.is_clnp = (entry.proto_type == 1 and len(entry.proto) == 1
                         and entry.proto[0] == SN_PROTO_CLNP)
        if end - pos < 2:
            return None, -1
        addr_len = _u16(buf, pos)
        pos += 2
        if addr_len < 1 or end - pos < addr_len:
            return None, -1
        if entry.is_clnp:
            entry.prefix_len = buf[pos]
            entry.prefix = bytes(buf[pos + 1:pos + addr_len])
        else:
            entry.prefix = bytes(buf[pos:pos + addr_len])
        pos += addr_len
    return nlri, pos


class IdrpPduNode(ProtoNode):
    json_key = "idrp"

    def __init__(self) -> None:
        super().__init__()
        self.err = True
        self.type = 0
        self.seq = 0
        self.ack = 0
        self.coff = 0
        self.cavail = 0
        # Open
        self.open_holdtime = 0
        self.open_max_pdu_size = 0
        self.open_src_rdi = b""
        self.ribatts_set = None
        self.confed_ids = None
        self.auth_mech = 0
        self.auth_data = b""
        # Update
        self.withdrawn_routes: list[int] = []
        self.path_attributes = None
        self.nlri_list = None
        self.data = b""
        # Error
        self.err_code = 0
        self.err_subcode = 0
        self.err_fsm_bispdu_type = 0
        self.err_fsm_state = 0

    def format_text(self, out: TextOut, indent: int) -> None:
        if self.err:
            out.iline(indent, "-- Unparseable IDRP PDU")
            return
        out.iline(indent, "IDRP %s: seq: %u ack: %u credit_offered: %u "
                          "credit_avail: %u" % (
                              BISPDU_TYPES.get(self.type), self.seq,
                              self.ack, self.coff, self.cavail))
        indent += 1
        if self.type == BISPDU_TYPE_OPEN:
            out.iline(indent, "Hold Time: %u seconds" % self.open_holdtime)
            out.iline(indent, "Max. PDU size: %u octets"
                      % self.open_max_pdu_size)
            out.iline(indent, 'Source RDI: %s\t"%s"' % (
                hex_str(self.open_src_rdi), printable(self.open_src_rdi)))
            out.iline(indent, "RIB Attribute Set:")
            if self.ribatts_set:
                tlv_list_format_text(out, self.ribatts_set, indent + 1)
            if self.confed_ids:
                out.iline(indent, "Confederation IDs:")
                for cid in self.confed_ids:
                    out.iline(indent + 1, '%s\t"%s"' % (
                        hex_str(cid), printable(cid)))
            out.iline(indent, "Auth mechanism: %s"
                      % AUTH_MECHS.get(self.auth_mech, "unknown"))
            if self.auth_data:
                out.iline(indent, "Auth data: " + hex_str(self.auth_data))
        elif self.type == BISPDU_TYPE_UPDATE:
            if self.withdrawn_routes:
                out.iline(indent, "Withdrawn Routes:")
                for route_id in self.withdrawn_routes:
                    out.iline(indent + 1, "ID: %u" % route_id)
            if self.path_attributes:
                tlv_list_format_text(out, self.path_attributes, indent)
            if self.nlri_list:
                for dest in self.nlri_list:
                    out.iline(indent, "Reachability info:")
                    if dest.is_clnp:
                        out.iline(indent + 1, "Protocol: CLNP")
                        out.iline(indent + 1, "Prefix length: %u"
                                  % dest.prefix_len)
                    else:
                        out.iline(indent + 1, "Protocol: "
                                  + hex_str(dest.proto))
                    out.iline(indent + 1, 'Dest. address prefix: %s\t"%s"'
                              % (hex_str(dest.prefix),
                                 printable(dest.prefix)))
            elif self.data:
                out.iline(indent, "-- Unparseable NLRI")
                out.iline(indent + 1, '%s\t"%s"' % (
                    hex_str(self.data), printable(self.data)))
        elif self.type == BISPDU_TYPE_ERROR:
            self._format_error_text(out, indent)

    def _format_error_text(self, out: TextOut, indent: int) -> None:
        err = BISPDU_ERRORS.get(self.err_code)
        out.iline(indent, "Code: %u (%s)" % (
            self.err_code, err[0] if err else "unknown"))
        if err is None:
            out.iline(indent, "Subcode: %u (unknown)" % self.err_subcode)
        elif self.err_code == BISPDU_ERR_FSM:
            out.iline(indent, "Erroneous BISPDU type: %s"
                      % BISPDU_TYPES.get(self.err_fsm_bispdu_type, "unknown"))
            out.iline(indent, "FSM state: %s"
                      % FSM_STATES.get(self.err_fsm_state, "unknown"))
        else:
            out.iline(indent, "Subcode: %u (%s)" % (
                self.err_subcode, err[1].get(self.err_subcode, "unknown")))
        if self.data:
            out.iline(indent, "Error data: " + hex_str(self.data))

    def format_json(self, obj: JsonObj) -> None:
        obj["err"] = self.err
        if self.err:
            return
        obj["pdu_type"] = self.type
        if self.type in BISPDU_TYPES:
            obj["pdu_type_name"] = BISPDU_TYPES[self.type]
        obj["seq"] = self.seq
        obj["ack"] = self.ack
        obj["credit_offered"] = self.coff
        obj["credit_avail"] = self.cavail
        if self.type == BISPDU_TYPE_OPEN:
            obj["hold_time"] = self.open_holdtime
            obj["max_pdu_size"] = self.open_max_pdu_size
            obj["src_rdi"] = self.open_src_rdi.hex()
            if self.ribatts_set:
                obj["ribatts_set"] = tlv_list_format_json(self.ribatts_set)
            if self.confed_ids:
                obj["confed_ids"] = [c.hex() for c in self.confed_ids]
            obj["auth_mech"] = self.auth_mech
            if self.auth_mech in AUTH_MECHS:
                obj["auth_mech_name"] = AUTH_MECHS[self.auth_mech]
            if self.auth_data:
                obj["auth_data"] = self.auth_data.hex()
        elif self.type == BISPDU_TYPE_UPDATE:
            if self.withdrawn_routes:
                obj["withdrawn_routes"] = list(self.withdrawn_routes)
            if self.path_attributes:
                obj["path_attributes"] = tlv_list_format_json(
                    self.path_attributes)
            if self.nlri_list:
                arr = []
                for dest in self.nlri_list:
                    entry = JsonObj()
                    if dest.is_clnp:
                        entry["proto"] = "CLNP"
                        entry["prefix_len"] = dest.prefix_len
                    else:
                        entry["proto_id"] = dest.proto.hex()
                    entry["dst_prefix"] = dest.prefix.hex()
                    arr.append(entry)
                obj["nlri_list"] = arr
            elif self.data:
                obj["__unparseable_nlri"] = self.data.hex()
        elif self.type == BISPDU_TYPE_ERROR:
            obj["err_code"] = self.err_code
            err = BISPDU_ERRORS.get(self.err_code)
            if err is not None:
                obj["err_descr"] = err[0]
                if self.err_code == BISPDU_ERR_FSM:
                    obj["err_fsm_bispdu_type"] = self.err_fsm_bispdu_type
                    obj["err_fsm_state"] = self.err_fsm_state
                    if self.err_fsm_bispdu_type in BISPDU_TYPES:
                        obj["err_fsm_bispdu_name"] = \
                            BISPDU_TYPES[self.err_fsm_bispdu_type]
                    if self.err_fsm_state in FSM_STATES:
                        obj["err_fsm_state_descr"] = \
                            FSM_STATES[self.err_fsm_state]
                else:
                    obj["err_subcode"] = self.err_subcode
                    if self.err_subcode in err[1]:
                        obj["err_subcode_descr"] = err[1][self.err_subcode]
            if self.data:
                obj["err_payload"] = self.data.hex()


def _parse_open(pdu: IdrpPduNode, buf: bytes) -> int:
    if len(buf) < 6 or buf[0] != BISPDU_OPEN_VERSION:
        return -1
    pdu.open_holdtime = _u16(buf, 1)
    pdu.open_max_pdu_size = _u16(buf, 3)
    rdi_len = buf[5]
    pos = 6
    if len(buf) - pos < rdi_len:
        return -1
    pdu.open_src_rdi = bytes(buf[pos:pos + rdi_len])
    pos += rdi_len
    ribatts, consumed = _parse_ribatts_set(buf[pos:])
    if consumed < 0:
        return -1
    pdu.ribatts_set = ribatts
    pos += consumed
    confed, consumed = _parse_confed_ids(buf[pos:])
    if consumed < 0:
        return -1
    pdu.confed_ids = confed
    pos += consumed
    if pos >= len(buf):
        return -1
    pdu.auth_mech = buf[pos]
    pos += 1
    if pos < len(buf):
        pdu.auth_data = bytes(buf[pos:])
        pos = len(buf)
    return pos


def _parse_update(pdu: IdrpPduNode, buf: bytes) -> int:
    if len(buf) < 4:
        return -1
    num_withdrawn = _u16(buf, 0)
    pos = 2
    if num_withdrawn > 0:
        if len(buf) - pos < num_withdrawn * 4:
            return -1
        for _ in range(num_withdrawn):
            pdu.withdrawn_routes.append(_u32(buf, pos))
            pos += 4
    if len(buf) - pos < 2:
        return -1
    total_attrib_len = _u16(buf, pos)
    pos += 2
    if total_attrib_len > 0:
        if len(buf) - pos < total_attrib_len:
            return -1
        attrs: list[TlvTag] = []
        remaining = total_attrib_len
        while remaining > 4:      # flag + typecode + u16 length
            typecode = buf[pos + 1]
            alen = _u16(buf, pos + 2)
            pos += 4
            remaining -= 4
            if len(buf) - pos < alen:
                return -1
            attrs = single_tag_parse(typecode, buf[pos:pos + alen],
                                     PATH_ATTRIBUTES, attrs)
            pos += alen
            remaining -= alen
        if remaining > 0:
            return -1
        pdu.path_attributes = attrs
    nlri, consumed = _parse_nlri_list(buf[pos:])
    if consumed >= 0:
        pdu.nlri_list = nlri or None
        pos += consumed
    else:
        pdu.data = bytes(buf[pos:])
        pos = len(buf)
    return pos


def _parse_error(pdu: IdrpPduNode, buf: bytes) -> int:
    if len(buf) < 2:
        return -1
    pdu.err_code = buf[0]
    pdu.err_subcode = buf[1]
    if pdu.err_code == BISPDU_ERR_FSM:
        pdu.err_fsm_bispdu_type = pdu.err_subcode >> 4
        pdu.err_fsm_state = pdu.err_subcode & 0xF
    pdu.data = bytes(buf[2:])
    return len(buf)


def idrp_pdu_parse(buf: bytes, msg_type: int) -> Tuple[ProtoNode, int]:
    node = IdrpPduNode()
    if len(buf) < BISPDU_HDR_LEN:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    pdu_len = _u16(buf, 1)
    node.type = buf[3]
    node.seq = _u32(buf, 4)
    node.ack = _u32(buf, 8)
    node.coff = buf[12]
    node.cavail = buf[13]
    if len(buf) < pdu_len:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    body = buf[BISPDU_HDR_LEN:pdu_len]
    result = 0
    if node.type == BISPDU_TYPE_OPEN:
        result = _parse_open(node, body)
    elif node.type == BISPDU_TYPE_UPDATE:
        result = _parse_update(node, body)
    elif node.type == BISPDU_TYPE_ERROR:
        result = _parse_error(node, body)
    elif node.type in (BISPDU_TYPE_KEEPALIVE, BISPDU_TYPE_CEASE,
                       BISPDU_TYPE_RIBREFRESH):
        result = 0
    else:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    if result < 0:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    leftover = buf[BISPDU_HDR_LEN + result:]
    if leftover:
        node.next = UnknownProtoNode(leftover)
    if node.type == BISPDU_TYPE_KEEPALIVE:
        msg_type |= MsgFilter.IDRP_KEEPALIVE
    else:
        msg_type |= MsgFilter.IDRP_NO_KEEPALIVE
    node.err = False
    return node, msg_type
