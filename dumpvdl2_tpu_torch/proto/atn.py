"""ATN security label (ICAO Doc 9705) — traffic types, subnet caps,
ATSC classes, security classification.

Behavioral model: reference atn.c.  The label is a registration id
octet string followed by a tag set where every tag name is one octet,
so the set parses as TLV.  Reused by CLNP option 0xC5, ES-IS subnet
capabilities and IDRP path attributes.
"""
from __future__ import annotations

from typing import Optional

from .base import JsonObj, TextOut, bitfield_format_json, hex_str
from .tlv import (TlvTypeDescriptor, parse_uint8, single_tag_parse,
                  tlv_list_format_json, tlv_list_format_text)

ATN_TRAFFIC_TYPES = [
    (1, "ATS"), (2, "AOC"), (4, "ATN Administrative"),
    (8, "General Comms"), (16, "ATN System Mgmt"),
]
ATN_TRAFFIC_TYPES_ALL = 0x1F

ATSC_TRAFFIC_CLASSES = [(1 << i, chr(ord("A") + i)) for i in range(8)]
ATSC_TRAFFIC_CLASSES_ALL = 0xFF

TT_UNKNOWN, TT_ATN_OPER, TT_ATN_ADMIN, TT_ATN_SYS_MGMT = 0, 1, 2, 3
CAT_UNKNOWN, CAT_ATSC, CAT_AOC, CAT_NONE = 0, 1, 2, 3

TRAFFIC_TYPE_NAMES = {TT_ATN_OPER: "ATN operational",
                      TT_ATN_ADMIN: "ATN administrative",
                      TT_ATN_SYS_MGMT: "ATN system management"}
TRAFFIC_CATEGORY_NAMES = {CAT_ATSC: "ATSC", CAT_AOC: "AOC", CAT_NONE: "none"}

SUBNET_TYPES = {1: "Mode S", 2: "VDL", 3: "AMSS", 4: "Gatelink", 5: "HF"}

SECURITY_CLASSES = {1: "unclassified", 2: "restricted", 3: "confidential",
                    4: "secret", 5: "top secret"}


def _parse_traffic_type(code: int, buf: bytes):
    if len(buf) < 1:
        return None
    ttype, category = TT_UNKNOWN, CAT_UNKNOWN
    policy = buf[0] & 0x1F
    sel = buf[0] >> 5
    if sel == 0:
        ttype, category = TT_ATN_OPER, CAT_ATSC
    elif sel == 1:
        if buf[0] == 0x30:
            ttype, category = TT_ATN_ADMIN, CAT_NONE
        else:
            ttype, category = TT_ATN_OPER, CAT_AOC
    elif sel == 3:
        ttype, category = TT_ATN_SYS_MGMT, CAT_NONE
    return (ttype, category, policy)


def _fmt_traffic_type(out: TextOut, indent: int, label: str, data) -> None:
    ttype, category, policy = data
    out.iline(indent, f"{label}:")
    out.iline(indent + 1, "Type: %s"
              % TRAFFIC_TYPE_NAMES.get(ttype, "unknown"))
    out.iline(indent + 1, "Category: %s"
              % TRAFFIC_CATEGORY_NAMES.get(category, "unknown"))
    out.iline(indent + 1, "Route policy: 0x%02x" % policy)


def _json_traffic_type(data) -> JsonObj:
    ttype, category, policy = data
    obj = JsonObj(type_id=ttype)
    if ttype in TRAFFIC_TYPE_NAMES:
        obj["type_name"] = TRAFFIC_TYPE_NAMES[ttype]
    obj["category_id"] = category
    if category in TRAFFIC_CATEGORY_NAMES:
        obj["category_name"] = TRAFFIC_CATEGORY_NAMES[category]
    obj["route_policy"] = policy
    return obj


def _parse_subnet_type(code: int, buf: bytes):
    if len(buf) != 2:
        return None
    return (buf[0], buf[1])


def _fmt_subnet_type(out: TextOut, indent: int, label: str, data) -> None:
    subnet, permitted = data
    out.iline(indent, f"{label}:")
    out.iline(indent + 1, "Subnet: %s" % SUBNET_TYPES.get(subnet, "unknown"))
    if (permitted & ATN_TRAFFIC_TYPES_ALL) == ATN_TRAFFIC_TYPES_ALL:
        traffic = "all"
    else:
        traffic = ", ".join(n for m, n in ATN_TRAFFIC_TYPES
                            if permitted & m) or "none"
    out.iline(indent + 1, "Permitted traffic: %s" % traffic)


def _json_subnet_type(data) -> JsonObj:
    subnet, permitted = data
    obj = JsonObj(subnet_id=subnet,
                  subnet_name=SUBNET_TYPES.get(subnet))
    bitfield_format_json(obj, "permitted_traffic_types", permitted,
                         ATN_TRAFFIC_TYPES)
    return obj


def _fmt_atsc_classes(out: TextOut, indent: int, label: str,
                      data: int) -> None:
    if (data & ATSC_TRAFFIC_CLASSES_ALL) == ATSC_TRAFFIC_CLASSES_ALL:
        classes = "all"
    else:
        classes = ", ".join(n for m, n in ATSC_TRAFFIC_CLASSES
                            if data & m) or "none"
    out.iline(indent, f"{label}: {classes}")


def _json_atsc_classes(data: int) -> list:
    return [n for m, n in ATSC_TRAFFIC_CLASSES if data & m]


def _fmt_sec_class(out: TextOut, indent: int, label: str, data: int) -> None:
    out.iline(indent, "%s: %s" % (
        label, SECURITY_CLASSES.get(data, "unassigned")))


def _json_sec_class(data: int) -> JsonObj:
    return JsonObj(class_id=data,
                   class_name=SECURITY_CLASSES.get(data))


ATN_SECURITY_TAGS = {
    0x3: TlvTypeDescriptor(
        label="Security classification", json_key="security_classification",
        parse=parse_uint8, format_text=_fmt_sec_class,
        format_json=_json_sec_class),
    0x5: TlvTypeDescriptor(
        label="Subnetwork type", json_key="subnet_type",
        parse=_parse_subnet_type, format_text=_fmt_subnet_type,
        format_json=_json_subnet_type),
    0x6: TlvTypeDescriptor(
        label="Supported ATSC classes", json_key="supported_atsc_classes",
        parse=parse_uint8, format_text=_fmt_atsc_classes,
        format_json=_json_atsc_classes),
    0x7: TlvTypeDescriptor(
        label="Supported ATSC classes", json_key="supported_atsc_classes",
        parse=parse_uint8, format_text=_fmt_atsc_classes,
        format_json=_json_atsc_classes),
    0xF: TlvTypeDescriptor(
        label="Traffic type", json_key="traffic_type",
        parse=_parse_traffic_type, format_text=_fmt_traffic_type,
        format_json=_json_traffic_type),
}


class AtnSecLabel:
    """Parsed security label: registration id + tag list."""

    def __init__(self, sec_rid: bytes, sec_info) -> None:
        self.sec_rid = sec_rid
        self.sec_info = sec_info


def _sec_info_parse(buf: bytes):
    tags = []
    pos, end = 0, len(buf)
    while end - pos >= 3:
        if buf[pos] != 1:     # all ATN tag set names are single-octet
            return None
        tagset_name = buf[pos + 1]
        tagset_len = buf[pos + 2]
        pos += 3
        if end - pos < tagset_len:
            return None
        tags = single_tag_parse(tagset_name, buf[pos:pos + tagset_len],
                                ATN_SECURITY_TAGS, tags)
        pos += tagset_len
    if pos != end:
        return None
    return tags


def atn_sec_label_parse(code: int, buf: bytes) -> Optional[AtnSecLabel]:
    if len(buf) < 1:
        return None
    srid_len = buf[0]
    rest = buf[1:]
    if len(rest) < srid_len:
        return None
    sec_rid = bytes(rest[:srid_len])
    rest = rest[srid_len:]
    if len(rest) < 1:
        return AtnSecLabel(sec_rid, None)
    sinfo_len = rest[0]
    rest = rest[1:]
    if len(rest) < 1:
        return AtnSecLabel(sec_rid, None)
    if len(rest) < sinfo_len:
        return None
    sec_info = _sec_info_parse(rest)
    if sec_info is None:
        return None
    return AtnSecLabel(sec_rid, sec_info)


def atn_sec_label_format_text(out: TextOut, indent: int, label: str,
                              data: AtnSecLabel) -> None:
    out.iline(indent, f"{label}:")
    out.iline(indent + 1, "Reg ID: " + hex_str(data.sec_rid))
    if data.sec_info is None:
        return
    out.iline(indent + 1, "Info:")
    tlv_list_format_text(out, data.sec_info, indent + 2)


def atn_sec_label_format_json(data: AtnSecLabel) -> JsonObj:
    obj = JsonObj(reg_id=data.sec_rid.hex())
    if data.sec_info is not None:
        obj["sec_info"] = tlv_list_format_json(data.sec_info)
    return obj
