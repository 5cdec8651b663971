"""XID / GSIF parser (ISO 8885 parameter negotiation + ICAO Doc 9776
VDL2 private parameters).

Behavioral model: reference xid.c.  An XID frame is format octet 0x82
followed by parameter groups (public 0x80, private 0xF0), each a
[gid][u16 group length][TLV...] block with 1-octet parameter lengths.
The message type (GSIF, Link Establishment, Handoff, LCR, LPM...) is
the 4-bit index (C/R, P/F, h, r) into the ICAO 9776 Table 5.12 name
table, with h/r taken from the Connection Management parameter.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..config import MsgFilter
from ..utils.bits import reverse_bits
from .base import (JsonObj, ProtoNode, TextOut, UnknownProtoNode,
                   bitfield_format_json, bitfield_format_text, hex_str)
from .tlv import (TlvTypeDescriptor, fmt_octet_string,
                  fmt_octet_string_as_ascii, fmt_octet_string_with_ascii,
                  json_ascii, json_octet_string, parse_octet_string,
                  parse_uint8, tlv_list_format_json, tlv_list_format_text,
                  tlv_list_search, tlv_parse)

XID_FMT_ID = 0x82
XID_GID_PUBLIC = 0x80
XID_GID_PRIVATE = 0xF0
XID_MIN_GROUPLEN = 3
XID_MIN_LEN = 1 + 2 * XID_MIN_GROUPLEN
XID_PARAM_CONN_MGMT = 1

GSIF_TYPE = 3

# index: (C/R << 3) | (P/F << 2) | (h << 1) | r   -- ICAO 9776 Tab. 5.12
XID_NAMES = (
    ("", ""),
    ("XID_CMD_LCR", "Link Connection Refused"),
    ("XID_CMD_HO", "Handoff Request / Broadcast Handoff"),
    ("GSIF", "Ground Station Information Frame"),
    ("XID_CMD_LE", "Link Establishment"),
    ("", ""),
    ("XID_CMD_HO", "Handoff Initiation"),
    ("XID_CMD_LPM", "Link Parameter Modification"),
    ("", ""), ("", ""), ("", ""), ("", ""),
    ("XID_RSP_LE", "Link Establishment Response"),
    ("XID_RSP_LCR", "Link Connection Refused Response"),
    ("XID_RSP_HO", "Handoff Response"),
    ("XID_RSP_LPM", "Link Parameter Modification Response"),
)

MODULATIONS = [(2, "VDL-M2, D8PSK, 31500 bps"), (4, "VDL-M3, D8PSK, 31500 bps")]

LCR_CAUSES = {
    0x00: "Bad local parameter",
    0x01: "Out of link layer resources",
    0x02: "Out of packet layer resources",
    0x03: "Terrestrial network not available",
    0x04: "Terrestrial network congestion",
    0x05: "Cannot support autotune",
    0x06: "Station cannot support initiating handoff",
    0x7F: "Other unspecified local reason",
    0x80: "Bad global parameter",
    0x81: "Protocol violation",
    0x82: "Ground system out of resources",
    0xFF: "Other unspecified system reason",
}


# --------------------------------------------------------------- primitives

def parse_freq(buf: bytes) -> tuple[int, float]:
    """(modulations, frequency MHz); (freq+10000)*10 kHz rounded up to 25."""
    modulations = buf[0] >> 4
    freq = ((buf[0] << 8) | buf[1]) & 0x0FFF
    freq_khz = (freq + 10000) * 10
    if freq_khz % 25 != 0:
        freq_khz = freq_khz + 25 - freq_khz % 25
    return modulations, freq_khz / 1000.0


def _parse_vdl2_frequency(code: int, buf: bytes):
    if len(buf) < 2:
        return None
    return parse_freq(buf)


def _freq_text(f: tuple[int, float]) -> str:
    mods, mhz = f
    names = [name for mask, name in MODULATIONS if mods & mask]
    return "%.3f MHz (%s)" % (mhz, ", ".join(names) if names else "none")


def _fmt_vdl2_frequency(out: TextOut, indent: int, label: str, data) -> None:
    out.iline(indent, f"{label}: {_freq_text(data)}")


def _json_vdl2_frequency(data) -> JsonObj:
    mods, mhz = data
    obj = JsonObj(freq_mhz=mhz)
    bitfield_format_json(obj, "modulation_support", mods, MODULATIONS)
    return obj


def _parse_dlc_addr_list(code: int, buf: bytes):
    if len(buf) % 4 != 0:
        return None
    from .avlc import parse_dlc_addr
    return [parse_dlc_addr(buf[i:i + 4]) for i in range(0, len(buf), 4)]


def _fmt_dlc_addr_list(out: TextOut, indent: int, label: str, data) -> None:
    out.iline(indent, "%s:%s" % (
        label, "".join(" %06X" % a.addr for a in data)))


def _json_dlc_addr_list(data) -> list:
    return ["%06X" % a.addr for a in data]


def _parse_freq_support_list(code: int, buf: bytes):
    if len(buf) % 6 != 0:
        return None
    from .avlc import parse_dlc_addr
    out = []
    for i in range(0, len(buf), 6):
        freq = parse_freq(buf[i:i + 2])
        addr = parse_dlc_addr(buf[i + 2:i + 6])
        out.append((freq, addr))
    return out


def _fmt_freq_support_list(out: TextOut, indent: int, label: str,
                           data) -> None:
    out.iline(indent, f"{label}:")
    for freq, addr in data:
        out.iline(indent + 1, "Ground station: %06X" % addr.addr)
        out.iline(indent + 2, "Frequency: " + _freq_text(freq))


def _json_freq_support_list(data) -> list:
    return [JsonObj(gs_addr="%06X" % addr.addr,
                    gs_freq=_json_vdl2_frequency(freq))
            for freq, addr in data]


def _parse_lcr_cause(code: int, buf: bytes):
    if len(buf) < 3:
        return None
    return (buf[0], (buf[1] << 8) | buf[2], bytes(buf[3:]))


def _fmt_lcr_cause(out: TextOut, indent: int, label: str, data) -> None:
    cause, delay, extra = data
    out.iline(indent, "%s: 0x%02x (%s)" % (
        label, cause, LCR_CAUSES.get(cause, "unknown")))
    out.iline(indent + 1, "Delay: %u" % delay)
    if extra:
        out.iline(indent + 1, "Additional data: " + hex_str(extra))


def _json_lcr_cause(data) -> JsonObj:
    cause, delay, extra = data
    obj = JsonObj(cause_code=cause)
    if cause in LCR_CAUSES:
        obj["cause_descr"] = LCR_CAUSES[cause]
    obj["delay"] = delay
    if extra:
        obj["additional_data"] = extra.hex()
    return obj


def _loc_parse(buf: bytes) -> tuple[float, float]:
    """lat/lon, 12-bit signed fields in 0.1-degree units."""
    lat = ((buf[0] << 8) | buf[1]) >> 4
    lon = ((buf[1] << 8) | buf[2]) & 0xFFF
    if lat & 0x800:
        lat -= 0x1000
    if lon & 0x800:
        lon -= 0x1000
    return lat / 10.0, lon / 10.0


def _loc_text(loc: tuple[float, float]) -> str:
    lat, lon = loc
    ns, we = "N", "E"
    if lat < 0:
        lat, ns = -lat, "S"
    if lon < 0:
        lon, we = -lon, "W"
    return "%.1f%c %.1f%c" % (lat, ns, lon, we)


def _parse_location(code: int, buf: bytes):
    if len(buf) < 3:
        return None
    return _loc_parse(buf)


def _fmt_location(out: TextOut, indent: int, label: str, data) -> None:
    out.iline(indent, f"{label}: {_loc_text(data)}")


def _json_location(data) -> JsonObj:
    return JsonObj(lat=data[0], lon=data[1])


def _parse_loc_alt(code: int, buf: bytes):
    if len(buf) < 4:
        return None
    return (_loc_parse(buf), buf[3] * 1000)


def _fmt_loc_alt(out: TextOut, indent: int, label: str, data) -> None:
    loc, alt = data
    out.iline(indent, "%s: %s %d ft" % (label, _loc_text(loc), alt))


def _json_loc_alt(data) -> JsonObj:
    return JsonObj(loc=_json_location(data[0]), alt=data[1])


def _fmt_conn_mgmt(out: TextOut, indent: int, label: str, data: int) -> None:
    out.iline(indent, "%s: %02x" % (label, data))


def _fmt_xid_seq(out: TextOut, indent: int, label: str, data: int) -> None:
    out.iline(indent, "%s: seq: %u retry: %u" % (label, data & 0x7, data >> 4))


def _json_xid_seq(data: int) -> JsonObj:
    return JsonObj(seq=data & 0x7, retry=data >> 4)


def _fmt_modulation(out: TextOut, indent: int, label: str, data: int) -> None:
    out.iappend(indent, f"{label}: ")
    bitfield_format_text(out, data & 0xFF, MODULATIONS)
    out.append("\n")


def _json_modulation(data: int) -> list:
    return [name for mask, name in MODULATIONS if data & mask]


def _ostring(label: str, json_key: str, text_fmt=fmt_octet_string,
             json_fmt=json_octet_string) -> TlvTypeDescriptor:
    return TlvTypeDescriptor(label=label, json_key=json_key,
                             parse=parse_octet_string,
                             format_text=text_fmt, format_json=json_fmt)


XID_PUB_PARAMS = {
    0x1: _ostring("Parameter set ID", "param_set_id",
                  fmt_octet_string_as_ascii, json_ascii),
    0x2: _ostring("Procedure classes", "procedure_classes"),
    0x3: _ostring("HDLC options", "hdlc_options"),
    0x5: _ostring("N1-downlink", "n1_downlink"),
    0x6: _ostring("N1-uplink", "n1_uplink"),
    0x7: _ostring("k-downlink", "k_downlink"),
    0x8: _ostring("k-uplink", "k_uplink"),
    0x9: _ostring("Timer T1_downlink", "timer_t1_downlink"),
    0xA: _ostring("Counter N2", "counter_n2"),
    0xB: _ostring("Timer T2", "timer_t2"),
}

XID_VDL_PARAMS = {
    0x00: _ostring("Parameter set ID", "param_set_id",
                   fmt_octet_string_as_ascii, json_ascii),
    0x01: TlvTypeDescriptor(
        label="Connection management", json_key="conn_mgmt",
        parse=parse_uint8, format_text=_fmt_conn_mgmt,
        format_json=lambda d: d),
    0x02: _ostring("SQP", "sqp"),
    0x03: TlvTypeDescriptor(
        label="XID sequencing", json_key="xid_sequencing",
        parse=parse_uint8, format_text=_fmt_xid_seq,
        format_json=_json_xid_seq),
    0x04: _ostring("AVLC specific options", "avlc_specific_options"),
    0x05: _ostring("Expedited SN connection", "expedited_sn_connection"),
    0x06: TlvTypeDescriptor(
        label="LCR cause", json_key="lcr_cause",
        parse=_parse_lcr_cause, format_text=_fmt_lcr_cause,
        format_json=_json_lcr_cause),
    0x81: TlvTypeDescriptor(
        label="Modulation support", json_key="modulation_support",
        parse=parse_uint8, format_text=_fmt_modulation,
        format_json=_json_modulation),
    0x82: TlvTypeDescriptor(
        label="Alternate ground stations",
        json_key="alternate_ground_stations",
        parse=_parse_dlc_addr_list, format_text=_fmt_dlc_addr_list,
        format_json=_json_dlc_addr_list),
    0x83: _ostring("Destination airport", "dst_airport",
                   fmt_octet_string_as_ascii, json_ascii),
    0x84: TlvTypeDescriptor(
        label="Aircraft location", json_key="ac_location",
        parse=_parse_loc_alt, format_text=_fmt_loc_alt,
        format_json=_json_loc_alt),
    0x40: TlvTypeDescriptor(
        label="Autotune frequency", json_key="autotune_freq",
        parse=_parse_vdl2_frequency, format_text=_fmt_vdl2_frequency,
        format_json=_json_vdl2_frequency),
    0x41: TlvTypeDescriptor(
        label="Replacement ground stations",
        json_key="replacement_ground_stations",
        parse=_parse_dlc_addr_list, format_text=_fmt_dlc_addr_list,
        format_json=_json_dlc_addr_list),
    0x42: _ostring("Timer T4", "timer_t4"),
    0x43: _ostring("MAC persistence", "mac_persistence"),
    0x44: _ostring("Counter M1", "counter_m1"),
    0x45: _ostring("Timer TM2", "timer_tm2"),
    0x46: _ostring("Timer TG5", "timer_tg5"),
    0x47: _ostring("Timer T3min", "timer_t3min"),
    0x48: TlvTypeDescriptor(
        label="Ground station address filter", json_key="gs_addr_filter",
        parse=_parse_dlc_addr_list, format_text=_fmt_dlc_addr_list,
        format_json=_json_dlc_addr_list),
    0x49: _ostring("Broadcast connection", "broadcast_connection"),
    0xC0: TlvTypeDescriptor(
        label="Frequency support list", json_key="freq_support_list",
        parse=_parse_freq_support_list, format_text=_fmt_freq_support_list,
        format_json=_json_freq_support_list),
    0xC1: _ostring("Airport coverage", "airport_coverage",
                   fmt_octet_string_as_ascii, json_ascii),
    0xC3: _ostring("Nearest airport ID", "nearest_airport_id",
                   fmt_octet_string_as_ascii, json_ascii),
    0xC4: _ostring("ATN router NETs", "atn_router_nets",
                   fmt_octet_string_with_ascii, json_octet_string),
    0xC5: TlvTypeDescriptor(
        label="System mask", json_key="system_mask",
        parse=_parse_dlc_addr_list, format_text=_fmt_dlc_addr_list,
        format_json=_json_dlc_addr_list),
    0xC6: _ostring("Timer TG3", "timer_tg3"),
    0xC7: _ostring("Timer TG4", "timer_tg4"),
    0xC8: TlvTypeDescriptor(
        label="Ground station location", json_key="gs_location",
        parse=_parse_location, format_text=_fmt_location,
        format_json=_json_location),
}


class XidNode(ProtoNode):
    json_key = "xid"

    def __init__(self) -> None:
        super().__init__()
        self.err = True
        self.type = 0
        self.pub_params = None
        self.vdl_params = None

    def format_text(self, out: TextOut, indent: int) -> None:
        if self.err:
            out.iline(indent, "-- Unparseable XID")
            return
        out.iline(indent, "XID: %s" % XID_NAMES[self.type][1])
        indent += 1
        if self.pub_params is not None:
            out.iline(indent, "Public params:")
            tlv_list_format_text(out, self.pub_params, indent + 1)
        out.iline(indent, "VDL params:")
        tlv_list_format_text(out, self.vdl_params, indent + 1)

    def format_json(self, obj: JsonObj) -> None:
        obj["err"] = self.err
        if self.err:
            return
        obj["type"] = XID_NAMES[self.type][0]
        obj["type_descr"] = XID_NAMES[self.type][1]
        if self.pub_params is not None:
            obj["pub_params"] = tlv_list_format_json(self.pub_params)
        obj["vdl_params"] = tlv_list_format_json(self.vdl_params)


def xid_parse(cr: int, pf: int, buf: bytes, msg_type: int
              ) -> Tuple[ProtoNode, int]:
    node = XidNode()
    if len(buf) < XID_MIN_LEN or buf[0] != XID_FMT_ID:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    pos, end = 1, len(buf)
    while end - pos >= XID_MIN_GROUPLEN:
        gid = buf[pos]
        grouplen = (buf[pos + 1] << 8) | buf[pos + 2]
        pos += 3
        if grouplen > end - pos:
            node.next = UnknownProtoNode(buf)
            return node, msg_type
        group = buf[pos:pos + grouplen]
        if gid == XID_GID_PUBLIC:
            if node.pub_params is not None:
                node.next = UnknownProtoNode(buf)
                return node, msg_type
            node.pub_params = tlv_parse(group, XID_PUB_PARAMS, 1)
        elif gid == XID_GID_PRIVATE:
            if node.vdl_params is not None:
                node.next = UnknownProtoNode(buf)
                return node, msg_type
            node.vdl_params = tlv_parse(group, XID_VDL_PARAMS, 1)
        pos += grouplen
    if node.vdl_params is None:
        node.next = UnknownProtoNode(buf)
        return node, msg_type
    if pos < end:
        node.next = UnknownProtoNode(buf[pos:])

    # connection-management parameter determines the message type
    cm = 0xFF
    tag = tlv_list_search(node.vdl_params, XID_PARAM_CONN_MGMT)
    if tag is not None and isinstance(tag.data, int):
        cm = tag.data
    h, r = (cm >> 0) & 1, (cm >> 1) & 1
    node.type = ((cr & 1) << 3) | ((pf & 1) << 2) | (h << 1) | r
    if node.type == GSIF_TYPE:
        msg_type |= MsgFilter.XID_GSIF
    else:
        msg_type |= MsgFilter.XID_NO_GSIF
    node.err = False
    return node, msg_type
