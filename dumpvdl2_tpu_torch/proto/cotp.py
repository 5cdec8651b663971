"""COTP (X.224 connection-oriented transport) — concatenated TPDUs.

Behavioral model: reference cotp.c.  One NSDU may carry several
concatenated TPDUs; only the final one (CR/CC/DR/DT/ED) carries user
data, which goes to the ICAO ULCS parser.  DT/ED chains reassemble on
(AVLC src, AVLC dst, dst_ref) with EOT as the final marker and a 30 s
timeout; normal format uses 7-bit sequence numbers, extended 31-bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from ..config import Config
from .base import JsonObj, ProtoNode, TextOut, UnknownProtoNode
from .reasm import ReasmStatus
from .tlv import (TlvTypeDescriptor, fmt_octet_string, fmt_single_octet,
                  fmt_uint, json_octet_string, json_uint,
                  parse_octet_string, parse_uint8, parse_uint16_msbfirst,
                  parse_uint32_msbfirst, tlv_list_format_json,
                  tlv_list_format_text, tlv_parse)

COTP_TPDU_CR = 0xE0
COTP_TPDU_CC = 0xD0
COTP_TPDU_DR = 0x80
COTP_TPDU_DC = 0xC0
COTP_TPDU_DT = 0xF0
COTP_TPDU_ED = 0x10
COTP_TPDU_AK = 0x60
COTP_TPDU_EA = 0x20
COTP_TPDU_RJ = 0x50
COTP_TPDU_ER = 0x70

COTP_REASM_TIMEOUT = 30.0

# lazily-bound ICAO APDU parser (cycle-safe, no per-PDU import)
_icao_parse = None

TPDU_NAMES = {
    COTP_TPDU_CR: "Connect Request",
    COTP_TPDU_CC: "Connect Confirm",
    COTP_TPDU_DR: "Disconnect Request",
    COTP_TPDU_DC: "Disconnect Confirm",
    COTP_TPDU_DT: "Data",
    COTP_TPDU_ED: "Expedited Data",
    COTP_TPDU_AK: "Data Ack",
    COTP_TPDU_EA: "Expedited Data Ack",
    COTP_TPDU_RJ: "Reject",
    COTP_TPDU_ER: "Error",
}

DR_REASONS = {
    0: "Reason not specified", 1: "TSAP congestion",
    2: "Session entity not attached to TSAP", 3: "Unknown address",
    128: "Normal disconnect", 129: "Remote transport entity congestion",
    130: "Connection negotiation failed", 131: "Duplicate source reference",
    132: "Mismatched references", 133: "Protocol error",
    135: "Reference overflow", 136: "Connection request refused",
    138: "Header or parameter length invalid",
}

ER_REJECT_CAUSES = {
    0: "Reason not specified", 1: "Invalid parameter code",
    2: "Invalid TPDU type", 3: "Invalid parameter value",
}

# X.225 6.6.4 SPM disconnect reason codes (DR user data, single octet)
X225_DISC_REASONS = (
    "Protocol error, cannnot sent ABORT SPDU",
    "OK, transport connection not reused",
    "OK, transport connection reuse not possible",
)


def _parse_tpdu_size(code: int, buf: bytes):
    if len(buf) != 1 or buf[0] < 0x7 or buf[0] > 0xD:
        return None
    return 1 << buf[0]


def _parse_flow_control(code: int, buf: bytes):
    if len(buf) != 8:
        return None
    acked_tpdu_nr = ((buf[0] << 24) | (buf[1] << 16) | (buf[2] << 8)
                     | buf[3]) & 0x7FFFFFFF
    acked_subseq = (buf[4] << 8) | buf[5]
    acked_credit = (buf[6] << 8) | buf[7]
    return (acked_tpdu_nr, acked_subseq, acked_credit)


def _fmt_flow_control(out: TextOut, indent: int, label: str, data) -> None:
    out.iline(indent, f"{label}:")
    out.iline(indent + 1, "Acked TPDU nr: %u" % data[0])
    out.iline(indent + 1, "Acked subsequence: %u" % data[1])
    out.iline(indent + 1, "Acked credit: %u" % data[2])


def _json_flow_control(data) -> JsonObj:
    return JsonObj(acked_tpdu_nr=data[0], acked_subseq=data[1],
                   acked_credit=data[2])


def _ostring(label, json_key, text_fmt=fmt_octet_string):
    return TlvTypeDescriptor(label=label, json_key=json_key,
                             parse=parse_octet_string,
                             format_text=text_fmt,
                             format_json=json_octet_string)


def _uint(label, json_key, parser):
    return TlvTypeDescriptor(label=label, json_key=json_key, parse=parser,
                             format_text=fmt_uint, format_json=json_uint)


VARIABLE_PART_PARAMS = {
    0x08: _ostring("ATN checksum", "atn_checksum"),
    0x85: _uint("Ack time (ms)", "ack_time_ms", parse_uint16_msbfirst),
    0x86: _ostring("Residual error rate", "residual_error_rate"),
    0x87: _uint("Priority", "priority", parse_uint16_msbfirst),
    0x88: _ostring("Transit delay", "transit_delay"),
    0x89: _ostring("Throughput", "throughput"),
    0x8A: _uint("Subsequence number", "subseq_num", parse_uint16_msbfirst),
    0x8B: _uint("Reassignment time (s)", "reassignment_time_sec",
                parse_uint16_msbfirst),
    0x8C: TlvTypeDescriptor(
        label="Flow control", json_key="flow_control",
        parse=_parse_flow_control, format_text=_fmt_flow_control,
        format_json=_json_flow_control),
    0x8F: _ostring("Selective ACK", "sack"),
    0xC0: _uint("TPDU size (bytes)", "tpdu_size", _parse_tpdu_size),
    0xC1: _ostring("Calling transport selector",
                   "calling_transport_selector"),
    0xC2: _ostring("Called/responding transport selector",
                   "called_responding_transport_selector"),
    0xC3: _ostring("Checksum", "checksum"),
    0xC4: _uint("Version", "version", parse_uint8),
    0xC5: _ostring("Protection params", "protection_params"),
    0xC6: _ostring("Additional options", "additional_options",
                   fmt_single_octet),
    0xC7: _ostring("Additional protocol class(es)",
                   "additional_proto_classes"),
    0xE0: _ostring("Additional info", "additional_info"),
    0xF0: _ostring("Preferred max. TPDU size (bytes)",
                   "preferred_max_tpdu_size"),
    0xF2: _uint("Inactivity timer (ms)", "inactivity_timer_ms",
                parse_uint32_msbfirst),
}

# ER's parameter 0xC1 means something different
ER_VARIABLE_PART_PARAMS = {
    0xC1: _ostring("Invalid TPDU header", "invalid_tpdu_header"),
    0xC3: _ostring("Checksum", "checksum"),
}


@dataclass
class CotpPdu:
    err: bool = True
    code: int = 0
    credit: int = 0
    roa: int = 0
    src_ref: int = 0
    dst_ref: int = 0
    class_or_disc_reason: int = 0
    options: int = 0
    eot: int = 0
    tpdu_seq: int = 0
    extended: bool = False
    x225_transport_disc_reason: int = -1
    variable_part_params: Optional[list] = None
    reasm_status: ReasmStatus = ReasmStatus.UNKNOWN


class CotpConcatenatedNode(ProtoNode):
    json_key = "cotp"

    def __init__(self) -> None:
        super().__init__()
        self.pdu_list: list[CotpPdu] = []

    def format_text(self, out: TextOut, indent: int) -> None:
        for pdu in self.pdu_list:
            _format_pdu_text(out, indent, pdu)

    def format_json(self, obj: JsonObj) -> None:
        obj["pdu_list"] = [_format_pdu_json(pdu) for pdu in self.pdu_list]


def _format_pdu_text(out: TextOut, indent: int, pdu: CotpPdu) -> None:
    if pdu.err:
        out.iline(indent, "-- Unparseable X.224 COTP TPDU")
        return
    name = TPDU_NAMES[pdu.code]
    out.iline(indent, "X.224 COTP %s%s:" % (
        name, " (extended)" if pdu.extended else ""))
    indent += 1
    if pdu.code in (COTP_TPDU_CR, COTP_TPDU_CC, COTP_TPDU_DR, COTP_TPDU_DC):
        out.iline(indent, "src_ref: 0x%04x dst_ref: 0x%04x" % (
            pdu.src_ref, pdu.dst_ref))
    else:
        out.iline(indent, "dst_ref: 0x%04x" % pdu.dst_ref)
    if pdu.code in (COTP_TPDU_CR, COTP_TPDU_CC):
        out.iline(indent, "Initial Credit: %u" % pdu.credit)
        out.iline(indent, "Protocol class: %u" % pdu.class_or_disc_reason)
        out.iline(indent, "Options: %02x (use %s PDU formats)" % (
            pdu.options, "extended" if pdu.options & 2 else "normal"))
    elif pdu.code in (COTP_TPDU_AK, COTP_TPDU_RJ):
        out.iline(indent, "rseq: %u credit: %u" % (pdu.tpdu_seq, pdu.credit))
    elif pdu.code == COTP_TPDU_EA:
        out.iline(indent, "rseq: %u" % pdu.tpdu_seq)
    elif pdu.code == COTP_TPDU_ER:
        out.iline(indent, "Reject cause: %u (%s)" % (
            pdu.class_or_disc_reason,
            ER_REJECT_CAUSES.get(pdu.class_or_disc_reason, "<unknown>")))
    elif pdu.code in (COTP_TPDU_DT, COTP_TPDU_ED):
        out.iline(indent, "sseq: %u req_of_ack: %u EoT: %u" % (
            pdu.tpdu_seq, pdu.roa, pdu.eot))
        out.iline(indent, "COTP reasm status: %s" % pdu.reasm_status.value)
    elif pdu.code == COTP_TPDU_DR:
        out.iline(indent, "Reason: %u (%s)" % (
            pdu.class_or_disc_reason,
            DR_REASONS.get(pdu.class_or_disc_reason, "<unknown>")))
    tlv_list_format_text(out, pdu.variable_part_params, indent)
    if pdu.code == COTP_TPDU_DR and pdu.x225_transport_disc_reason >= 0:
        out.iline(indent, "X.225 disconnect reason: %d (%s)" % (
            pdu.x225_transport_disc_reason,
            X225_DISC_REASONS[pdu.x225_transport_disc_reason]))


def _format_pdu_json(pdu: CotpPdu) -> JsonObj:
    obj = JsonObj(err=pdu.err)
    if pdu.err:
        return obj
    obj["tpdu_code"] = pdu.code
    obj["tpdu_code_descr"] = TPDU_NAMES[pdu.code]
    obj["extended"] = pdu.extended
    if pdu.code in (COTP_TPDU_CR, COTP_TPDU_CC, COTP_TPDU_DR, COTP_TPDU_DC):
        obj["src_ref"] = pdu.src_ref
    obj["dst_ref"] = pdu.dst_ref
    if pdu.code in (COTP_TPDU_CR, COTP_TPDU_CC):
        obj["credit"] = pdu.credit
        obj["proto_class"] = pdu.class_or_disc_reason
        obj["options"] = pdu.options
        obj["use_extended_pdu_formats"] = bool(pdu.options & 2)
    elif pdu.code in (COTP_TPDU_AK, COTP_TPDU_RJ):
        obj["credit"] = pdu.credit
        obj["rseq"] = pdu.tpdu_seq
    elif pdu.code == COTP_TPDU_EA:
        obj["rseq"] = pdu.tpdu_seq
    elif pdu.code == COTP_TPDU_ER:
        obj["reject_code"] = pdu.class_or_disc_reason
        if pdu.class_or_disc_reason in ER_REJECT_CAUSES:
            obj["reject_cause"] = ER_REJECT_CAUSES[pdu.class_or_disc_reason]
    elif pdu.code in (COTP_TPDU_DT, COTP_TPDU_ED):
        obj["sseq"] = pdu.tpdu_seq
        obj["req_of_ack"] = pdu.roa
        obj["eot"] = pdu.eot
        obj["reasm_status"] = pdu.reasm_status.value
    elif pdu.code == COTP_TPDU_DR:
        obj["disc_reason_code"] = pdu.class_or_disc_reason
        if pdu.class_or_disc_reason in DR_REASONS:
            obj["disc_reason"] = DR_REASONS[pdu.class_or_disc_reason]
    obj["variable_part_params"] = tlv_list_format_json(
        pdu.variable_part_params)
    if pdu.code == COTP_TPDU_DR and pdu.x225_transport_disc_reason >= 0:
        obj["x225_spm_transport_disconnect_reason_code"] = \
            pdu.x225_transport_disc_reason
        obj["x225_spm_transport_disconnect_reason"] = \
            X225_DISC_REASONS[pdu.x225_transport_disc_reason]
    return obj


def _u16(buf, i):
    return (buf[i] << 8) | buf[i + 1]


def _u32(buf, i):
    return (buf[i] << 24) | (buf[i + 1] << 16) | (buf[i + 2] << 8) | buf[i + 3]


def _cotp_pdu_parse(buf: bytes, msg_type: int, reasm_ctx, rx_time,
                    src_addr: int, dst_addr: int
                    ) -> tuple[CotpPdu, Optional[ProtoNode], int, int]:
    """Parse one TPDU; returns (pdu, next_node, consumed, msg_type)."""
    pdu = CotpPdu()
    next_node: Optional[ProtoNode] = None
    if len(buf) < 4:
        return pdu, UnknownProtoNode(buf), 0, msg_type
    li = buf[0]
    rest = buf[1:]
    if li in (0, 255) or len(rest) < li:
        return pdu, UnknownProtoNode(buf), 0, msg_type
    code = rest[0]
    if (code & 0xF0) in (COTP_TPDU_CR, COTP_TPDU_CC, COTP_TPDU_AK,
                         COTP_TPDU_RJ):
        pdu.code = code & 0xF0
        pdu.credit = code & 0x0F
    elif (code & 0xF0) == COTP_TPDU_DT:
        pdu.code = code & 0xFE
        pdu.roa = code & 0x1
    else:
        pdu.code = code
    pdu.dst_ref = _u16(rest, 1)

    final_pdu = False
    params_table = VARIABLE_PART_PARAMS
    vpo = 0      # variable part offset
    try:
        if pdu.code in (COTP_TPDU_CR, COTP_TPDU_CC, COTP_TPDU_DR):
            vpo = 6
            if li < vpo:
                raise ValueError
            pdu.src_ref = _u16(rest, 3)
            if pdu.code == COTP_TPDU_DR:
                pdu.class_or_disc_reason = rest[5]
            else:
                pdu.class_or_disc_reason = rest[5] >> 4
                pdu.options = rest[5] & 0xF
            final_pdu = True
        elif pdu.code == COTP_TPDU_ER:
            vpo = 4
            if li < vpo:
                raise ValueError
            pdu.class_or_disc_reason = rest[3]
            params_table = ER_VARIABLE_PART_PARAMS
        elif pdu.code in (COTP_TPDU_DT, COTP_TPDU_ED):
            # odd header length implies extended format (all standard
            # options have even lengths)
            if li & 1:
                vpo = 7
                if li < vpo:
                    raise ValueError
                pdu.eot = (rest[3] & 0x80) >> 7
                pdu.tpdu_seq = _u32(rest, 3) & 0x7FFFFFFF
                pdu.extended = True
            else:
                vpo = 4
                if li < vpo:
                    raise ValueError
                pdu.eot = (rest[3] & 0x80) >> 7
                pdu.tpdu_seq = rest[3] & 0x7F
            final_pdu = True
        elif pdu.code == COTP_TPDU_DC:
            vpo = 5
            if li < vpo:
                raise ValueError
            pdu.src_ref = _u16(rest, 3)
        elif pdu.code in (COTP_TPDU_AK, COTP_TPDU_EA, COTP_TPDU_RJ):
            if li & 1:
                vpo = {COTP_TPDU_AK: 9, COTP_TPDU_EA: 7,
                       COTP_TPDU_RJ: 0}[pdu.code]
                need = vpo if vpo else 9
                if li < need:
                    raise ValueError
                pdu.tpdu_seq = _u32(rest, 3) & 0x7FFFFFFF
                if pdu.code in (COTP_TPDU_AK, COTP_TPDU_RJ):
                    pdu.credit = _u16(rest, 7)
                pdu.extended = True
            else:
                vpo = 4 if pdu.code in (COTP_TPDU_AK, COTP_TPDU_EA) else 0
                if li < (vpo or 4):
                    raise ValueError
                pdu.tpdu_seq = rest[3] & 0x7F
        else:
            raise ValueError
    except (ValueError, IndexError):
        return pdu, UnknownProtoNode(buf), 0, msg_type

    if vpo > 0 and li > vpo:
        pdu.variable_part_params = tlv_parse(rest[vpo:li], params_table, 1)
        if pdu.variable_part_params is None:
            return pdu, UnknownProtoNode(buf), 0, msg_type

    consumed = 1 + li
    if final_pdu:
        payload = bytes(rest[li:])
        consumed = len(buf)
        if payload:
            if pdu.code == COTP_TPDU_DR and len(payload) == 1:
                # single-octet DR user data = X.225 SPM disconnect reason
                if payload[0] < len(X225_DISC_REASONS):
                    pdu.x225_transport_disc_reason = payload[0]
                else:
                    next_node = UnknownProtoNode(payload)
            else:
                decode_payload = True
                if pdu.code in (COTP_TPDU_DT, COTP_TPDU_ED) \
                        and reasm_ctx is not None:
                    table = reasm_ctx.seq_table("cotp")
                    key = (src_addr, dst_addr, pdu.dst_ref)
                    pdu.reasm_status = table.add_fragment(
                        key, payload, seq_num=pdu.tpdu_seq,
                        is_final=pdu.eot != 0, rx_time=rx_time,
                        timeout=COTP_REASM_TIMEOUT,
                        seq_num_wrap=0x7FFFFFFF if pdu.extended else 0x7F)
                    if pdu.reasm_status is ReasmStatus.COMPLETE:
                        joined = table.payload_get(key)
                        if joined:
                            payload = joined
                    elif pdu.reasm_status in (ReasmStatus.IN_PROGRESS,
                                              ReasmStatus.DUPLICATE) \
                            and not Config.decode_fragments:
                        decode_payload = False
                if decode_payload:
                    global _icao_parse
                    if _icao_parse is None:
                        from .icao import icao_apdu_parse
                        _icao_parse = icao_apdu_parse
                    next_node, msg_type = _icao_parse(payload, msg_type)
                else:
                    next_node = UnknownProtoNode(payload)
    pdu.err = False
    return pdu, next_node, consumed, msg_type


def cotp_concatenated_pdu_parse(buf: bytes, msg_type: int, reasm_ctx,
                                rx_time, src_addr: int, dst_addr: int
                                ) -> Tuple[ProtoNode, int]:
    node = CotpConcatenatedNode()
    pos = 0
    while pos < len(buf):
        pdu, next_node, consumed, msg_type = _cotp_pdu_parse(
            buf[pos:], msg_type, reasm_ctx, rx_time, src_addr, dst_addr)
        node.pdu_list.append(pdu)
        if next_node is not None:
            node.next = next_node
        if pdu.err:
            break
        pos += consumed
    return node, msg_type
