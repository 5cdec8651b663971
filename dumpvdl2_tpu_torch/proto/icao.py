"""ICAO ULCS: X.225 session, X.226 presentation, X.227 ACSE, and the
CM / CPDLC / ADS-C v2 applications (ASN.1 UPER).

Re-implements the reference's application layer (icao.c:626-658
icao_apdu_parse; :522-576 x225_spdu_parse; :374-453 ulcs_acse_parse;
:456-500 fully_encoded_data_parse; :281-368 arbitrary_payload_parse;
:63-279 two-pass protected/ADS PDU decode) on top of the schema-driven
UPER codec in proto/asn1/.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from ..config import MsgFilter
from .asn1.format import IcaoFormatter
from .asn1.runtime import BitReader, UperDecodeError, decode
from .asn1.tables_icao import SCHEMA
from .base import JsonObj, ProtoNode, TextOut, UnknownProtoNode

# AE-qualifier application type codes (Doc 9705; icao.h:30-33)
APP_TYPE_ADS = 0
APP_TYPE_CMA = 1
APP_TYPE_CPC = 22
APP_TYPE_UNKNOWN = -1

# X.225 short-form SPDU identifiers (icao.c:507-512)
X225_SPDU_NAMES = {
    0xE8: "Short Connect",
    0xF0: "Short Accept",
    0xD8: "Short Accept Continue",
    0xE0: "Short Refuse",
    0xA0: "Short Refuse Continue",
}
X225_SPDU_SRF = 0xE0

# Presentation-context-identifier values (ULCS)
PCI_ACSE_APDU = 1
PCI_USER_ASE_APDU = 3


def _uper(typename: str, buf: bytes) -> Any:
    """uper_decode_complete equivalent: all input bytes must be
    consumed (bar padding bits)."""
    rd = BitReader(bytes(buf))
    value = decode(SCHEMA, typename, rd)
    # asn1c's uper_decode_complete tolerates trailing padding within
    # the last octet but not whole unconsumed octets
    if rd.remaining() >= 8:
        raise UperDecodeError(
            f"{typename}: {rd.remaining()} unconsumed bits")
    return value


class Asn1PduNode(ProtoNode):
    """A decoded ASN.1 PDU rendered via the formatter tables
    (asn1-util.h:28-35 asn1_pdu_t equivalent)."""

    def __init__(self, json_key: str, typename: str, value: Any,
                 table: str = "icao") -> None:
        super().__init__()
        self.json_key = json_key
        self.typename = typename
        self.value = value
        self.table = table

    def format_text(self, out: TextOut, indent: int) -> None:
        from ..config import Config
        if Config.dump_asn1:
            # --dump-asn1: raw decoded-structure dump in normal output,
            # the asn_fprint path of the reference (asn1-util.c:63-69).
            out.iline(indent, f"ASN.1 dump ({self.typename}):")
            self._dump(out, self.value, indent + 1)
        IcaoFormatter(SCHEMA, self.table).text(out, self.typename,
                                               self.value, indent)

    def _dump(self, out: TextOut, value: Any, indent: int,
              label: str = "") -> None:
        prefix = f"{label}: " if label else ""
        if isinstance(value, dict):
            out.iline(indent, prefix + "{")
            for k, v in value.items():
                self._dump(out, v, indent + 1, str(k))
            out.iline(indent, "}")
        elif isinstance(value, tuple) and len(value) == 2 \
                and isinstance(value[0], str):
            out.iline(indent, prefix + f"CHOICE {value[0]}")
            self._dump(out, value[1], indent + 1)
        elif isinstance(value, list):
            out.iline(indent, prefix + f"SEQUENCE OF ({len(value)})")
            for v in value:
                self._dump(out, v, indent + 1)
        elif isinstance(value, (bytes, bytearray)):
            out.iline(indent, prefix + value.hex())
        elif value is None:
            out.iline(indent, prefix + "NULL")
        else:
            out.iline(indent, prefix + repr(value))

    def format_json(self, obj: JsonObj) -> None:
        # table label of the top type becomes the key (e.g.
        # "atc_uplink_message"), mirroring la_asn1_output on the top
        # descriptor (asn1-util.c:71-77)
        obj.update(IcaoFormatter(SCHEMA, self.table).json(
            self.typename, self.value))


class X225SpduNode(ProtoNode):
    json_key = "x225_spdu"

    def __init__(self, spdu_id: int, special: int) -> None:
        super().__init__()
        self.spdu_id = spdu_id
        self.special = special

    def format_text(self, out: TextOut, indent: int) -> None:
        name = X225_SPDU_NAMES.get(self.spdu_id)
        if name is not None:
            out.iline(indent, f"X.225 Session SPDU: {name}")
        else:
            out.iline(indent,
                      f"X.225 Session SPDU: unknown type "
                      f"(0x{self.spdu_id:02x})")
        if self.spdu_id == X225_SPDU_SRF:
            out.iline(indent + 1, "Refusal: %s" % (
                "persistent" if self.special & 1 else "transient"))
            out.iline(indent + 1, "Transport connection: %s" % (
                "release" if self.special & 2 else "retain"))

    def format_json(self, obj: JsonObj) -> None:
        obj["spdu_id"] = self.spdu_id
        name = X225_SPDU_NAMES.get(self.spdu_id)
        if name is not None:
            obj["spdu_type"] = name
        if self.spdu_id == X225_SPDU_SRF:
            obj["refusal"] = ("persistent" if self.special & 1
                              else "transient")
            obj["transport_connection"] = ("release" if self.special & 2
                                           else "retain")


# --------------------------------------------------- application decode

def _decode_protected_downlink(acse_type: Optional[str], buf: bytes
                               ) -> Optional[Tuple[str, Any]]:
    """icao.c:179-229 decode_protected_ATCDownlinkMessage."""
    pdu = _uper("ProtectedAircraftPDUs", buf)
    alt, inner = pdu
    if alt in ("startdown", "send"):
        pmsg = (inner["startDownlinkMessage"] if alt == "startdown"
                else inner)
        protected = pmsg.get("protectedMessage")
        if protected is None:
            return ("ATCDownlinkMessage", None)
        data = protected[0] if isinstance(protected, tuple) else protected
        return ("ATCDownlinkMessage", _uper("ATCDownlinkMessage", data))
    if alt in ("abortUser", "abortProvider"):
        if acse_type in (None, "abrt"):
            return ("ProtectedAircraftPDUs", pdu)
    raise UperDecodeError("not a protected downlink")


def _decode_protected_uplink(acse_type: Optional[str], buf: bytes
                             ) -> Optional[Tuple[str, Any]]:
    """icao.c:233-279 decode_protected_ATCUplinkMessage."""
    pdu = _uper("ProtectedGroundPDUs", buf)
    alt, inner = pdu
    if alt in ("startup", "send"):
        pmsg = inner
        protected = pmsg.get("protectedMessage")
        if protected is None:
            return ("ATCUplinkMessage", None)
        data = protected[0] if isinstance(protected, tuple) else protected
        return ("ATCUplinkMessage", _uper("ATCUplinkMessage", data))
    if alt in ("abortUser", "abortProvider"):
        if acse_type in (None, "abrt"):
            return ("ProtectedGroundPDUs", pdu)
    raise UperDecodeError("not a protected uplink")


# ADS PDU alternatives needing a second decode pass:
# alt name -> (inner container member, ic member, message member, type)
_ADS_AIR_TWO_PASS = {
    "aDS-report-PDU": ("ic-report", "ADSReport"),
    "aDS-accepted-PDU": ("ic-report", "ADSAccept"),
    "aDS-rejected-PDU": ("ic-reject", "ADSReject"),
    "aDS-ncn-PDU": ("ic-ncn", "ADSNonCompliance"),
    "aDS-positive-acknowledgement-PDU": ("ic-positive-ack",
                                         "ADSPositiveAcknowledgement"),
}
_ADS_GND_TWO_PASS = {
    "aDS-contract-PDU": ("ic-contract-request", "ADSRequestContract"),
}


def _find_ads_message(value: Any):
    """Locate the nested ADSMessage BIT STRING in an ic-* container."""
    if isinstance(value, dict):
        for k, v in value.items():
            if k in ("aDSMessage", "aDSPositiveAck"):
                return v
            got = _find_ads_message(v)
            if got is not None:
                return got
    elif isinstance(value, tuple) and len(value) == 2 and \
            isinstance(value[0], str):
        return _find_ads_message(value[1])
    return None


def _decode_ads(container: str, table, buf: bytes) -> Tuple[str, Any]:
    """icao.c:63-177 decode_ADSAircraftPDUs / decode_ADSGroundPDUs."""
    pdus = _uper(container, buf)
    inner_key = "adsAircraftPdu" if container == "ADSAircraftPDUs" \
        else "adsGroundPdu"
    alt, inner = pdus[inner_key]
    hit = table.get(alt)
    if hit is None:
        # single-layer PDU (aborts, cancels): fully decoded already
        return (container, pdus)
    _ic_member, next_type = hit
    msg = _find_ads_message(inner)
    if msg is None:
        raise UperDecodeError("no nested ADSMessage")
    # ADSMessage is a BIT STRING whose content is the PER encoding
    data, nbits = msg if isinstance(msg, tuple) else (msg, len(msg) * 8)
    return (next_type, _uper(next_type, data))


def arbitrary_payload_parse(app_type: int, acse_type: Optional[str],
                            buf: bytes, msg_type: int
                            ) -> Tuple[Optional[ProtoNode], int]:
    """icao.c:281-368: try CPDLC, CM, ADS-C in turn, gated on the
    AE-qualifier when known and on message direction."""
    def matches(t):
        return app_type in (t, APP_TYPE_UNKNOWN)

    from_air = bool(msg_type & MsgFilter.SRC_AIR)
    attempts = []
    if from_air:
        if matches(APP_TYPE_CPC):
            attempts.append(("cpdlc", MsgFilter.CPDLC,
                             lambda: _decode_protected_downlink(
                                 acse_type, buf)))
        if matches(APP_TYPE_CMA):
            attempts.append(("context_mgmt", MsgFilter.CM,
                             lambda: ("CMAircraftMessage",
                                      _uper("CMAircraftMessage", buf))))
        if matches(APP_TYPE_ADS):
            attempts.append(("adsc_v2", MsgFilter.ADSC,
                             lambda: _decode_ads("ADSAircraftPDUs",
                                                 _ADS_AIR_TWO_PASS, buf)))
    else:
        if matches(APP_TYPE_CPC):
            attempts.append(("cpdlc", MsgFilter.CPDLC,
                             lambda: _decode_protected_uplink(
                                 acse_type, buf)))
        if matches(APP_TYPE_CMA):
            attempts.append(("context_mgmt", MsgFilter.CM,
                             lambda: ("CMGroundMessage",
                                      _uper("CMGroundMessage", buf))))
        if matches(APP_TYPE_ADS):
            attempts.append(("adsc_v2", MsgFilter.ADSC,
                             lambda: _decode_ads("ADSGroundPDUs",
                                                 _ADS_GND_TWO_PASS, buf)))
    for json_key, flag, attempt in attempts:
        try:
            typename, value = attempt()
        except (UperDecodeError, KeyError, TypeError, ValueError):
            continue
        if value is None:       # NULL protectedMessage is valid
            continue
        return Asn1PduNode(json_key, typename, value), msg_type | flag
    return None, msg_type


def ulcs_acse_parse(buf: bytes, msg_type: int
                    ) -> Tuple[Optional[ProtoNode], int]:
    """icao.c:374-453: X.227 ACSE APDU + nested user-information."""
    try:
        apdu = _uper("ACSE_apdu", buf)
    except (UperDecodeError, ValueError, KeyError):
        return None, msg_type
    alt, inner = apdu
    ae_qualifier = APP_TYPE_UNKNOWN
    if alt == "aarq":
        q = inner.get("calling-AE-qualifier")
        if isinstance(q, tuple) and q[0] == "ae-qualifier-form2":
            ae_qualifier = q[1]
    node = Asn1PduNode("x227_apdu", "ACSE_apdu", apdu, table="acse")
    user_info = inner.get("user-information") if isinstance(inner, dict) \
        else None
    if not user_info:
        return node, msg_type
    try:
        enc = user_info["data"]["encoding"]
    except (KeyError, TypeError):
        return node, msg_type
    if not (isinstance(enc, tuple) and enc[0] == "arbitrary"):
        return node, msg_type
    data, _nbits = enc[1]
    next_node, msg_type = arbitrary_payload_parse(
        ae_qualifier, alt, data, msg_type)
    node.next = next_node if next_node is not None \
        else UnknownProtoNode(data)
    return node, msg_type


def fully_encoded_data_parse(buf: bytes, msg_type: int
                             ) -> Tuple[Optional[ProtoNode], int]:
    """icao.c:456-500: X.226 null-encoding Fully-encoded-data."""
    try:
        fed = _uper("Fully_encoded_data", buf)
    except (UperDecodeError, ValueError, KeyError):
        return None, msg_type
    try:
        data = fed["data"]
        pdv = data["presentation-data-values"]
        pci = data["presentation-context-identifier"]
    except (KeyError, TypeError):
        return None, msg_type
    if not (isinstance(pdv, tuple) and pdv[0] == "arbitrary"):
        return None, msg_type
    payload, _nbits = pdv[1]
    if pci == PCI_ACSE_APDU or pci == "acse-apdu":
        return ulcs_acse_parse(payload, msg_type)
    if pci == PCI_USER_ASE_APDU or pci == "user-ase-apdu":
        return arbitrary_payload_parse(APP_TYPE_UNKNOWN, None,
                                       payload, msg_type)
    return None, msg_type


def x225_spdu_parse(buf: bytes, msg_type: int
                    ) -> Tuple[Optional[ProtoNode], int]:
    """icao.c:522-576: X.225 Amdt 1 short-form SPDU + X.226 PPCI."""
    spdu_id = buf[0] & 0xF8
    if spdu_id not in X225_SPDU_NAMES:
        return None, msg_type
    if buf[0] & 4:          # p-bit must be 0 (Doc 9880 2.4.5.2.2)
        return None, msg_type
    node = X225SpduNode(spdu_id, buf[0] & 0x3)
    rest = buf[1:]
    if not rest:
        return node, msg_type
    # X.226 Amdt 1 PPCI octet: low 2 bits == 2 -> ASN.1 UPER
    if (rest[0] & 3) != 2:
        return None, msg_type
    rest = rest[1:]
    if not rest:
        return node, msg_type
    next_node, msg_type = ulcs_acse_parse(rest, msg_type)
    node.next = next_node if next_node is not None \
        else UnknownProtoNode(rest)
    return node, msg_type


def icao_apdu_parse(buf: bytes, msg_type: int
                    ) -> Tuple[ProtoNode, int]:
    """icao.c:626-658: top-level application payload dispatch."""
    if len(buf) < 1:
        return UnknownProtoNode(buf), msg_type
    if buf[0] & 0x80:
        node, msg_type = x225_spdu_parse(buf, msg_type)
    else:
        # NULL session+presentation encoding: Fully-encoded-data first,
        # bare ACSE as a fallback (e.g. CPDLC aborts in COTP DR TPDUs)
        node, msg_type = fully_encoded_data_parse(buf, msg_type)
        if node is None:
            node, msg_type = ulcs_acse_parse(buf, msg_type)
    if node is None:
        return UnknownProtoNode(buf), msg_type
    return node, msg_type
