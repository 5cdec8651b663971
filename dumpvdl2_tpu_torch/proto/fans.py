"""FANS-1/A CPDLC message decode + rendering (ARINC 622 IMI AT1).

The reference renders these through libacars' cpdlc.c + the DO-219
ASN.1 module; here the schema-driven UPER runtime decodes against the
hand-written FANS tables (proto/asn1/tables_fans.py) and this module
renders the element tree with the published phraseology.  Arguments
whose types are not modelled yet surface as hex bits — see the honesty
note in tables_fans.py.
"""
from __future__ import annotations

from typing import Any, Optional

from .asn1.runtime import BitReader, UperDecodeError, decode
from .asn1.tables_fans import DOWNLINK_MSGS, SCHEMA, UPLINK_MSGS
from .base import JsonObj, ProtoNode, TextOut, hex_str


# CHOICE-alternative display scaling: alt name -> (scale, unit, decimals)
# (same role as the reference's la_format_INTEGER_with_unit_as_text call
# sites for the ICAO tables, asn1-format-icao-text.c).
_UNITS = {
    "altitudeQNH": (10, " ft QNH", 0),
    "altitudeQNHMeters": (1, " m QNH", 0),
    "altitudeQFE": (10, " ft QFE", 0),
    "altitudeQFEMeters": (1, " m QFE", 0),
    "altitudeGNSSFeet": (1, " ft GNSS", 0),
    "altitudeGNSSMeters": (1, " m GNSS", 0),
    "altitudeFlightLevelMetric": (10, " m (metric FL)", 0),
    "speedIndicated": (10, " kts IAS", 0),
    "speedIndicatedMetric": (10, " km/h IAS", 0),
    "speedTrue": (10, " kts TAS", 0),
    "speedTrueMetric": (10, " km/h TAS", 0),
    "speedGround": (10, " kts GS", 0),
    "speedGroundMetric": (10, " km/h GS", 0),
    "speedMach": (0.001, " Mach", 3),
    "frequencyhf": (1, " kHz", 0),
    "frequencyvhf": (0.005, " MHz", 3),
    "frequencyuhf": (0.025, " MHz", 3),
    "distanceNm": (0.1, " nm", 1),
    "distanceKm": (1, " km", 0),
    "distanceOffsetNm": (0.1, " nm", 1),
    "distanceOffsetKm": (1, " km", 0),
    "altimeterEnglish": (0.01, " inHg", 2),
    "altimeterMetric": (0.1, " hPa", 1),
    "verticalRateEnglish": (10, " ft/min", 0),
    "verticalRateMetric": (10, " m/min", 0),
    "legDistanceEnglish": (0.1, " nm", 1),
    "legDistanceMetric": (1, " km", 0),
    "legTime": (1, " min", 0),
    "degreesMagnetic": (1, " deg magnetic", 0),
    "degreesTrue": (1, " deg true", 0),
    "windSpeedEnglish": (1, " kts", 0),
    "windSpeedMetric": (1, " km/h", 0),
}

# CHOICE alternatives whose integer scaling/bounds are this
# framework's documented PROFILE, not second-source-confirmed DO-219
# constraints (tables_fans.py "Second-source audit status"): a wrong
# UPER bound changes bit width and would misdecode real traffic
# silently, so rendered values carry an explicit marker — text gets a
# "[profiled scale]" suffix, JSON a "profiled": true — letting
# operators distinguish confirmed decodes from profiled ones.
_PROFILED = {"speedTrue", "speedTrueMetric", "speedGround",
             "speedGroundMetric"}
_PROFILED_MARK = " [profiled scale]"

# Field-name display labels for composite argument SEQUENCEs.
_FIELD_LABELS = {
    "timeAtPositionCurrent": "at time",
    "positionCurrent": "position",
    "timeEtaAtFixNext": "ETA",
    "timeEtaAtDestination": "destination ETA",
    "routeInformationAdditional": "additional info",
    "aircraftFlightIdentification": "flight id",
}


def _latlon_text(value: dict) -> str:
    marked = False

    def one(deg_key, dct):
        nonlocal marked
        deg = dct[deg_key]
        direction = [v for k, v in dct.items() if k.endswith("Direction")]
        s = f"{deg}"
        if "minutesLatLon" in dct:
            # 0.01-minute units is profiled, not audited (tables_fans)
            s += f" {dct['minutesLatLon'] / 100.0:.2f}'"
            marked = True
        if direction:
            s += direction[0][0].upper()
        return s
    s = (one("latitudeDegrees", value["latitude"]) + " "
         + one("longitudeDegrees", value["longitude"]))
    return s + _PROFILED_MARK if marked else s


def _fmt_arg(name: str, value: Any) -> tuple[str, Any]:
    """Render one decoded element argument for text/JSON output."""
    if value is None:
        return "", None
    if isinstance(value, dict):
        if set(value) >= {"hours", "minutes"}:     # FANSTime(stamp)
            s = f"{value['hours']:02d}:{value['minutes']:02d}"
            if "seconds" in value:
                s += f":{value['seconds']:02d}"
            return s, s
        if "latitude" in value and "longitude" in value:
            s = _latlon_text(value)
            js = {k: _fmt_arg(k, v)[1] for k, v in value.items()}
            if "minutesLatLon" in value["latitude"] \
                    or "minutesLatLon" in value["longitude"]:
                js["profiled"] = True
            return s, js
        if "latitudeDegrees" in value or "longitudeDegrees" in value:
            parts = []
            js = {}
            for k, v in value.items():
                txt, j = _fmt_arg(k, v)
                parts.append(txt)
                js[k] = j
            return " ".join(parts), js
        # generic composite argument: "field: value" pairs
        parts = []
        js = {}
        for k, v in value.items():
            txt, j = _fmt_arg(k, v)
            label = _FIELD_LABELS.get(k, k)
            parts.append(f"{label}: {txt}" if txt else label)
            js[k] = j
        return ", ".join(parts), js
    if isinstance(value, list):
        if value and all(isinstance(d, int) and 0 <= d <= 7
                         for d in value) and name.endswith(
                             ("uM123", "dM47")):  # beacon code digits
            s = "".join(str(d) for d in value)
            return s, s
        if value and all(isinstance(d, int) for d in value) \
                and len(value) == 4 and max(value) <= 7:
            s = "".join(str(d) for d in value)
            return s, s
        rendered = [_fmt_arg(name, v) for v in value]
        return (" / ".join(t for t, _ in rendered),
                [j for _, j in rendered])
    if isinstance(value, tuple):
        if len(value) == 2 and isinstance(value[0], (bytes, bytearray)) \
                and isinstance(value[1], int):   # unparsed bits
            return (f"(unparsed args: {hex_str(value[0])} "
                    f"[{value[1]} bits])",
                    {"unparsed_bits": hex_str(value[0]),
                     "nbits": value[1]})
        alt, sub = value                  # CHOICE
        if alt == "altitudeFlightLevel":
            return f"FL{sub}", {alt: sub}
        unit = _UNITS.get(alt)
        if unit is not None and isinstance(sub, int):
            scale, suffix, dec = unit
            v = sub * scale
            s = f"{v:.{dec}f}{suffix}" if dec else f"{int(v)}{suffix}"
            if alt in _PROFILED:
                return s + _PROFILED_MARK, {alt: sub, "profiled": True}
            return s, {alt: sub}
        txt, js = _fmt_arg(name, sub)
        return f"{txt} ({alt})", {alt: js}
    return str(value), value


class CpdlcFansNode(ProtoNode):
    """One decoded (or decode-failed) FANS-1/A CPDLC message."""
    json_key = "cpdlc_fans"

    def __init__(self, uplink: bool, msg: Optional[dict],
                 raw: bytes, error: str = "") -> None:
        super().__init__()
        self.uplink = uplink
        self.msg = msg
        self.raw = raw
        self.error = error

    # ------------------------------------------------------------ text
    def format_text(self, out: TextOut, indent: int) -> None:
        direction = "uplink" if self.uplink else "downlink"
        out.iline(indent, f"FANS-1/A CPDLC {direction} message:")
        indent += 1
        if self.msg is None:
            out.iline(indent, f"-- decode failed: {self.error}")
            out.iline(indent, f"Data: {hex_str(self.raw)}")
            return
        hdr = self.msg.get("header", {})
        out.iline(indent, f"Msg ID: {hdr.get('msgIdentificationNumber')}")
        if "msgReferenceNumber" in hdr:
            out.iline(indent, f"Msg Ref: {hdr['msgReferenceNumber']}")
        if "timestamp" in hdr:
            t = hdr["timestamp"]
            out.iline(indent, "Timestamp: %02d:%02d:%02d" % (
                t["hours"], t["minutes"], t["seconds"]))
        table = UPLINK_MSGS if self.uplink else DOWNLINK_MSGS
        prefix = "uM" if self.uplink else "dM"
        out.iline(indent, "Message data:")
        for alt, val in self.msg.get("messageData", []):
            num = int(alt[len(prefix):])
            title = table.get(num, ("(unknown)", None))[0]
            out.iline(indent + 1, f"{prefix[0].upper()}M{num}: {title}")
            txt, _ = _fmt_arg(alt, val)
            if txt:
                out.iline(indent + 2, txt)

    # ------------------------------------------------------------ json
    def format_json(self, obj: JsonObj) -> None:
        obj["dir"] = "uplink" if self.uplink else "downlink"
        if self.msg is None:
            obj["err"] = self.error
            obj["data"] = hex_str(self.raw)
            return
        hdr = self.msg.get("header", {})
        obj["msg_id"] = hdr.get("msgIdentificationNumber")
        if "msgReferenceNumber" in hdr:
            obj["msg_ref"] = hdr["msgReferenceNumber"]
        if "timestamp" in hdr:
            t = hdr["timestamp"]
            obj["timestamp"] = "%02d:%02d:%02d" % (
                t["hours"], t["minutes"], t["seconds"])
        table = UPLINK_MSGS if self.uplink else DOWNLINK_MSGS
        prefix = "uM" if self.uplink else "dM"
        elements = []
        for alt, val in self.msg.get("messageData", []):
            num = int(alt[len(prefix):])
            el = JsonObj(num=num, title=table.get(num, ("(unknown)",))[0])
            _, js = _fmt_arg(alt, val)
            if js is not None:
                el["arg"] = js
            elements.append(el)
        obj["elements"] = elements


def cpdlc_fans_parse(data: bytes, uplink: bool) -> CpdlcFansNode:
    """Decode an AT1 payload (UPER FANSATC{Up,Down}linkMessage)."""
    ref = "FANSATCUplinkMessage" if uplink else "FANSATCDownlinkMessage"
    try:
        msg = decode(SCHEMA, ref, BitReader(data))
    except (UperDecodeError, KeyError, ValueError) as e:
        return CpdlcFansNode(uplink, None, data, error=str(e))
    return CpdlcFansNode(uplink, msg, data)
