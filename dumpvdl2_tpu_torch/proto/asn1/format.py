"""Table-driven text/JSON rendering of decoded ICAO ASN.1 values.

Re-implements the reference's formatter-table architecture
(asn1-format-icao-text.c:1044-1537, asn1-format-icao-json.c, plus the
libacars asn1-format-common generics it builds on): every ASN.1 type
has a rendering style and display label; SEQUENCE/CHOICE/SET OF walk
their children through the same dispatch; CPDLC message-element CHOICEs
print ICAO Doc 9880 phraseology; physical quantities print with their
unit and scale factor.  JSON output uses the reference's own
snake_case table labels as keys (JSON_FMT/ACSE_JSON_FMT), so field
names match what consumers of the reference's JSON already parse.

The dispatch metadata lives in icao_meta.py (machine-extracted); the
engine below is original.
"""
from __future__ import annotations

from typing import Any, Optional

from .icao_meta import (ACSE_JSON_FMT, ACSE_TEXT_FMT, DOWNLINK_LABELS,
                        ENUM_LABEL_DICTS, JSON_FMT, TEXT_FMT, UPLINK_LABELS)
from .ir import Schema

# ---------------------------------------------------------------- units
# fn-name -> (unit suffix, multiplier, decimals); ports of the
# la_format_INTEGER_with_unit_as_text call sites in
# asn1-format-icao-text.c
UNIT_FMT = {
    "asn1_format_AltimeterEnglish_as_text": (" inHg", 0.01, 2),
    "asn1_format_AltimeterMetric_as_text": (" hPa", 0.1, 1),
    "asn1_format_Deg_as_text": (" deg", 1, 0),
    "asn1_format_DepartureMinimumInterval_as_text": (" min", 0.1, 1),
    "asn1_format_DistanceKm_as_text": (" km", 0.25, 2),
    "asn1_format_DistanceNm_as_text": (" nm", 0.1, 1),
    "asn1_format_Humidity_as_text": ("%", 1, 0),
    "asn1_format_DistanceEnglish_as_text": (" nm", 1, 0),
    "asn1_format_DistanceMetric_as_text": (" km", 1, 0),
    "asn1_format_Frequencyvhf_as_text": (" MHz", 0.005, 3),
    "asn1_format_Frequencyuhf_as_text": (" MHz", 0.025, 3),
    "asn1_format_Frequencyhf_as_text": (" kHz", 1, 0),
    "asn1_format_LegTime_as_text": (" min", 1, 0),
    "asn1_format_LevelFeet_as_text": (" ft", 10, 0),
    "asn1_format_LevelFlightLevelMetric_as_text": (" m", 10, 0),
    "asn1_format_Meters_as_text": (" m", 1, 0),
    "asn1_format_RTASecTolerance_as_text": (" sec", 1, 0),
    "asn1_format_RTATolerance_as_text": (" min", 0.1, 1),
    "asn1_format_Feet_as_text": (" ft", 1, 0),
    "asn1_format_SpeedMetric_as_text": (" km/h", 1, 0),
    "asn1_format_SpeedEnglish_as_text": (" kts", 1, 0),
    "asn1_format_SpeedIndicated_as_text": (" kts", 1, 0),
    "asn1_format_SpeedMach_as_text": ("", 0.001, 3),
    "asn1_format_Temperature_as_text": (" C", 1, 0),
    "asn1_format_VerticalRateEnglish_as_text": (" ft/min", 10, 0),
    "asn1_format_VerticalRateMetric_as_text": (" m/min", 10, 0),
    "asn1_format_ADSv2Temperature_as_text": (" C", 0.25, 2),
    "asn1_format_ADSv2WindSpeedKts_as_text": (" kts", 1, 0),
    "asn1_format_ADSv2WindSpeedKmh_as_text": (" km/h", 2, 0),
    "asn1_format_EPPTimeInterval_as_text": (" minutes", 1, 0),
    "asn1_format_EPPTolETA_as_text": (" min", 0.1, 1),
    "asn1_format_EPPTolGCDistance_as_text": (" nm", 0.01, 2),
    "asn1_format_EPUChangeTolerance_as_text": (" nm", 0.01, 2),
    "asn1_format_GroundSpeed_as_text": (" kts", 0.5, 1),
    "asn1_format_GroundTrack_as_text": (" deg", 0.05, 2),
    "asn1_format_LateralDeviationThreshold_as_text": (" nm", 0.1, 1),
    "asn1_format_MachNumberTolerance_as_text": ("", 0.01, 2),
    "asn1_format_GrossMass_as_text": (" kg", 10, 0),
    "asn1_format_TurbulenceEDRValue_as_text": (" m^2/s^3", 0.01, 2),
    "asn1_format_TurbulenceMinutesInThePast_as_text": (" min", 0.5, 1),
    "asn1_format_TurbulenceObservationWindow_as_text": (" min", 1, 0),
    "asn1_format_TurnRadius_as_text": (" nm", 0.1, 1),
    "asn1_format_RNPValue_as_text": (" nm", 0.1, 1),
    "asn1_format_Modulus_as_text": None,   # handled specially
}

BIT_LABEL_FN = {
    "asn1_format_VerticalType_as_text": "VerticalType_bit_labels",
    "asn1_format_ReportTypeNotSupported_as_text":
        "ReportTypeNotSupported_bit_labels",
    "asn1_format_EventTypeNotSupported_as_text":
        "EventTypeNotSupported_bit_labels",
    "asn1_format_EPPLimitations_as_text": "EPPLimitations_bit_labels",
    "asn1_format_EmergencyUrgencyStatus_as_text":
        "EmergencyUrgencyStatus_bit_labels",
}

ENUM_DICT_FN = {
    "asn1_format_Associate_result_as_text": "Associate_result_labels",
    "asn1_format_Release_request_reason_as_text":
        "Release_request_reason_labels",
    "asn1_format_Release_response_reason_as_text":
        "Release_response_reason_labels",
    "asn1_format_ABRT_source_as_text": "ABRT_source_labels",
}

# JSON rendering as a dict (serialized by io/formatters.py)
JsonObj = dict

# fn-name -> (unit string, multiplier); mechanical extraction of the
# la_format_INTEGER_with_unit_as_json call sites in
# asn1-format-icao-json.c (pinned 1:1 by tests/test_layout_oracle.py)
UNIT_FMT_JSON = {
    "asn1_format_AltimeterEnglish_as_json": ("inHg", 0.01),
    "asn1_format_AltimeterMetric_as_json": ("hPa", 0.1),
    "asn1_format_Deg_as_json": ("deg", 1),
    "asn1_format_DepartureMinimumInterval_as_json": ("min", 0.1),
    "asn1_format_DistanceKm_as_json": ("km", 0.25),
    "asn1_format_DistanceNm_as_json": ("nm", 0.1),
    "asn1_format_Humidity_as_json": ("%", 1),
    "asn1_format_DistanceEnglish_as_json": ("nm", 1),
    "asn1_format_DistanceMetric_as_json": ("km", 1),
    "asn1_format_Frequencyvhf_as_json": ("MHz", 0.005),
    "asn1_format_Frequencyuhf_as_json": ("MHz", 0.025),
    "asn1_format_Frequencyhf_as_json": ("kHz", 1),
    "asn1_format_LegTime_as_json": ("min", 1),
    "asn1_format_LevelFeet_as_json": ("ft", 10),
    "asn1_format_LevelFlightLevelMetric_as_json": ("m", 10),
    "asn1_format_Meters_as_json": ("m", 1),
    "asn1_format_RTASecTolerance_as_json": ("sec", 1),
    "asn1_format_RTATolerance_as_json": ("min", 0.1),
    "asn1_format_Feet_as_json": ("ft", 1),
    "asn1_format_SpeedMetric_as_json": ("km/h", 1),
    "asn1_format_SpeedEnglish_as_json": ("kts", 1),
    "asn1_format_SpeedIndicated_as_json": ("kts", 1),
    "asn1_format_SpeedMach_as_json": ("", 0.001),
    "asn1_format_Temperature_as_json": ("C", 1),
    "asn1_format_VerticalRateEnglish_as_json": ("ft/min", 10),
    "asn1_format_VerticalRateMetric_as_json": ("m/min", 10),
    "asn1_format_EstimatedPositionUncertainty_as_json": ("nm", 0.01),
    "asn1_format_ADSv2Temperature_as_json": ("C", 0.25),
    "asn1_format_ADSv2WindSpeedKts_as_json": ("kts", 1),
    "asn1_format_ADSv2WindSpeedKmh_as_json": ("km/h", 2),
    "asn1_format_EPPTimeInterval_as_json": ("minutes", 1),
    "asn1_format_GrossMass_as_json": ("kg", 10),
    "asn1_format_EPPTolETA_as_json": ("min", 0.1),
    "asn1_format_EPPTolGCDistance_as_json": ("nm", 0.01),
    "asn1_format_EPUChangeTolerance_as_json": ("nm", 0.01),
    "asn1_format_GroundSpeed_as_json": ("kts", 0.5),
    "asn1_format_GroundTrack_as_json": ("deg", 0.05),
    "asn1_format_LateralDeviationThreshold_as_json": ("nm", 0.1),
    "asn1_format_MachNumberTolerance_as_json": ("", 0.01),
    "asn1_format_RNPValue_as_json": ("nm", 0.1),
    "asn1_format_TurbulenceEDRValue_as_json": ("m^2/s^3", 0.01),
    "asn1_format_TurbulenceMinutesInThePast_as_json": ("min", 0.5),
    "asn1_format_TurbulenceObservationWindow_as_json": ("min", 1),
    "asn1_format_TurnRadius_as_json": ("nm", 0.1),
}

# the JSON C file uses the same *_bit_labels / *_labels dicts as the
# text file; map the _as_json fn names onto the shared dicts
_JSON_BIT_LABEL_FN = {fn[:-8] + "_as_json": d
                      for fn, d in BIT_LABEL_FN.items()}
_JSON_ENUM_DICT_FN = {fn[:-8] + "_as_json": d
                      for fn, d in ENUM_DICT_FN.items()}


def _fmt_unit(value: int, unit: str, mult: float, dec: int) -> str:
    if dec == 0:
        return f"{int(value * mult)}{unit}"
    return f"{value * mult:.{dec}f}{unit}"


def _terminal(schema: Schema, ref: str):
    node = schema.resolve(ref)
    while node[0] == "alias":
        node = schema.resolve(node[1])
    return node


def _choice_tref(schema: Schema, tname: str, altname: str) -> Optional[str]:
    node = _terminal(schema, tname)
    if node[0] != "choice":
        return None
    for a in node[1]:
        if a[0] == altname:
            return a[1]
    return None


class IcaoFormatter:
    """One formatting pass; ``table`` selects icao vs acse dispatch."""

    def __init__(self, schema: Schema, table: str = "icao"):
        self.schema = schema
        self.text_tab = TEXT_FMT if table == "icao" else ACSE_TEXT_FMT
        self.json_tab = JSON_FMT if table == "icao" else ACSE_JSON_FMT

    # ------------------------------------------------------------- text
    def text(self, out, tname: str, value: Any, indent: int) -> None:
        """Render ``value`` of type ``tname`` (top-level entry point)."""
        self._t(out, tname, value, indent, override_label=None)

    def _lookup(self, tname: str):
        ent = self.text_tab.get(tname)
        if ent is None and self.text_tab is not TEXT_FMT:
            ent = TEXT_FMT.get(tname)
        if ent is None and self.text_tab is not ACSE_TEXT_FMT:
            ent = ACSE_TEXT_FMT.get(tname)
        return ent

    def _t(self, out, tname: str, value: Any, indent: int,
           override_label: Optional[str] = None) -> None:
        short = tname.split(".")[-1]
        ent = self._lookup(short)
        if ent is None:
            self._generic(out, tname, value, indent,
                          override_label or short)
            return
        fn, label = ent
        label = override_label or label
        if fn is None:
            return                      # deliberately not rendered
        self._dispatch_text(fn, out, tname, value, indent, label)

    # -- structural generics ------------------------------------------
    def _seq_text(self, out, tname, value, indent, label):
        if label:
            out.iline(indent, f"{label}:")
            indent += 1
        node = _terminal(self.schema, tname)
        for memb in node[1]:
            name, tref = memb[0], memb[1]
            if name in value:
                self._t(out, tref, value[name], indent)

    def _choice_text(self, out, tname, value, indent, label,
                     choice_labels=None):
        if _terminal(self.schema, tname)[0] != "choice":
            # the reference's formatter table registers a few
            # non-CHOICE types with the CHOICE formatter (e.g.
            # CancelContract, an extensible ENUM,
            # asn1-format-icao-text.c:1303); render as a labeled value
            self._generic(out, tname, value, indent, label)
            return
        altname, inner = value
        if choice_labels is not None:
            phrase = choice_labels.get(altname, altname)
            out.iline(indent, phrase)
            indent += 1
        elif label:
            out.iline(indent, f"{label}:")
            indent += 1
        tref = _choice_tref(self.schema, tname, altname)
        if tref is None:
            if inner is not None:
                out.iline(indent, f"{altname}: {inner}")
            return
        if _terminal(self.schema, tref)[0] == "null" and \
                choice_labels is not None:
            return                      # phraseology line says it all
        self._t(out, tref, inner, indent)

    def _seqof_text(self, out, tname, value, indent, label):
        if label:
            out.iline(indent, f"{label}:")
            indent += 1
        node = _terminal(self.schema, tname)
        for item in value:
            self._t(out, node[1], item, indent)

    def _any_text(self, out, tname, value, indent, label):
        out.iline(indent, f"{label or tname}: {self._scalar(tname, value)}")

    def _scalar(self, tname: str, value: Any) -> str:
        if isinstance(value, bool):
            return "true" if value else "false"
        if isinstance(value, bytes):
            try:
                s = value.decode("ascii")
                if s.isprintable():
                    return s
            except UnicodeDecodeError:
                pass
            return value.hex()
        if isinstance(value, tuple) and len(value) == 2 and \
                isinstance(value[0], (bytes, bytearray)):
            data, nbits = value
            return "".join(str((data[i >> 3] >> (7 - (i & 7))) & 1)
                           for i in range(nbits))
        if isinstance(value, tuple):
            return ".".join(str(x) for x in value)
        return str(value)

    def _generic(self, out, tname, value, indent, label):
        node = _terminal(self.schema, tname)
        kind = node[0]
        if kind == "seq":
            self._seq_text(out, tname, value, indent, label)
        elif kind == "choice":
            self._choice_text(out, tname, value, indent, label)
        elif kind == "seqof":
            self._seqof_text(out, tname, value, indent, label)
        elif kind == "null":
            out.iline(indent, f"{label}")
        else:
            self._any_text(out, tname, value, indent, label)

    # -- dispatch ------------------------------------------------------
    def _dispatch_text(self, fn, out, tname, value, indent, label):
        s = self.schema
        if fn in ("asn1_format_SEQUENCE_icao_as_text",
                  "asn1_format_SEQUENCE_acse_as_text"):
            self._seq_text(out, tname, value, indent, label)
        elif fn in ("asn1_format_CHOICE_icao_as_text",
                    "asn1_format_CHOICE_acse_as_text"):
            self._choice_text(out, tname, value, indent, label)
        elif fn == "asn1_format_SEQUENCE_OF_icao_as_text":
            self._seqof_text(out, tname, value, indent, label)
        elif fn == "asn1_format_ATCUplinkMsgElementId_as_text":
            self._choice_text(out, tname, value, indent, label,
                              choice_labels=UPLINK_LABELS)
        elif fn == "asn1_format_ATCDownlinkMsgElementId_as_text":
            self._choice_text(out, tname, value, indent, label,
                              choice_labels=DOWNLINK_LABELS)
        elif fn in ("la_asn1_format_any_as_text",):
            self._any_text(out, tname, value, indent, label)
        elif fn == "la_asn1_format_ENUM_as_text":
            out.iline(indent, f"{label}: {value}")
        elif fn == "la_asn1_format_label_only_as_text":
            out.iline(indent, f"{label}")
        elif fn in ENUM_DICT_FN:
            d = ENUM_LABEL_DICTS[ENUM_DICT_FN[fn]]
            pretty = None
            if isinstance(value, str):
                for sym, disp in d.items():
                    if sym.endswith(value.replace("-", "_")):
                        pretty = disp
                        break
            out.iline(indent, f"{label}: {pretty or value}")
        elif fn in BIT_LABEL_FN:
            d = ENUM_LABEL_DICTS[BIT_LABEL_FN[fn]]
            data, nbits = value
            bits = [d.get(str(i), f"bit{i}") for i in range(nbits)
                    if (data[i >> 3] >> (7 - (i & 7))) & 1]
            out.iline(indent, f"{label}: {', '.join(bits)}")
        elif fn == "asn1_format_Modulus_as_text":
            out.iline(indent, f"{label}: every {value} reports")
        elif fn in UNIT_FMT and UNIT_FMT[fn] is not None:
            unit, mult, dec = UNIT_FMT[fn]
            out.iline(indent, f"{label}: {_fmt_unit(value, unit, mult, dec)}")
        elif fn == "asn1_format_Code_as_text":
            out.iline(indent,
                      f"{label}: {''.join(str(x) for x in value)}")
        elif fn == "asn1_format_DateTime_as_text":
            d, t = value["date"], value["time"]
            out.iline(indent, "%s: %04d-%02d-%02d %02d:%02d" % (
                label, d["year"], d["month"], d["day"],
                t["hours"], t["minutes"]))
        elif fn == "asn1_format_DateTimeGroup_as_text":
            d, t = value["date"], value["timehhmmss"]
            hm = t["hoursminutes"]
            out.iline(indent, "%s: %04d-%02d-%02d %02d:%02d:%02d" % (
                label, d["year"], d["month"], d["day"],
                hm["hours"], hm["minutes"], t["seconds"]))
        elif fn == "asn1_format_ADSv2DateTimeGroup_as_text":
            d, t = value["date"], value["time"]
            out.iline(indent, "%s: %04d-%02d-%02d %02d:%02d:%02d" % (
                label, d["year"], d["month"], d["day"],
                t["hours"], t["minutes"], t["seconds"]))
        elif fn == "asn1_format_Time_as_text":
            out.iline(indent, "%s: %02d:%02d" % (
                label, value["hours"], value["minutes"]))
        elif fn == "asn1_format_Timesec_as_text":
            out.iline(indent, "%s: %02d:%02d:%02d" % (
                label, value["hours"], value["minutes"], value["seconds"]))
        elif fn == "asn1_format_Latitude_as_text":
            self._latlon_text(out, value, indent, label, lat=True)
        elif fn == "asn1_format_Longitude_as_text":
            self._latlon_text(out, value, indent, label, lat=False)
        elif fn == "asn1_format_ADSv2Latitude_as_text":
            out.iline(indent, "%s:  %02d %02d' %04.1f\" %s" % (
                label, value["degrees"], value["minutes"],
                value["seconds"] / 10.0, value["direction"]))
        elif fn == "asn1_format_ADSv2Longitude_as_text":
            out.iline(indent, "%s: %03d %02d' %04.1f\" %s" % (
                label, value["degrees"], value["minutes"],
                value["seconds"] / 10.0, value["direction"]))
        elif fn == "asn1_format_UnitName_as_text":
            fdes = value.get("facilityDesignation", "")
            fname = value.get("facilityName", "")
            ffun = value.get("facilityFunction", "")
            out.iline(indent, f"{label}: {fdes}, {fname}, {ffun}")
        elif fn == "asn1_format_RejectDetails_as_text":
            names = {
                "aDS-service-unavailable": "ADS service unavailable",
                "undefined-reason": "undefined reason",
                "maximum-capacity-exceeded": "max. capacity exceeded",
                "reserved": "(reserved)",
                "waypoint-in-request-not-on-the-route":
                    "requested waypoint not on the route",
                "aDS-contract-not-supported": "ADS contract not supported",
                "noneOfReportTypesSupported":
                    "none of report types supported",
                "noneOfEventTypesSupported":
                    "none of event types supported"}
            alt = value[0] if isinstance(value, tuple) else None
            out.iline(indent, f"{label}: {names.get(alt, 'none')}")
        elif fn == "asn1_format_ReportingRate_as_text":
            alt, v = value
            unit = " sec" if "seconds" in alt else " min"
            out.iline(indent, f"{label}: {v}{unit}")
        elif fn == "asn1_format_EstimatedPositionUncertainty_as_text":
            if value == 9900:
                out.iline(indent, f"{label}: complete-loss")
            else:
                out.iline(indent,
                          f"{label}: {_fmt_unit(value, ' nm', 0.01, 2)}")
        elif fn in ("asn1_format_ShortTsap_as_text",
                    "asn1_format_LongTsap_as_text"):
            data = b""
            v = value
            if fn == "asn1_format_LongTsap_as_text":
                data += v.get("rDP", b"")
                v = v.get("shortTsap", {})
            data += v.get("aRS", b"")
            data += v.get("locSysNselTsel", b"")
            out.iline(indent, f"{label}: {self._scalar(tname, data)}")
        elif fn in ("asn1_format_ADSAircraftPDUs_as_text",
                    "asn1_format_ADSGroundPDUs_as_text"):
            inner = ("adsAircraftPdu" if "adsAircraftPdu" in value
                     else "adsGroundPdu")
            tref = ("ADSAircraftPDU" if inner == "adsAircraftPdu"
                    else "ADSGroundPDU")
            self._t(out, tref, value[inner], indent)
        else:
            self._generic(out, tname, value, indent, label)

    def _latlon_text(self, out, value, indent, label, lat: bool):
        which = "latitude" if lat else "longitude"
        dirname = value.get(f"{which}Direction", "")
        typ = value.get(f"{which}Type")
        degfmt = "%02d" if lat else "%03d"
        pad = "  " if lat else ""
        if typ is None:
            out.iline(indent, f"{label}: none")
            return
        alt, v = typ
        if alt.endswith("Degrees"):
            out.iline(indent, f"{label}: {pad}" + degfmt % v + f" {dirname}")
        elif alt.endswith("DegreesMinutes"):
            whole = v[f"{which}WholeDegrees"]
            mins = v["minutesLatLon"] / 100.0
            out.iline(indent, f"{label}: {pad}" + degfmt % whole +
                      " %05.2f' %s" % (mins, dirname))
        elif alt.endswith("DMS"):
            whole = v[f"{which}WholeDegrees"]
            mins = v.get("latlonWholeMinutes", v.get("latLonWholeMinutes"))
            secs = v["secondsLatLon"]
            out.iline(indent, f"{label}: {pad}" + degfmt % whole +
                      " %02d' %02d\" %s" % (mins, secs, dirname))
        else:
            out.iline(indent, f"{label}: none")

    # ------------------------------------------------------------- json
    #
    # Table-driven, mirroring the reference's JSON output walker:
    # la_asn1_output walks the decoded value and renders ONLY types
    # present in asn1_icao_formatter_table_json /
    # asn1_acse_formatter_table_json (dump_unknown=false,
    # asn1-format-icao-json.c:62-67); each table entry supplies the
    # snake_case key and the formatter (JSON_FMT/ACSE_JSON_FMT are
    # machine-extracted from those tables by tools/gen_icao_labels.py).
    # Member keys therefore come from the member TYPE's table label,
    # not the schema member name.  Hand-written compound formatters
    # (Code, DateTime, Time*, Latitude/Longitude, RejectDetails,
    # ReportingRate, OBJECT IDENTIFIER — asn1-format-icao-json.c:
    # 112-360) are replicated 1:1.  The generic SEQUENCE/CHOICE/
    # SEQUENCE-OF/unit wrappers live in libacars (asn1-format-common,
    # not vendored in this repository); their key conventions here
    # ("choice"/"choice_label" members, {"val","unit"} objects,
    # one-key objects per SEQUENCE-OF element) follow libacars's
    # public output code and are documented as such in
    # tests/fixtures/PROVENANCE.md.
    def json(self, tname: str, value: Any) -> JsonObj:
        """Render ``value`` of type ``tname``; returns a dict with the
        type's table label as key (merged by the caller)."""
        obj: JsonObj = {}
        self._j(obj, tname, value)
        return obj

    def _jlookup(self, short: str):
        ent = self.json_tab.get(short)
        if ent is None and self.json_tab is not JSON_FMT:
            ent = JSON_FMT.get(short)
        if ent is None and self.json_tab is not ACSE_JSON_FMT:
            ent = ACSE_JSON_FMT.get(short)
        return ent

    def _j(self, obj: JsonObj, tname: str, value: Any,
           override_label: Optional[str] = None) -> None:
        short = tname.split(".")[-1]
        ent = self._jlookup(short)
        if ent is None:
            return              # not in the formatter table: no output
        fn, label = ent
        if fn is None:
            return
        self._dispatch_json(fn, obj, tname, value,
                            override_label or label)

    def _dispatch_json(self, fn, obj, tname, value, label):
        s = self.schema
        if fn in ("asn1_format_SEQUENCE_icao_as_json",
                  "asn1_format_SEQUENCE_acse_as_json"):
            sub: JsonObj = {}
            node = _terminal(s, tname)
            for memb in node[1]:
                name, tref = memb[0], memb[1]
                if name in value:
                    self._j(sub, tref, value[name])
            obj[label] = sub
        elif fn in ("asn1_format_CHOICE_icao_as_json",
                    "asn1_format_CHOICE_acse_as_json",
                    "asn1_format_ATCUplinkMsgElementId_as_json",
                    "asn1_format_ATCDownlinkMsgElementId_as_json"):
            if _terminal(s, tname)[0] != "choice":
                # non-CHOICE types registered with the CHOICE formatter
                # (e.g. CancelContract, an extensible ENUM) — same
                # fallback as the text path (_choice_text)
                obj[label] = self._generic_json(tname, value)
                return
            altname, inner = value
            sub = {}
            if fn == "asn1_format_ATCUplinkMsgElementId_as_json":
                sub["choice_label"] = UPLINK_LABELS.get(altname, "")
            elif fn == "asn1_format_ATCDownlinkMsgElementId_as_json":
                sub["choice_label"] = DOWNLINK_LABELS.get(altname, "")
            sub["choice"] = altname
            tref = _choice_tref(s, tname, altname)
            if tref is not None:
                self._j(sub, tref, inner)
            obj[label] = sub
        elif fn == "asn1_format_SEQUENCE_OF_icao_as_json":
            node = _terminal(s, tname)
            arr = []
            for item in value:
                it: JsonObj = {}
                self._j(it, node[1], item)
                arr.append(it)
            obj[label] = arr
        elif fn == "la_asn1_format_long_as_json":
            obj[label] = int(value)
        elif fn == "la_asn1_format_bool_as_json":
            obj[label] = bool(value)
        elif fn in ("la_asn1_format_any_as_string_as_json",
                    "la_asn1_format_ENUM_as_json"):
            obj[label] = self._scalar(tname, value)
        elif fn == "la_asn1_format_label_only_as_json":
            obj[label] = True
        elif fn == "la_asn1_format_OCTET_STRING_as_json":
            obj[label] = value.hex() if isinstance(value, (bytes, bytearray)) \
                else self._scalar(tname, value)
        elif fn in UNIT_FMT_JSON:
            unit, mult = UNIT_FMT_JSON[fn]
            v = value * mult
            obj[label] = {"val": int(v) if isinstance(v, int) else v,
                          "unit": unit}
        elif fn in _JSON_ENUM_DICT_FN:
            d = ENUM_LABEL_DICTS[_JSON_ENUM_DICT_FN[fn]]
            pretty = None
            if isinstance(value, str):
                for sym, disp in d.items():
                    if sym.endswith(value.replace("-", "_")):
                        pretty = disp
                        break
            obj[label] = pretty or value
        elif fn in _JSON_BIT_LABEL_FN:
            d = ENUM_LABEL_DICTS[_JSON_BIT_LABEL_FN[fn]]
            data, nbits = value
            obj[label] = [d.get(str(i), f"bit{i}") for i in range(nbits)
                          if (data[i >> 3] >> (7 - (i & 7))) & 1]
        elif fn == "asn1_format_Code_as_json":
            digits = list(value)
            obj[label] = (digits[0] * 1000 + digits[1] * 100
                          + digits[2] * 10 + digits[3])
        elif fn == "asn1_format_DateTime_as_json":
            d, t = value["date"], value["time"]
            obj[label] = {"year": d["year"], "month": d["month"],
                          "day": d["day"], "hour": t["hours"],
                          "min": t["minutes"]}
        elif fn == "asn1_format_Timehhmmss_as_json":
            hm = value["hoursminutes"]
            obj[label] = {"hour": hm["hours"], "min": hm["minutes"],
                          "sec": value["seconds"]}
        elif fn == "asn1_format_Time_as_json":
            obj[label] = {"hour": value["hours"], "min": value["minutes"]}
        elif fn in ("asn1_format_Latitude_as_json",
                    "asn1_format_Longitude_as_json"):
            obj[label] = self._latlon_json(
                value, lat=(fn == "asn1_format_Latitude_as_json"))
        elif fn in ("asn1_format_ADSv2Latitude_as_json",
                    "asn1_format_ADSv2Longitude_as_json"):
            sec = value["seconds"] / 10.0
            obj[label] = {"deg": value["degrees"], "min": value["minutes"],
                          "sec": int(sec) if sec == int(sec) else sec,
                          "dir": value["direction"]}
        elif fn == "asn1_format_RejectDetails_as_json":
            names = {
                "aDS-service-unavailable": "ADS_service_unavailable",
                "undefined-reason": "undefined_reason",
                "maximum-capacity-exceeded": "max_capacity_exceeded",
                "reserved": "(reserved)",
                "waypoint-in-request-not-on-the-route":
                    "requested_waypoint_not_on_the_route",
                "aDS-contract-not-supported": "ADS_contract_not_supported",
                "noneOfReportTypesSupported":
                    "none_of_report_types_supported",
                "noneOfEventTypesSupported":
                    "none_of_event_types_supported"}
            alt = value[0] if isinstance(value, tuple) else None
            obj[label] = names.get(alt, "none")
        elif fn == "asn1_format_ReportingRate_as_json":
            alt, v = value
            obj[label] = {"val": int(v),
                          "unit": "sec" if "seconds" in alt else "min"}
        elif fn == "asn1_format_OBJECT_IDENTIFIER_as_json":
            obj[label] = [int(x) for x in value] \
                if isinstance(value, (tuple, list)) else value
        else:
            # unknown formatter name: render structurally so data is
            # never silently dropped by OUR code (the reference only
            # drops types absent from its table, handled above)
            obj[label] = self._generic_json(tname, value)

    def _latlon_json(self, value, lat: bool) -> JsonObj:
        """asn1-format-icao-json.c:153-199 (deg/min/sec by variant,
        then dir)."""
        which = "latitude" if lat else "longitude"
        out: JsonObj = {}
        typ = value.get(f"{which}Type")
        if typ is not None:
            alt, v = typ
            if alt.endswith("Degrees"):
                out["deg"] = v
            elif alt.endswith("DegreesMinutes"):
                out["deg"] = v[f"{which}WholeDegrees"]
                out["min"] = v["minutesLatLon"] / 100.0
            elif alt.endswith("DMS"):
                out["deg"] = v[f"{which}WholeDegrees"]
                out["min"] = v.get("latlonWholeMinutes",
                                   v.get("latLonWholeMinutes"))
                out["sec"] = v["secondsLatLon"]
        out["dir"] = value.get(f"{which}Direction", "")
        return out

    def _generic_json(self, tname: str, value: Any) -> Any:
        node = _terminal(self.schema, tname)
        kind = node[0]
        if kind == "seq":
            sub: JsonObj = {}
            for memb in node[1]:
                name, tref = memb[0], memb[1]
                if name in value:
                    self._j(sub, tref, value[name])
            return sub
        if kind == "choice":
            altname, inner = value
            sub = {"choice": altname}
            tref = _choice_tref(self.schema, tname, altname)
            if tref is not None:
                self._j(sub, tref, inner)
            return sub
        if kind == "seqof":
            arr = []
            for item in value:
                it: JsonObj = {}
                self._j(it, node[1], item)
                arr.append(it)
            return arr
        return self._scalar(tname, value)
