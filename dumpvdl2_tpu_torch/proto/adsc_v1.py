"""FANS-1/A ADS-C (version 1) binary message decoder.

Decodes the tag-grouped binary ADS-C payload carried in ARINC 622 ATS
units (ACARS IMI "ADS"/"DIS"), per ARINC 745-2 / RTCA DO-258A.  The
reference obtains this decode from libacars' adsc.c (historically the
same decoder lived in dumpvdl2 <= 1.5.0, removed in 1.6.0 per
doc/NEWS.md:238-241); this is an independent implementation from the
published group layouts.

Downlink messages are a concatenation of tagged groups; each tag has a
fixed-length binary body (bit-packed, MSB first).  Unknown tags
terminate the walk with an honest raw dump of the remainder.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from .base import JsonObj, ProtoNode, TextOut, hex_str


class _BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0                       # bit position

    def bits_left(self) -> int:
        return 8 * len(self.data) - self.pos

    def take(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def take_signed(self, n: int) -> int:
        v = self.take(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v


# Scaling constants (ARINC 745-2 basic group encodings)
_LATLON_LSB = 180.0 / (1 << 20)            # 21-bit two's complement
_ALT_LSB = 4.0                             # ft
_TS_LSB = 0.125                            # s, 15-bit
_TRK_LSB = 360.0 / 4096                    # 12-bit angle
_GS_LSB = 0.5                              # kt, 13-bit
_VR_LSB = 16.0                             # ft/min, 12-bit signed
_MACH_LSB = 0.0005                         # 13-bit
_WSPD_LSB = 0.25                           # kt, 9-bit
_WDIR_LSB = 360.0 / 512                    # 9-bit
_TEMP_LSB = 0.25                           # deg C, 12-bit signed
_DIST_LSB = 0.125                          # nm, 16-bit


@dataclass
class AdscGroup:
    tag: int
    name: str
    fields: dict = field(default_factory=dict)
    raw: bytes = b""

    def format_text(self, out: TextOut, indent: int) -> None:
        out.iline(indent, f"{self.name}:")
        for k, v in self.fields.items():
            out.iline(indent + 1, f"{k}: {v}")
        if self.raw:
            out.iline(indent + 1, f"Data: {hex_str(self.raw)}")

    def to_json(self) -> JsonObj:
        obj = JsonObj(tag=self.tag, name=self.name)
        obj.update(self.fields)
        if self.raw:
            obj["data"] = hex_str(self.raw)
        return obj


def _fmt_deg(v: float) -> str:
    return f"{v:.7f} deg"


def _basic_report(r: _BitReader, grp: AdscGroup) -> None:
    lat = r.take_signed(21) * _LATLON_LSB
    lon = r.take_signed(21) * _LATLON_LSB
    alt = r.take_signed(16) * _ALT_LSB
    ts = r.take(15) * _TS_LSB
    redundancy = r.take(1)
    accuracy = r.take(3)
    tcas = r.take(1)
    r.take(2)                              # spare
    grp.fields.update({
        "lat": round(lat, 7), "lon": round(lon, 7),
        "alt_ft": alt, "timestamp_sec": ts,
        "position_accuracy": accuracy,
        "nav_redundancy": ("lost", "ok")[redundancy],
        "tcas_health": ("unavailable", "ok")[tcas],
    })


def _flight_id(r: _BitReader, grp: AdscGroup) -> None:
    chars = []
    for _ in range(8):
        c = r.take(6)
        chars.append(chr(c + 64) if c < 32 else chr(c))
    grp.fields["flight_id"] = "".join(chars).rstrip()


def _predicted_route(r: _BitReader, grp: AdscGroup) -> None:
    grp.fields["next_waypoint"] = {
        "lat": round(r.take_signed(21) * _LATLON_LSB, 7),
        "lon": round(r.take_signed(21) * _LATLON_LSB, 7),
        "alt_ft": r.take_signed(16) * _ALT_LSB,
        "eta_sec": r.take(14)}
    grp.fields["next_next_waypoint"] = {
        "lat": round(r.take_signed(21) * _LATLON_LSB, 7),
        "lon": round(r.take_signed(21) * _LATLON_LSB, 7),
        "alt_ft": r.take_signed(16) * _ALT_LSB}
    r.take(6)                              # spare


def _earth_ref(r: _BitReader, grp: AdscGroup) -> None:
    grp.fields.update({
        "true_track_deg": round(r.take(12) * _TRK_LSB, 4),
        "ground_speed_kt": r.take(13) * _GS_LSB,
        "vertical_rate_fpm": r.take_signed(12) * _VR_LSB})
    r.take(3)


def _air_ref(r: _BitReader, grp: AdscGroup) -> None:
    grp.fields.update({
        "true_heading_deg": round(r.take(12) * _TRK_LSB, 4),
        "mach": round(r.take(13) * _MACH_LSB, 4),
        "vertical_rate_fpm": r.take_signed(12) * _VR_LSB})
    r.take(3)


def _meteo(r: _BitReader, grp: AdscGroup) -> None:
    grp.fields.update({
        "wind_speed_kt": r.take(9) * _WSPD_LSB,
        "wind_dir_deg": round(r.take(9) * _WDIR_LSB, 4),
        "temperature_c": r.take_signed(12) * _TEMP_LSB})
    r.take(2)


def _airframe_id(r: _BitReader, grp: AdscGroup) -> None:
    grp.fields["icao_hex"] = f"{r.take(24):06X}"


def _intermediate_intent(r: _BitReader, grp: AdscGroup) -> None:
    grp.fields.update({
        "distance_nm": r.take(16) * _DIST_LSB,
        "true_track_deg": round(r.take(12) * _TRK_LSB, 4),
        "alt_ft": r.take_signed(16) * _ALT_LSB,
        "projected_time_sec": r.take(14)})
    r.take(6)


def _fixed_intent(r: _BitReader, grp: AdscGroup) -> None:
    grp.fields.update({
        "lat": round(r.take_signed(21) * _LATLON_LSB, 7),
        "lon": round(r.take_signed(21) * _LATLON_LSB, 7),
        "alt_ft": r.take_signed(16) * _ALT_LSB,
        "projected_time_sec": r.take(14)})


def _ack(r: _BitReader, grp: AdscGroup) -> None:
    grp.fields["contract_req_num"] = r.take(8)


def _nak(r: _BitReader, grp: AdscGroup) -> None:
    grp.fields["contract_req_num"] = r.take(8)
    grp.fields["reason"] = r.take(8)


def _cancel_emergency(r: _BitReader, grp: AdscGroup) -> None:
    pass


# Downlink groups: tag -> (name, body length in octets, parser).
# Lengths per ARINC 745-2; event reports (10/18/19/20) embed a basic
# report (the triggering condition), altitude-range adds the window.
_DOWNLINK_GROUPS: dict[int, tuple[str, int, Callable]] = {
    3: ("Acknowledgement", 1, _ack),
    4: ("Negative acknowledgement", 2, _nak),
    5: ("Noncompliance notification", -1, None),   # variable -> raw
    6: ("Cancel emergency mode", 0, _cancel_emergency),
    7: ("Basic report", 10, _basic_report),
    9: ("Emergency basic report", 10, _basic_report),
    10: ("Lateral deviation change event", 10, _basic_report),
    12: ("Flight ID data", 6, _flight_id),
    13: ("Predicted route", 17, _predicted_route),
    14: ("Earth reference data", 5, _earth_ref),
    15: ("Air reference data", 5, _air_ref),
    16: ("Meteorological data", 4, _meteo),
    17: ("Airframe ID", 3, _airframe_id),
    18: ("Vertical rate change event", 10, _basic_report),
    19: ("Altitude range change event", 12, None),
    20: ("Waypoint change event", 10, _basic_report),
    22: ("Intermediate projected intent", 8, _intermediate_intent),
    23: ("Fixed projected intent", 9, _fixed_intent),
}


def _periodic_contract(r: _BitReader, grp: AdscGroup) -> None:
    grp.fields["contract_req_num"] = r.take(8)
    mods = []
    while r.bits_left() >= 8:
        tag = r.take(8)
        if tag == 11 and r.bits_left() >= 16:
            scale = r.take(2)
            rate = r.take(14)
            mods.append({"group": "reporting interval",
                         "interval_sec": rate * (1, 8, 64, 512)[scale] / 8})
        elif tag in _DOWNLINK_GROUPS and r.bits_left() >= 8:
            mods.append({"group": _DOWNLINK_GROUPS[tag][0],
                         "modulus": r.take(8)})
        else:
            rest = bytearray()
            while r.bits_left() >= 8:
                rest.append(r.take(8))
            mods.append({"unknown_tag": tag, "data": hex_str(bytes(rest))})
            break
    grp.fields["requested"] = mods


def _contract_number(r: _BitReader, grp: AdscGroup) -> None:
    grp.fields["contract_req_num"] = r.take(8)


# Uplink groups (contract requests / management).
_UPLINK_GROUPS: dict[int, tuple[str, int, Callable]] = {
    1: ("Cancel all contracts", 0, _cancel_emergency),
    2: ("Cancel contract", 1, _contract_number),
    7: ("Periodic contract request", -2, _periodic_contract),
    8: ("Event contract request", -1, None),
    9: ("Emergency periodic contract request", -2, _periodic_contract),
}


class AdscNode(ProtoNode):
    """Decoded ADS-C v1 message (list of groups)."""
    json_key = "adsc_v1"

    def __init__(self, direction: str, groups: list[AdscGroup],
                 error: str = "") -> None:
        super().__init__()
        self.direction = direction
        self.groups = groups
        self.error = error

    def format_text(self, out: TextOut, indent: int) -> None:
        out.iline(indent, f"ADS-C message ({self.direction}):")
        for g in self.groups:
            g.format_text(out, indent + 1)
        if self.error:
            out.iline(indent + 1, f"-- {self.error}")

    def format_json(self, obj: JsonObj) -> None:
        obj["dir"] = self.direction
        obj["groups"] = [g.to_json() for g in self.groups]
        if self.error:
            obj["err"] = self.error


def adsc_parse(data: bytes, downlink: bool) -> AdscNode:
    """Parse an ADS-C v1 binary payload into a group list."""
    table = _DOWNLINK_GROUPS if downlink else _UPLINK_GROUPS
    direction = "downlink" if downlink else "uplink"
    groups: list[AdscGroup] = []
    pos = 0
    error = ""
    while pos < len(data):
        tag = data[pos]
        pos += 1
        spec = table.get(tag)
        if spec is None:
            groups.append(AdscGroup(tag, f"Unknown group (tag {tag})",
                                    raw=data[pos:]))
            error = "unknown group tag; remainder not decoded"
            break
        name, length, parser = spec
        if length == -2:                  # parser consumes the remainder
            grp = AdscGroup(tag, name)
            parser(_BitReader(data[pos:]), grp)
            groups.append(grp)
            pos = len(data)
            continue
        if length < 0 or parser is None:  # variable/undecoded -> raw
            groups.append(AdscGroup(tag, name, raw=data[pos:]))
            pos = len(data)
            continue
        if pos + length > len(data):
            groups.append(AdscGroup(tag, name, raw=data[pos:]))
            error = "truncated group"
            break
        grp = AdscGroup(tag, name)
        parser(_BitReader(data[pos:pos + length]), grp)
        groups.append(grp)
        pos += length
    return AdscNode(direction, groups, error)
