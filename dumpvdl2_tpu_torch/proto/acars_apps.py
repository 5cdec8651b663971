"""ACARS application decoders beyond ARINC 622: media advisory, OHMA,
and dispatch into the MIAM decoder (proto/miam.py).

The reference gets these from libacars' la_acars_decode_apps
(reference src/acars.c:108 via la_acars_parse_and_reassemble).  Status
of each here:

* Media advisory (label SA, ARINC 618 attachment): fully decoded —
  version / link state / current media / UTC time / available-media
  list.  The format is a printable fixed-layout string.
* OHMA (Boeing OnHealth Management, label H1 "OHMA" prefix): fully
  decoded — base64 -> zlib DEFLATE -> JSON, with JWS envelope
  unwrapping when present.
* MIAM (ARINC 841, label MA): fully decoded by proto/miam.py — all 7
  frame types, file-transfer reassembly, CORE v1/v2 PDU decode
  (armoring, DEFLATE, CRC-32).  See miam.py's provenance note.
"""
from __future__ import annotations

import base64
import json
import zlib
from typing import Optional

from .base import JsonObj, ProtoNode, TextOut

# ---------------------------------------------------------------- media adv

_MEDIA_NAMES = {
    "S": "Satellite",
    "H": "HF",
    "V": "VHF ACARS",
    "G": "Global Star Satellite",
    "C": "ICO Satellite",
    "2": "VDL2",
    "X": "Inmarsat Aero",
    "I": "Iridium Satellite",
}


class MediaAdvisoryNode(ProtoNode):
    """Decoded media advisory (downlink, ACARS label SA)."""
    json_key = "media_adv"

    def __init__(self, version: str, state: str, current: str,
                 hhmmss: str, available: str, error: str = "") -> None:
        super().__init__()
        self.version = version
        self.state = state
        self.current = current
        self.hhmmss = hhmmss
        self.available = available
        self.error = error

    def format_text(self, out: TextOut, indent: int) -> None:
        out.iline(indent, "Media Advisory:")
        indent += 1
        if self.error:
            out.iline(indent, f"-- {self.error}")
            return
        state = {"E": "established", "L": "lost"}.get(self.state,
                                                      self.state)
        cur = _MEDIA_NAMES.get(self.current, self.current)
        t = f"{self.hhmmss[0:2]}:{self.hhmmss[2:4]}:{self.hhmmss[4:6]}"
        out.iline(indent, f"Version: {self.version}")
        out.iline(indent, f"Link {state}: {cur} at {t} UTC")
        if self.available:
            names = ", ".join(_MEDIA_NAMES.get(ch, ch)
                              for ch in self.available)
            out.iline(indent, f"Available links: {names}")

    def format_json(self, obj: JsonObj) -> None:
        if self.error:
            obj["err"] = self.error
            return
        obj["version"] = self.version
        obj["link_status"] = {"E": "established",
                              "L": "lost"}.get(self.state, self.state)
        obj["current_link"] = _MEDIA_NAMES.get(self.current, self.current)
        obj["time"] = self.hhmmss
        obj["available_links"] = [
            _MEDIA_NAMES.get(ch, ch) for ch in self.available]


def media_adv_parse(txt: str) -> Optional[MediaAdvisoryNode]:
    """Parse ``<version><E|L><media><HHMMSS>[/<available...>]``."""
    if len(txt) < 9 or txt[1] not in ("E", "L"):
        return None
    version, state, current = txt[0], txt[1], txt[2]
    hhmmss = txt[3:9]
    if not hhmmss.isdigit():
        return None
    rest = txt[9:]
    available = ""
    if rest.startswith("/"):
        available = "".join(ch for ch in rest[1:] if ch.isalnum())
    return MediaAdvisoryNode(version, state, current, hhmmss, available)


# --------------------------------------------------------------------- OHMA


class OhmaNode(ProtoNode):
    """Decoded OHMA message (zlib-compressed JSON, optionally JWS)."""
    json_key = "ohma"

    def __init__(self, doc, raw: bytes = b"", error: str = "") -> None:
        super().__init__()
        self.doc = doc
        self.raw = raw
        self.error = error

    def format_text(self, out: TextOut, indent: int) -> None:
        out.iline(indent, "OHMA message:")
        indent += 1
        if self.error:
            out.iline(indent, f"-- {self.error}")
            return
        from ..config import Config
        text = json.dumps(self.doc, indent=2 if Config.prettify_json
                          else None, sort_keys=False)
        for line in text.split("\n"):
            out.iline(indent, line)

    def format_json(self, obj: JsonObj) -> None:
        if self.error:
            obj["err"] = self.error
            return
        obj["message"] = self.doc


def _b64(data: str) -> Optional[bytes]:
    s = data.strip().replace("-", "+").replace("_", "/")
    s += "=" * (-len(s) % 4)
    try:
        return base64.b64decode(s, validate=False)
    except Exception:
        return None


def ohma_parse(txt: str) -> Optional[OhmaNode]:
    """Decode an OHMA payload: base64(zlib(JSON)), possibly wrapped in
    a JWS compact envelope (header.payload.signature)."""
    if not txt.startswith("OHMA"):
        return None
    body = txt[4:]
    blob = _b64(body)
    if blob is None:
        return OhmaNode(None, error="invalid base64 payload")
    try:
        plain = zlib.decompress(blob)
    except zlib.error:
        plain = blob
    # JWS compact serialization? (three base64url parts)
    doc = None
    text = plain.decode("utf-8", "replace")
    if text.count(".") == 2 and not text.lstrip().startswith("{"):
        payload = _b64(text.split(".")[1])
        if payload is not None:
            try:
                payload = zlib.decompress(payload)
            except zlib.error:
                pass
            try:
                doc = json.loads(payload)
            except Exception:
                doc = None
    if doc is None:
        try:
            doc = json.loads(text)
        except Exception:
            return OhmaNode(None, raw=plain[:512],
                            error="payload is not JSON")
    return OhmaNode(doc)


# ---------------------------------------------------------------- dispatch


def decode_acars_apps(label: str, txt: str, reg: str = "",
                      reasm_ctx=None,
                      rx_time: float = 0.0) -> Optional[ProtoNode]:
    """Label-keyed application dispatch (reference: libacars
    la_acars_decode_apps order — ARINC 622 is handled separately in
    proto/arinc622.py)."""
    if label == "SA":
        return media_adv_parse(txt)
    if label == "MA":
        from ..config import Config
        if Config.miam == "off":      # operator disabled the
            return None               # reconstructed CORE codec
        from .miam import miam_parse
        return miam_parse(txt, reg=reg, reasm_ctx=reasm_ctx,
                          rx_time=rx_time)
    if txt.startswith("OHMA"):
        return ohma_parse(txt)
    return None
