"""ACARS message parser (ARINC 618 air/ground character protocol).

Replaces the reference's dependency on libacars'
``la_acars_parse_and_reassemble`` (acars.c:100-114).  VDL2 carries ACARS
over AVLC ("AOA"): the I-frame info field starts with FF FF 01 followed
by the ACARS block from the mode character onward, optionally ending
with suffix (ETX/ETB), CRC and DEL.

Layout (after the mode char): 7-char registration, technical ack, 2-char
label, block id; an empty body is a link-ack message.  A body starts
with STX; downlink bodies carry a 4-char message number (3 + sequence
letter) and 6-char flight id before the text.  Multi-block downlink
messages (suffix ETB) are reassembled on block-id sequence.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..app.stats import stats
from ..config import MsgFilter
from .base import JsonObj, ProtoNode, TextOut
from .reasm import ReasmStatus, SEQ_FIRST_NONE

SOH, STX, ETX, ETB, DEL, NAK = 0x01, 0x02, 0x03, 0x17, 0x7F, 0x15

ACARS_REASM_TIMEOUT = 300.0       # seconds, matches libacars' default window

MSG_DIR_UNKNOWN = "unknown"
MSG_DIR_AIR2GND = "air2gnd"
MSG_DIR_GND2AIR = "gnd2air"

from ..link.crc import crc16_ccitt  # noqa: E402

# lazily-bound ACARS application parsers (cycle-safe)
_arinc622 = _apps = None


def _crc16_arinc(data: bytes) -> int:
    """ARINC 618 block check sequence: CRC-16/CCITT (reflected), init 0
    — the same polynomial as the AVLC FCS, so it shares the CRC of
    link/crc.py with a zero initial value."""
    return crc16_ccitt(data, 0)


class AcarsNode(ProtoNode):
    json_key = "acars"

    def __init__(self) -> None:
        super().__init__()
        self.err = False
        self.crc_ok = True
        self.final_block = True
        self.mode = ""
        self.reg = ""
        self.ack = ""
        self.label = ""
        self.block_id = ""
        self.msg_num = ""
        self.msg_num_seq = ""
        self.flight_id = ""
        self.sublabel = ""
        self.mfi = ""
        self.txt = ""
        self.txt_raw = b""          # unmasked 8-bit body (ATS units)
        self.reasm_status = ReasmStatus.UNKNOWN
        self.msg_dir = MSG_DIR_UNKNOWN
        self.raw = b""

    def format_text(self, out: TextOut, indent: int) -> None:
        if self.err:
            out.iline(indent, "-- Unparseable ACARS message")
            return
        reassembled = " (reassembled)" \
            if self.reasm_status is ReasmStatus.COMPLETE else ""
        out.iline(indent, f"ACARS{reassembled}:")
        indent += 1
        if not self.crc_ok:
            out.iline(indent, "CRC check failed")
        if self.reasm_status is not ReasmStatus.UNKNOWN:
            out.iline(indent, f"Reassembly: {self.reasm_status.value}")
        if self.msg_dir == MSG_DIR_AIR2GND:
            out.iline(indent, f"Reg: {self.reg} Flight: {self.flight_id}")
        out.iline(indent, "Mode: %s Label: %s Blk id: %s Ack: %s" % (
            self.mode, self.label, self.block_id, self.ack)
            + (" Msg no.: %s%s" % (self.msg_num, self.msg_num_seq)
               if self.msg_num else ""))
        if self.sublabel:
            out.iline(indent, f"Sublabel: {self.sublabel}")
        if self.mfi:
            out.iline(indent, f"MFI: {self.mfi}")
        if self.txt:
            out.iline(indent, "Message:")
            for line in _maybe_prettify(self.txt).split("\n"):
                out.iline(indent + 1, line)

    def format_json(self, obj: JsonObj) -> None:
        obj["err"] = self.err
        if self.err:
            return
        obj["crc_ok"] = self.crc_ok
        obj["more"] = not self.final_block
        obj["reg"] = self.reg
        obj["mode"] = self.mode
        obj["label"] = self.label
        obj["blk_id"] = self.block_id
        obj["ack"] = self.ack
        obj["flight"] = self.flight_id
        obj["msg_num"] = self.msg_num
        obj["msg_num_seq"] = self.msg_num_seq
        if self.sublabel:
            obj["sublabel"] = self.sublabel
        if self.mfi:
            obj["mfi"] = self.mfi
        if self.reasm_status is not ReasmStatus.UNKNOWN:
            obj["reasm_status"] = self.reasm_status.value
        obj["msg_text"] = self.txt


_STRIP_PARITY = bytes(i & 0x7F for i in range(256))


def _printable(raw: bytes) -> str:
    return raw.translate(_STRIP_PARITY).decode("latin-1")


def _maybe_prettify(txt: str) -> str:
    """Re-indent XML / JSON message bodies when the --prettify-xml /
    --prettify-json flags are set (reference README.md:805: libacars
    applies the same treatment to ACARS and MIAM CORE text payloads).
    Returns the text unchanged unless it parses cleanly."""
    from ..config import Config
    if Config.prettify_xml and "<" in txt:
        start = txt.find("<")
        try:
            import xml.dom.minidom as minidom
            doc = minidom.parseString(txt[start:])
            pretty = doc.toprettyxml(indent="  ")
            # drop the XML declaration minidom adds and blank lines
            lines = [ln for ln in pretty.split("\n")
                     if ln.strip() and not ln.startswith("<?xml")]
            return txt[:start] + "\n".join(lines)
        except Exception:
            pass
    if Config.prettify_json and ("{" in txt or "[" in txt):
        import json as _json
        start = min((i for i in (txt.find("{"), txt.find("["))
                     if i >= 0), default=-1)
        if start >= 0:
            try:
                doc = _json.loads(txt[start:])
                return txt[:start] + _json.dumps(doc, indent=2)
            except Exception:
                pass
    return txt


def acars_parse(buf: bytes, msg_dir: str, reasm_ctx=None,
                rx_time: float = 0.0) -> AcarsNode:
    """Parse one ACARS block starting at the mode character."""
    node = AcarsNode()
    node.raw = bytes(buf)
    node.msg_dir = msg_dir
    if len(buf) < 12:
        node.err = True
        return node
    data = bytearray(buf)
    if data and data[-1] == DEL:
        del data[-1]
    # locate suffix + CRC: [ ... ETX|ETB ][crc lo][crc hi]
    body_end = len(data)
    node.final_block = True
    if len(data) >= 15 and data[-3] in (ETX, ETB):
        node.crc_ok = _crc16_arinc(bytes(data[:-2])) == \
            (data[-2] | (data[-1] << 8))
        node.final_block = data[-3] == ETX
        body_end = len(data) - 3

    node.mode = chr(data[0] & 0x7F)
    node.reg = _printable(bytes(data[1:8]))
    ack = data[8] & 0x7F
    node.ack = "!" if ack == NAK else chr(ack)
    node.label = _printable(bytes(data[9:11])).replace("\x7f", "d")
    blk = data[11] & 0x7F
    node.block_id = chr(blk) if blk != NAK else ""

    if msg_dir == MSG_DIR_UNKNOWN:
        # downlink block ids are digits, uplink are letters
        msg_dir = MSG_DIR_AIR2GND if node.block_id.isdigit() \
            else MSG_DIR_GND2AIR
        node.msg_dir = msg_dir

    if body_end <= 12:
        node.txt = ""
        return node
    if data[12] != STX:
        node.err = True
        return node
    body_raw = bytes(data[13:body_end])
    body = _printable(body_raw)
    if msg_dir == MSG_DIR_AIR2GND:
        if len(body) < 10:
            node.err = True
            return node
        node.msg_num = body[0:3]
        node.msg_num_seq = body[3]
        node.flight_id = body[4:10]
        node.txt = body[10:]
        node.txt_raw = body_raw[10:]
    else:
        node.txt = body
        node.txt_raw = body_raw

    _extract_sublabel_mfi(node)
    return node


def _extract_sublabel_mfi(node: AcarsNode) -> None:
    """Label H1 payloads may start with '#<sublabel>B' and an MFI."""
    if node.label != "H1" or not node.txt:
        return
    txt = node.txt
    if node.msg_dir == MSG_DIR_AIR2GND:
        if len(txt) >= 4 and txt[0] == "#" and txt[3] == "B":
            node.sublabel = txt[1:3]
            txt = txt[4:]
            node.txt_raw = node.txt_raw[4:]
            if len(txt) >= 4 and txt[2] == "/" :
                node.mfi = txt[0:2]
                txt = txt[3:]
                node.txt_raw = node.txt_raw[3:]
            node.txt = txt
    else:
        # uplink form: "- #<sublabel>" then optional "<MFI>/"
        if len(txt) >= 5 and txt[0] == "-" and txt[1] == " " \
                and txt[2] == "#":
            node.sublabel = txt[3:5]
            txt = txt[5:]
            node.txt_raw = node.txt_raw[5:]
            if len(txt) >= 3 and txt[2] == "/":
                node.mfi = txt[0:2]
                txt = txt[3:]
                node.txt_raw = node.txt_raw[3:]
            node.txt = txt


def _reassemble(node: AcarsNode, reasm_ctx, rx_time: float) -> None:
    if reasm_ctx is None or node.err:
        return
    table = reasm_ctx.seq_table("acars")
    if node.msg_dir != MSG_DIR_AIR2GND or not node.block_id:
        node.reasm_status = ReasmStatus.SKIPPED
        return
    key = (node.reg, node.msg_num, node.msg_num_seq, node.flight_id)
    seq = ord(node.block_id)
    status = table.add_fragment(
        key, node.txt.encode("latin-1"), seq,
        is_final=node.final_block, rx_time=rx_time,
        timeout=ACARS_REASM_TIMEOUT, seq_num_first=SEQ_FIRST_NONE)
    node.reasm_status = status
    if status is ReasmStatus.COMPLETE:
        payload = table.payload_get(key)
        if payload is not None:
            node.txt = payload.decode("latin-1")
            node.txt_raw = payload


def parse_acars(buf: bytes, msg_type: int, reasm_ctx=None,
                rx_time: float = 0.0) -> tuple[ProtoNode, int]:
    """Entry point from the AVLC layer (reference acars.c:100-114)."""
    if msg_type & MsgFilter.SRC_AIR:
        msg_dir = MSG_DIR_AIR2GND
    elif msg_type & MsgFilter.SRC_GND:
        msg_dir = MSG_DIR_GND2AIR
    else:
        msg_dir = MSG_DIR_UNKNOWN
    node = acars_parse(buf, msg_dir, reasm_ctx, rx_time)
    _reassemble(node, reasm_ctx, rx_time)
    if not node.err:
        if node.txt:
            msg_type |= MsgFilter.ACARS_DATA
        else:
            msg_type |= MsgFilter.ACARS_NODATA
        stats.increment_per_msgdir(
            node.msg_dir, "acars.reasm." + node.reasm_status.name.lower())
        # ARINC 622 ATS applications (CPDLC / ADS-C) ride on specific
        # labels; parsed by proto/arinc622.py when present.
        global _arinc622, _apps
        if _arinc622 is None:
            from .acars_apps import decode_acars_apps
            from .arinc622 import maybe_parse_arinc622
            _arinc622, _apps = maybe_parse_arinc622, decode_acars_apps
        child, msg_type = _arinc622(node, msg_type)
        if child is None and node.txt:
            # other ACARS applications: media advisory / OHMA / MIAM
            child = _apps(node.label, node.txt, reg=node.reg,
                          reasm_ctx=reasm_ctx,
                          rx_time=rx_time)
        node.next = child
    return node, msg_type
