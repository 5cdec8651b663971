"""MIAM (ARINC 841 Media Independent Aircraft Messaging) decoder.

The reference delegates MIAM to libacars inside
``la_acars_parse_and_reassemble`` (reference src/acars.c:108); this
module is the standalone equivalent: ACARS frame classification, file
transfer reassembly, and MIAM CORE v1/v2 PDU decode (armoring, header,
DEFLATE decompression, CRC-32 check, XML/text body rendering).

Provenance note.  The ARINC 841 specification was not available to
work from and the wire format could not be copied from an existing
implementation (none was available).  The layer split,
frame-type alphabet, field inventory (version, PDU type Data/Ack/Aloha/
Aloha-reply, application type/id, DEFLATE compression, ISO-5 vs binary
encoding, message numbers, CRC) and the file-transfer state machine
follow the publicly documented feature surface of the open-source
libacars decoder; the exact bit/character layout below is this
framework's documented reconstruction, kept deliberately simple and
self-describing:

* frame layer: first text character selects the frame type
  (T/F/K/S/A/Y/X); file-transfer control frames use fixed-width decimal
  ASCII headers;
* CORE PDUs are binary, armored into the ACARS character set with a
  base-85 code (4 bytes -> 5 chars) over an 85-character alphabet;
* the binary PDU is ``[version|type] [flags] [msg numbers] [app id]
  [body] [CRC-32]``, CRC-32 = IEEE 802.3 polynomial (zlib.crc32) over
  everything preceding it, big-endian;
* a compressed body is a raw DEFLATE stream (RFC 1951).

An encoder for every frame/PDU type lives alongside the decoder so the
format is round-trip tested (tests/test_miam.py) and usable for traffic
generation via sim.py.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
from typing import Optional

from .base import JsonObj, ProtoNode, TextOut, hex_str

MIAM_FILE_REASM_TIMEOUT = 600.0    # seconds per in-progress file transfer

# --------------------------------------------------------------- armoring

# 85 printable ACARS-safe characters (no space/control chars); 4 binary
# bytes encode to 5 of these, big-endian base 85.  A final group of n
# bytes (1..3) encodes to n+1 characters.
_B85_ALPHABET = ("0123456789"
                 "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "abcdefghijklmnopqrstuvwxyz"
                 "!\"#$%&'()*+,-./:;<=>?@[")
assert len(_B85_ALPHABET) == 85
_B85_INDEX = {c: i for i, c in enumerate(_B85_ALPHABET)}


def armor(data: bytes) -> str:
    out = []
    for i in range(0, len(data), 4):
        chunk = data[i:i + 4]
        n = len(chunk)
        val = int.from_bytes(chunk, "big")
        group = []
        for _ in range(n + 1):
            group.append(_B85_ALPHABET[val % 85])
            val //= 85
        out.extend(reversed(group))
    return "".join(out)


# char ordinal -> base-85 value; 0xFF marks characters outside the
# alphabet (one C-speed translate call replaces per-char dict lookups)
_B85_TABLE = bytearray([0xFF]) * 256
for _i, _c in enumerate(_B85_ALPHABET):
    _B85_TABLE[ord(_c)] = _i
_B85_TABLE = bytes(_B85_TABLE)


def dearmor(text: str) -> Optional[bytes]:
    try:
        vals = text.encode("latin-1").translate(_B85_TABLE)
    except UnicodeEncodeError:
        return None                   # non-latin char: not armored
    if 0xFF in vals:
        return None                   # char outside the alphabet
    nfull, tail_n = divmod(len(vals), 5)
    if tail_n == 1:
        return None                   # 1-char tail group can't encode
    # full 5-char -> 4-byte groups, vectorized (u64: 85**5 > 2**32)
    if nfull:
        g = np.frombuffer(vals, np.uint8,
                          count=5 * nfull).reshape(-1, 5).astype(np.uint64)
        acc = ((((g[:, 0] * 85 + g[:, 1]) * 85 + g[:, 2]) * 85
                + g[:, 3]) * 85 + g[:, 4])
        if (acc >> np.uint64(32)).any():
            return None               # overlong group
        body = acc.astype(">u4").tobytes()
    else:
        body = b""
    if not tail_n:
        return body
    val = 0
    for v in vals[5 * nfull:]:
        val = val * 85 + v
    n = tail_n - 1
    if val >> (8 * n):
        return None                   # overlong group
    return body + val.to_bytes(n, "big")


# ------------------------------------------------------------- CORE PDUs

PDU_DATA, PDU_ACK, PDU_ALO, PDU_ALR = 0, 1, 2, 3
_PDU_NAMES = {PDU_DATA: "Data", PDU_ACK: "Ack", PDU_ALO: "Aloha",
              PDU_ALR: "Aloha reply"}

APP_TYPE_ACARS, APP_TYPE_NONACARS = 0, 1
_APP_TYPE_NAMES = {APP_TYPE_ACARS: "ACARS 2-character application",
                   APP_TYPE_NONACARS: "non-ACARS 6-character application"}

COMP_NONE, COMP_DEFLATE = 0, 1
_COMP_NAMES = {COMP_NONE: "none", COMP_DEFLATE: "DEFLATE"}

ENC_ISO5, ENC_BINARY = 0, 1
_ENC_NAMES = {ENC_ISO5: "ISO-5 text", ENC_BINARY: "binary"}

ACK_NONE, ACK_REQUESTED = 0, 1


@dataclass
class CorePdu:
    version: int = 1
    pdu_type: int = PDU_DATA
    # Data PDU
    app_type: int = APP_TYPE_ACARS
    compression: int = COMP_NONE
    encoding: int = ENC_ISO5
    ack_option: int = ACK_NONE
    msg_num: int = 0
    msg_ack_num: int = 0              # v2 Data, and Ack PDUs
    app_id: str = ""
    body: bytes = b""
    # Aloha / Aloha reply
    version_mask: int = 0
    max_pdu_len: int = 0
    # decode state
    crc_ok: bool = True
    error: str = ""
    raw_text: str = ""                # original armored text (for the
                                      # labeled fallback dump on error)


def encode_core(pdu: CorePdu) -> str:
    """Binary-encode + armor a CORE PDU (the test/vector generator)."""
    out = bytearray()
    out.append(((pdu.version & 0xF) << 4) | (pdu.pdu_type & 0xF))
    if pdu.pdu_type == PDU_DATA:
        out.append(((pdu.app_type & 3) << 6) | ((pdu.compression & 3) << 4)
                   | ((pdu.encoding & 3) << 2) | (pdu.ack_option & 3))
        out += int(pdu.msg_num).to_bytes(2, "big")
        if pdu.version >= 2:
            out += int(pdu.msg_ack_num).to_bytes(2, "big")
        app_len = 2 if pdu.app_type == APP_TYPE_ACARS else 6
        out += pdu.app_id.encode("latin-1").ljust(app_len, b" ")[:app_len]
        body = pdu.body
        if pdu.compression == COMP_DEFLATE:
            co = zlib.compressobj(9, zlib.DEFLATED, -15)
            body = co.compress(body) + co.flush()
        out += body
    elif pdu.pdu_type == PDU_ACK:
        out += int(pdu.msg_ack_num).to_bytes(2, "big")
        out.append(pdu.ack_option & 0xFF)
    else:                              # Aloha / Aloha reply
        out.append(pdu.version_mask & 0xFF)
        out += int(pdu.max_pdu_len).to_bytes(2, "big")
        out += pdu.body
    out += zlib.crc32(bytes(out)).to_bytes(4, "big")
    return armor(bytes(out))


def decode_core(text: str) -> CorePdu:
    """Dearmor + decode a CORE PDU; never raises (error in .error)."""
    pdu = CorePdu(raw_text=text)
    raw = dearmor(text)
    if raw is None or len(raw) < 5:
        pdu.error = "not a decodable CORE PDU (armoring)"
        return pdu
    crc_want = int.from_bytes(raw[-4:], "big")
    pdu.crc_ok = zlib.crc32(raw[:-4]) == crc_want
    if not pdu.crc_ok:
        # do NOT decode fields from a CRC-failed buffer: text that is
        # not this framework's (reconstructed) CORE profile can still
        # dearmor by accident, and a wrong-but-plausible field decode
        # would be worse than a labeled fallback dump
        pdu.error = "CRC check failed - not a conforming CORE PDU"
        return pdu
    pdu.version = raw[0] >> 4
    pdu.pdu_type = raw[0] & 0xF
    if pdu.version not in (1, 2) or pdu.pdu_type not in _PDU_NAMES:
        pdu.error = (f"unsupported CORE PDU (version {pdu.version}, "
                     f"type {pdu.pdu_type})")
        return pdu
    content = raw[1:-4]
    try:
        if pdu.pdu_type == PDU_DATA:
            flags = content[0]
            pdu.app_type = flags >> 6
            pdu.compression = (flags >> 4) & 3
            pdu.encoding = (flags >> 2) & 3
            pdu.ack_option = flags & 3
            pdu.msg_num = int.from_bytes(content[1:3], "big")
            off = 3
            if pdu.version >= 2:
                pdu.msg_ack_num = int.from_bytes(content[3:5], "big")
                off = 5
            app_len = 2 if pdu.app_type == APP_TYPE_ACARS else 6
            pdu.app_id = content[off:off + app_len].decode(
                "latin-1").rstrip()
            body = bytes(content[off + app_len:])
            if pdu.compression == COMP_DEFLATE:
                body = zlib.decompress(body, -15)
            pdu.body = body
        elif pdu.pdu_type == PDU_ACK:
            pdu.msg_ack_num = int.from_bytes(content[0:2], "big")
            pdu.ack_option = content[2]
        else:
            pdu.version_mask = content[0]
            pdu.max_pdu_len = int.from_bytes(content[1:3], "big")
            pdu.body = bytes(content[3:])
    except (IndexError, zlib.error) as exc:
        pdu.error = f"truncated or corrupt CORE PDU ({exc})"
    return pdu


def _clip(text: str, limit: int = 512) -> str:
    return text if len(text) <= limit else text[:limit] + "..."


class MiamCoreNode(ProtoNode):
    """Decoded MIAM CORE PDU."""
    json_key = "miam_core"

    def __init__(self, pdu: CorePdu) -> None:
        super().__init__()
        self.pdu = pdu

    def _body_text(self) -> Optional[str]:
        p = self.pdu
        if p.encoding == ENC_ISO5 or p.body[:1] in (b"<", b"{"):
            try:
                return p.body.decode("utf-8")
            except UnicodeDecodeError:
                return p.body.decode("latin-1")
        return None

    def format_text(self, out: TextOut, indent: int) -> None:
        p = self.pdu
        if p.error:
            out.iline(indent, f"-- {p.error}")
            if p.raw_text:
                # graceful degradation: real off-the-air MIAM that does
                # not match this framework's reconstructed CORE profile
                # lands here — always show the operator the raw text
                out.iline(indent, f"Undecoded text ({len(p.raw_text)} "
                                  f"chars):")
                out.iline(indent + 1, _clip(p.raw_text))
            return
        out.iline(indent,
                  f"MIAM CORE v{p.version} {_PDU_NAMES[p.pdu_type]} PDU:")
        indent += 1
        if p.pdu_type == PDU_DATA:
            out.iline(indent, f"App type: {_APP_TYPE_NAMES[p.app_type]}")
            out.iline(indent, f"App ID: {p.app_id}")
            out.iline(indent, f"Msg num: {p.msg_num}")
            if p.version >= 2:
                out.iline(indent, f"Msg ack num: {p.msg_ack_num}")
            out.iline(indent,
                      f"Compression: {_COMP_NAMES.get(p.compression, '?')}")
            out.iline(indent, f"Encoding: {_ENC_NAMES.get(p.encoding, '?')}")
            if p.ack_option:
                out.iline(indent, "ACK requested")
            text = self._body_text()
            if text is not None:
                from .acars import _maybe_prettify
                out.iline(indent, "Message:")
                for line in _maybe_prettify(text).split("\n"):
                    out.iline(indent + 1, line)
            else:
                out.iline(indent, f"Data ({len(p.body)} bytes):")
                out.iline(indent + 1, hex_str(p.body))
        elif p.pdu_type == PDU_ACK:
            out.iline(indent, f"Msg ack num: {p.msg_ack_num}")
            out.iline(indent,
                      f"Status: {'ACK' if p.ack_option == 0 else 'NAK'}")
        else:
            out.iline(indent, f"Supported versions mask: 0x{p.version_mask:02x}")
            out.iline(indent, f"Max PDU length: {p.max_pdu_len}")
            if p.body:
                out.iline(indent, f"Options: {hex_str(p.body)}")

    def format_json(self, obj: JsonObj) -> None:
        p = self.pdu
        if p.error:
            obj["err"] = p.error
            if p.raw_text:
                obj["text"] = _clip(p.raw_text)
            return
        obj["version"] = p.version
        obj["pdu_type"] = _PDU_NAMES[p.pdu_type]
        obj["crc_ok"] = p.crc_ok
        if p.pdu_type == PDU_DATA:
            obj["app_type"] = _APP_TYPE_NAMES[p.app_type]
            obj["app_id"] = p.app_id
            obj["msg_num"] = p.msg_num
            if p.version >= 2:
                obj["msg_ack_num"] = p.msg_ack_num
            obj["compression"] = _COMP_NAMES.get(p.compression, "?")
            obj["encoding"] = _ENC_NAMES.get(p.encoding, "?")
            obj["ack_requested"] = bool(p.ack_option)
            text = self._body_text()
            if text is not None:
                obj["msg_text"] = text
            else:
                obj["data"] = p.body.hex()
        elif p.pdu_type == PDU_ACK:
            obj["msg_ack_num"] = p.msg_ack_num
            obj["status"] = "ACK" if p.ack_option == 0 else "NAK"
        else:
            obj["version_mask"] = p.version_mask
            obj["max_pdu_len"] = p.max_pdu_len
            if p.body:
                obj["options"] = p.body.hex()


# ----------------------------------------------------------- frame layer

FRAME_NAMES = {
    "T": "Single Transfer",
    "F": "File Transfer Request",
    "K": "File Transfer Accept",
    "S": "File Segment",
    "A": "File Transfer Abort",
    "Y": "XOFF Indication",
    "X": "XON Indication",
}

_ABORT_REASONS = {
    0: "file transfer aborted by sender",
    1: "file transfer refused",
    2: "reception buffer overflow",
    3: "segment sequence error",
    4: "transfer timeout",
}


class MiamFrameNode(ProtoNode):
    """One MIAM ACARS frame (all seven types)."""
    json_key = "miam"

    def __init__(self, frame_type: str) -> None:
        super().__init__()
        self.frame_type = frame_type
        self.err = ""
        self.file_id: Optional[int] = None
        self.segment_id: Optional[int] = None
        self.file_size: Optional[int] = None
        self.segment_size: Optional[int] = None
        self.complete_by: str = ""
        self.onground: Optional[bool] = None
        self.abort_reason: Optional[int] = None
        self.xoff_all = False
        self.reassembled = False

    def _name(self) -> str:
        return FRAME_NAMES.get(self.frame_type,
                               f"unknown ({self.frame_type!r})")

    def format_text(self, out: TextOut, indent: int) -> None:
        out.iline(indent, f"MIAM frame: {self._name()}"
                  + (" (reassembled)" if self.reassembled else ""))
        indent += 1
        if self.err:
            out.iline(indent, f"-- {self.err}")
            return
        if self.file_id is not None:
            out.iline(indent, f"File ID: {self.file_id}")
        if self.segment_id is not None:
            out.iline(indent, f"Segment: {self.segment_id}")
        if self.file_size is not None:
            out.iline(indent, f"File size: {self.file_size}")
        if self.segment_size is not None:
            out.iline(indent, f"Segment size: {self.segment_size}")
        if self.complete_by:
            t = self.complete_by
            out.iline(indent, "Complete by: "
                      f"{t[0:4]}-{t[4:6]}-{t[6:8]} "
                      f"{t[8:10]}:{t[10:12]}:{t[12:14]} UTC")
        if self.onground is not None:
            out.iline(indent, "Aircraft on ground: "
                      + ("yes" if self.onground else "no"))
        if self.abort_reason is not None:
            reason = _ABORT_REASONS.get(self.abort_reason,
                                        f"reason {self.abort_reason}")
            out.iline(indent, f"Abort reason: {reason}")
        if self.frame_type in ("Y", "X"):
            which = "all file transfers" if self.xoff_all \
                else f"file {self.file_id}"
            verb = "pause" if self.frame_type == "Y" else "resume"
            out.iline(indent, f"Flow control: {verb} {which}")

    def format_json(self, obj: JsonObj) -> None:
        obj["frame_type"] = self._name()
        if self.err:
            obj["err"] = self.err
            return
        obj["decoded"] = True
        if self.file_id is not None:
            obj["file_id"] = self.file_id
        if self.segment_id is not None:
            obj["segment_id"] = self.segment_id
        if self.file_size is not None:
            obj["file_size"] = self.file_size
        if self.segment_size is not None:
            obj["segment_size"] = self.segment_size
        if self.complete_by:
            obj["complete_by"] = self.complete_by
        if self.onground is not None:
            obj["onground"] = self.onground
        if self.abort_reason is not None:
            obj["abort_reason"] = _ABORT_REASONS.get(
                self.abort_reason, str(self.abort_reason))
        if self.reassembled:
            obj["reassembled"] = True
        if self.xoff_all:
            obj["all_files"] = True


# ------------------------------------------------- file transfer reassembly

@dataclass
class _FileXfer:
    segments: dict = None            # segment_id -> armored text chunk
    expected_size: int = -1          # announced file size (armored chars)
    first_seen: float = 0.0

    def __post_init__(self):
        if self.segments is None:
            self.segments = {}


class MiamFileReasm:
    """Per-station file-transfer segment collector.

    Keyed on (registration, file_id); the transfer-request frame
    announces the file size, file-segment frames deliver numbered
    chunks of the armored CORE PDU, and the reassembled PDU decodes
    once every announced byte has arrived (the reference gets this from
    libacars' MIAM reassembly, NEWS.md:173-179).
    """

    def __init__(self) -> None:
        self.xfers: dict = {}

    def _expire(self, now: float) -> None:
        dead = [k for k, x in self.xfers.items()
                if now - x.first_seen > MIAM_FILE_REASM_TIMEOUT]
        for k in dead:
            del self.xfers[k]

    def request(self, key, file_size: int, now: float) -> None:
        self._expire(now)
        self.xfers[key] = _FileXfer(expected_size=file_size,
                                    first_seen=now)

    def abort(self, key) -> None:
        self.xfers.pop(key, None)

    def segment(self, key, segment_id: int, chunk: str,
                now: float) -> Optional[str]:
        """Returns the full armored PDU when the transfer completes."""
        self._expire(now)
        xfer = self.xfers.get(key)
        # per-key staleness at access (see proto/reasm.py): decisions
        # depend only on this transfer's own timestamps
        if xfer is not None \
                and now - xfer.first_seen > MIAM_FILE_REASM_TIMEOUT:
            del self.xfers[key]
            xfer = None
        if xfer is None:
            xfer = _FileXfer(first_seen=now)
            self.xfers[key] = xfer
        xfer.segments[segment_id] = chunk
        if xfer.expected_size < 0:
            return None
        have = sum(len(s) for s in xfer.segments.values())
        if have < xfer.expected_size:
            return None
        ordered = [xfer.segments[k] for k in sorted(xfer.segments)]
        del self.xfers[key]
        return "".join(ordered)


def _file_reasm(reasm_ctx) -> Optional[MiamFileReasm]:
    if reasm_ctx is None:
        return None
    tbl = getattr(reasm_ctx, "_miam_files", None)
    if tbl is None:
        tbl = MiamFileReasm()
        reasm_ctx._miam_files = tbl
    return tbl


# ---------------------------------------------------------------- parsing

def _int_field(txt: str, start: int, width: int) -> Optional[int]:
    part = txt[start:start + width]
    return int(part) if len(part) == width and part.isdigit() else None


def miam_parse(txt: str, reg: str = "", reasm_ctx=None,
               rx_time: float = 0.0) -> Optional[MiamFrameNode]:
    """Parse one MIAM ACARS frame (text after the ACARS prelude)."""
    if not txt:
        return None
    ftype = txt[0]
    if ftype not in FRAME_NAMES:
        return None
    node = MiamFrameNode(ftype)
    rest = txt[1:]
    if ftype == "T":
        node.next = MiamCoreNode(decode_core(rest))
        return node
    if ftype == "F":
        node.file_id = _int_field(rest, 0, 2)
        node.file_size = _int_field(rest, 2, 6)
        t = rest[8:22]
        if len(t) == 14 and t.isdigit():
            node.complete_by = t
        if node.file_id is None or node.file_size is None:
            node.err = "unparseable file transfer request"
            return node
        tbl = _file_reasm(reasm_ctx)
        if tbl is not None:
            tbl.request((reg, node.file_id), node.file_size, rx_time)
        return node
    if ftype == "K":
        node.file_id = _int_field(rest, 0, 2)
        flag = rest[2:3]
        node.onground = {"G": True, "A": False}.get(flag)
        node.segment_size = _int_field(rest, 3, 4)
        if node.file_id is None or node.segment_size is None:
            node.err = "unparseable file transfer accept"
        return node
    if ftype == "S":
        node.file_id = _int_field(rest, 0, 2)
        node.segment_id = _int_field(rest, 2, 3)
        if node.file_id is None or node.segment_id is None:
            node.err = "unparseable file segment"
            return node
        tbl = _file_reasm(reasm_ctx)
        if tbl is not None:
            full = tbl.segment((reg, node.file_id), node.segment_id,
                               rest[5:], rx_time)
            if full is not None:
                node.reassembled = True
                node.next = MiamCoreNode(decode_core(full))
        return node
    if ftype == "A":
        node.file_id = _int_field(rest, 0, 2)
        node.abort_reason = _int_field(rest, 2, 1)
        if node.file_id is None:
            node.err = "unparseable file transfer abort"
            return node
        tbl = _file_reasm(reasm_ctx)
        if tbl is not None:
            tbl.abort((reg, node.file_id))
        return node
    # Y / X flow control
    if rest[:3] == "ALL":
        node.xoff_all = True
    else:
        node.file_id = _int_field(rest, 0, 2)
        if node.file_id is None:
            node.err = "unparseable flow control frame"
    return node


# ----------------------------------------------------- encode (frame layer)

def encode_single_transfer(pdu: CorePdu) -> str:
    return "T" + encode_core(pdu)


def encode_file_transfer(pdu: CorePdu, file_id: int, seg_chars: int,
                         complete_by: str = "20260101000000"):
    """Split a CORE PDU into request + numbered segment frames."""
    armored = encode_core(pdu)
    frames = [f"F{file_id:02d}{len(armored):06d}{complete_by}"]
    seg = 1
    for i in range(0, len(armored), seg_chars):
        frames.append(f"S{file_id:02d}{seg:03d}" + armored[i:i + seg_chars])
        seg += 1
    return frames
