"""Generic dictionary-driven TLV parser.

Python counterpart of the reference's tlv.c engine: a tag table maps
type codes to descriptors with parse/format hooks; unknown tags fall
back to a hexdump entry, tags whose parser rejects the value fall back
to an "unparseable" entry.  Supports 1- and 2-octet length fields
(XID public/private parameter groups use both).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from .base import JsonObj, TextOut, hex_str, printable

# sentinel for boolean tags that carry no value
NO_VALUE = object()

TextFormatter = Callable[[TextOut, int, str, Any], None]
JsonFormatter = Callable[[Any], Any]


@dataclass
class TlvTypeDescriptor:
    label: str
    json_key: Optional[str] = None
    parse: Callable[[int, bytes], Any] = lambda code, buf: bytes(buf)
    format_text: Optional[TextFormatter] = None
    format_json: Optional[JsonFormatter] = None


@dataclass
class TlvTag:
    typecode: int
    td: TlvTypeDescriptor
    data: Any


# ------------------------------------------------------------ stock parsers

def parse_octet_string(code: int, buf: bytes) -> bytes:
    return bytes(buf)


def parse_uint8(code: int, buf: bytes) -> Optional[int]:
    return buf[0] if len(buf) >= 1 else None


def parse_uint16_msbfirst(code: int, buf: bytes) -> Optional[int]:
    return (buf[0] << 8) | buf[1] if len(buf) >= 2 else None


def parse_uint32_msbfirst(code: int, buf: bytes) -> Optional[int]:
    if len(buf) < 4:
        return None
    return (buf[0] << 24) | (buf[1] << 16) | (buf[2] << 8) | buf[3]


def parse_noop(code: int, buf: bytes) -> Any:
    return NO_VALUE


# ---------------------------------------------------------- stock text fmts

def fmt_octet_string(out: TextOut, indent: int, label: str, data: bytes) -> None:
    out.iline(indent, f"{label}: {hex_str(data)}")


def fmt_octet_string_with_ascii(out: TextOut, indent: int, label: str,
                                data: bytes) -> None:
    out.iline(indent, f'{label}: {hex_str(data)}\t"{printable(data)}"')


def fmt_octet_string_as_ascii(out: TextOut, indent: int, label: str,
                              data: bytes) -> None:
    out.iline(indent, f"{label}: {printable(data)}")


def fmt_single_octet(out: TextOut, indent: int, label: str,
                     data: bytes) -> None:
    prefix = "0x" if len(data) == 1 else ""
    out.iline(indent, f"{label}: {prefix}{hex_str(data)}")


def fmt_uint(out: TextOut, indent: int, label: str, data: int) -> None:
    out.iline(indent, f"{label}: {data}")


def json_octet_string(data: bytes) -> Any:
    return data.hex()


def json_ascii(data: bytes) -> Any:
    return printable(data)


def json_uint(data: int) -> Any:
    return data


UNKNOWN_TAG = TlvTypeDescriptor(label="Unknown tag", json_key=None)
UNPARSEABLE_TAG = TlvTypeDescriptor(label="Unparseable tag",
                                    json_key="__unparseable_tlv_tag")


def single_tag_parse(typecode: int, buf: bytes,
                     table: dict[int, TlvTypeDescriptor],
                     tags: list[TlvTag]) -> list[TlvTag]:
    td = table.get(typecode)
    if td is None:
        tags.append(TlvTag(typecode, UNKNOWN_TAG, bytes(buf)))
        return tags
    parsed = td.parse(typecode, buf)
    if parsed is None:
        tags.append(TlvTag(typecode, UNPARSEABLE_TAG, bytes(buf)))
        return tags
    tags.append(TlvTag(typecode, td, parsed))
    return tags


def tlv_parse(buf: bytes, table: dict[int, TlvTypeDescriptor],
              len_octets: int) -> Optional[list[TlvTag]]:
    """Parse a whole TLV sequence; None on structural error."""
    tags: list[TlvTag] = []
    pos, end = 0, len(buf)
    min_len = 1 + len_octets
    while end - pos >= min_len:
        typecode = buf[pos]
        pos += 1
        tag_len = buf[pos]
        if len_octets == 2:
            tag_len = (tag_len << 8) | buf[pos + 1]
        pos += len_octets
        if tag_len > end - pos or tag_len == 0:
            return None
        tags = single_tag_parse(typecode, buf[pos:pos + tag_len], table, tags)
        pos += tag_len
    return tags


def tlv_list_format_text(out: TextOut, tags: Optional[list[TlvTag]],
                         indent: int) -> None:
    if not tags:
        return
    for tag in tags:
        if tag.td is UNKNOWN_TAG:
            out.iline(indent, "-- Unknown TLV (code: 0x%02x): %s" % (
                tag.typecode, hex_str(tag.data)))
        elif tag.td is UNPARSEABLE_TAG:
            out.iline(indent, "-- Unparseable TLV (code: 0x%02x): %s" % (
                tag.typecode, hex_str(tag.data)))
        elif tag.data is NO_VALUE:
            out.iline(indent, tag.td.label)
        elif tag.td.format_text is not None:
            tag.td.format_text(out, indent, tag.td.label, tag.data)


def tlv_list_format_json(tags: Optional[list[TlvTag]]) -> list:
    arr = []
    if not tags:
        return arr
    for tag in tags:
        if tag.td is UNKNOWN_TAG:
            continue
        if tag.td is UNPARSEABLE_TAG:
            arr.append(JsonObj(name="__unparseable_tlv_tag",
                               value=JsonObj(typecode=tag.typecode,
                                             data=tag.data.hex())))
            continue
        if tag.td.format_json is None and tag.data is not NO_VALUE:
            continue
        value = JsonObj() if tag.data is NO_VALUE else \
            tag.td.format_json(tag.data)
        arr.append(JsonObj(name=tag.td.json_key, value=value))
    return arr


def tlv_list_search(tags: Optional[list[TlvTag]], typecode: int
                    ) -> Optional[TlvTag]:
    for tag in tags or []:
        if tag.typecode == typecode:
            return tag
    return None
