"""Protocol-tree framework.

Functional equivalent of libacars' ``la_proto_node`` /
``la_type_descriptor`` machinery that every reference parser builds on
(e.g. avlc.c:442-447): each protocol layer contributes one node with
text/JSON renderers, nodes chain via ``next`` (one space of indentation
per nesting level in text output), and unparseable payloads terminate
the chain with a hexdump node.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional


# Precomputed indent strings: " " * n in every iline call is ~5% of
# bulk-replay formatting time (profiled); deep trees fall back.
_INDENTS = tuple(" " * n for n in range(48))


class TextOut:
    """Indented text accumulator (la_vstring + LA_ISPRINTF equivalent)."""

    def __init__(self) -> None:
        self._parts: list[str] = []

    def append(self, text: str) -> None:
        self._parts.append(text)

    def iappend(self, indent: int, text: str) -> None:
        pad = _INDENTS[indent] if indent < 48 else " " * indent
        self._parts.append(pad + text)

    def iline(self, indent: int, text: str) -> None:
        pad = _INDENTS[indent] if indent < 48 else " " * indent
        self._parts.append(pad + text + "\n")

    def multiline(self, indent: int, text: str) -> None:
        """Indent every non-empty line of a multi-line string."""
        pad = _INDENTS[indent] if indent < 48 else " " * indent
        for line in text.split("\n"):
            if line:
                self._parts.append(pad + line + "\n")

    def getvalue(self) -> str:
        return "".join(self._parts)


class JsonObj(dict):
    """Ordered JSON object; insertion order mirrors the reference output."""


class ProtoNode:
    """One decoded protocol layer. Subclasses implement the renderers."""

    json_key: str = "unknown"

    def __init__(self) -> None:
        self.next: Optional[ProtoNode] = None

    # -- renderers -------------------------------------------------------
    def format_text(self, out: TextOut, indent: int) -> None:
        raise NotImplementedError

    def format_json(self, obj: JsonObj) -> None:
        raise NotImplementedError


def tree_format_text(out: TextOut, node: Optional[ProtoNode],
                     indent: int = 0) -> None:
    while node is not None:
        node.format_text(out, indent)
        node = node.next
        indent += 1


def tree_format_json(node: Optional[ProtoNode]) -> JsonObj:
    """Render the chain as nested objects keyed by each node's json_key."""
    root = JsonObj()
    obj = root
    while node is not None:
        inner = JsonObj()
        node.format_json(inner)
        obj[node.json_key] = inner
        obj = inner
        node = node.next
    return root


def json_dumps(obj: Any) -> str:
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False)


# ----------------------------------------------------------------- helpers

def hex_str(data: bytes) -> str:
    """Single-line lowercase hex with single-space separators."""
    if len(data) == 0:
        return "none"
    return bytes(data).hex(" ")


_PRINTABLE = bytes(i if 32 <= i <= 126 else 0x2E for i in range(256))


def printable(data: bytes) -> str:
    return bytes(data).translate(_PRINTABLE).decode("ascii")


def hexdump(data: bytes) -> str:
    """Classic 16-byte-per-row hex+ASCII dump (util.c:233-284 layout)."""
    if data is None:
        return "<undef>"
    if len(data) == 0:
        return "<none>"
    rows = []
    for i in range(0, len(data), 16):
        chunk = data[i:i + 16]
        hexpart = []
        asciipart = []
        for j in range(16):
            if j < len(chunk):
                hexpart.append(f"{chunk[j]:02x} ")
                asciipart.append(chr(chunk[j])
                                 if 32 <= chunk[j] <= 126 else ".")
            else:
                hexpart.append("   ")
                asciipart.append(" ")
            if j == 7:
                hexpart.append(" ")
                asciipart.append(" ")
        rows.append("".join(hexpart) + " |" + "".join(asciipart) + "|\n")
    return "".join(rows)


def octet_string_format_text(out: TextOut, data: bytes, indent: int) -> None:
    out.iappend(indent, hex_str(data))


def octet_string_with_ascii_format_text(out: TextOut, data: bytes,
                                        indent: int) -> None:
    out.iappend(indent, f'{hex_str(data)}\t"{printable(data)}"')


class UnknownProtoNode(ProtoNode):
    """Hexdump of an unparseable PDU (util.c unknown_proto)."""
    json_key = "unknown_proto"

    def __init__(self, data: bytes) -> None:
        super().__init__()
        self.data = bytes(data)

    def format_text(self, out: TextOut, indent: int) -> None:
        if not self.data:
            return
        out.iline(indent, f"Data ({len(self.data)} bytes):")
        octet_string_format_text(out, self.data, indent + 1)
        out.append("\n")

    def format_json(self, obj: JsonObj) -> None:
        obj["data"] = self.data.hex()


@dataclass
class BitfieldEntry:
    bit: int            # mask value
    name: str


def bitfield_format_text(out: TextOut, value: int,
                         table: list[tuple[int, str]]) -> None:
    names = [name for mask, name in table if value & mask]
    out.append(", ".join(names) if names else "none")


def bitfield_format_json(obj: JsonObj, key: str, value: int,
                         table: list[tuple[int, str]]) -> None:
    obj[key] = [name for mask, name in table if value & mask]


def dict_search(table: dict[int, str], key: int) -> Optional[str]:
    return table.get(key)
