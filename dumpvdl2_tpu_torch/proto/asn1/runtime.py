"""Schema-interpreting unaligned-PER codec (X.691).

Replaces the asn1c-generated UPER runtime the reference links
(reference: src/asn1/per_support.c, constr_SEQUENCE.c, constr_CHOICE.c,
INTEGER.c, OCTET_STRING.c, NativeEnumerated.c).  Where X.691 leaves
room (and where asn1c deviates), this implementation mirrors asn1c's
observable behavior, because the ATN B1 peers the reference decodes
were themselves built on the same interpretation — e.g. the
normally-small-non-negative-whole-number >63 path and constrained
character translation (OCTET_STRING.c:OCTET_STRING_per_get_characters,
per_support.c:uper_get_nsnnwn).

Decoded value mapping:
  SEQUENCE -> dict (absent optional members omitted)
  CHOICE   -> ("altname", value)
  ENUMERATED -> label str (unknown extension -> int index)
  INTEGER -> int, BOOLEAN -> bool, NULL -> None
  OCTET STRING / open type -> bytes
  BIT STRING -> (bytes, nbits)
  character strings -> str
  SEQUENCE OF -> list
  OBJECT IDENTIFIER -> tuple of arcs
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

from .ir import Constraint, Node, Schema


class UperDecodeError(ValueError):
    pass


def _range_bits(lb: int, ub: int) -> int:
    rng = ub - lb + 1
    if rng <= 1:
        return 0
    return (rng - 1).bit_length()


class BitReader:
    # PDUs decoded here are small (ICAO APDUs are at most a few
    # hundred octets), so the whole buffer is folded into ONE Python
    # int at construction and every bits() is a single shift+mask —
    # profiled ~2x over the per-call slice + from_bytes approach.
    # Buffers above the threshold (pathological inputs) keep the
    # slice path so per-read cost never scales with buffer size.
    _INT_CACHE_MAX = 4096             # octets

    def __init__(self, buf: bytes, nbits: Optional[int] = None):
        self.buf = buf
        self.pos = 0
        self.nbits = len(buf) * 8 if nbits is None else nbits
        if len(buf) <= self._INT_CACHE_MAX:
            self._val = int.from_bytes(buf, "big")
            self._endbits = len(buf) * 8
        else:
            self._val = None
            self._endbits = 0

    def remaining(self) -> int:
        return self.nbits - self.pos

    def bits(self, n: int) -> int:
        pos = self.pos
        end = pos + n
        if n < 0 or end > self.nbits:
            raise UperDecodeError(
                f"starved: want {n} bits at {self.pos}/{self.nbits}")
        self.pos = end
        if self._val is not None:
            return (self._val >> (self._endbits - end)) & ((1 << n) - 1)
        first = pos >> 3
        chunk = int.from_bytes(self.buf[first:(end + 7) >> 3], "big")
        # bits [pos-8*first, ...+n) of the chunk, MSB first
        total = (((end + 7) >> 3) - first) * 8
        return (chunk >> (total - (end - 8 * first))) & ((1 << n) - 1)

    def bytes_(self, n: int) -> bytes:
        if (self.pos & 7) == 0:   # byte-aligned fast path
            if self.pos + 8 * n > self.nbits:
                raise UperDecodeError("starved reading octets")
            start = self.pos >> 3
            out = self.buf[start:start + n]
            self.pos += 8 * n
            return bytes(out)
        if n <= 512:
            return self.bits(8 * n).to_bytes(n, "big")
        return bytes(self.bits(8) for _ in range(n))


class BitWriter:
    def __init__(self) -> None:
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def bits(self, value: int, n: int) -> None:
        if n == 0:
            return
        if value < 0 or value >> n:
            raise ValueError(f"value {value} does not fit in {n} bits")
        self.acc = (self.acc << n) | value
        self.n += n
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def bytes_(self, data: bytes) -> None:
        for b in data:
            self.bits(b, 8)

    def getvalue(self) -> bytes:
        if self.n:
            return bytes(self.out) + bytes([(self.acc << (8 - self.n))
                                            & 0xFF])
        return bytes(self.out)

    def bit_length(self) -> int:
        return len(self.out) * 8 + self.n


# ------------------------------------------------------------- lengths

def _get_length(rd: BitReader) -> Tuple[int, bool]:
    """Unconstrained length determinant -> (length, is_fragment)."""
    v = rd.bits(8)
    if (v & 0x80) == 0:
        return v & 0x7F, False
    if (v & 0x40) == 0:
        return ((v & 0x3F) << 8) | rd.bits(8), False
    m = v & 0x3F
    if not 1 <= m <= 4:
        raise UperDecodeError("bad length fragment multiplier")
    return 16384 * m, True


def _put_length(wr: BitWriter, n: int) -> None:
    if n <= 0x7F:
        wr.bits(n, 8)
    elif n < 16384:
        wr.bits(0x8000 | n, 16)
    else:
        raise NotImplementedError("fragmented encode not supported")


def _get_nsnnwn(rd: BitReader) -> int:
    """Normally small non-negative whole number, asn1c-compatible
    (per_support.c:uper_get_nsnnwn)."""
    v = rd.bits(7)
    if v & 0x40:
        v = ((v & 0x3F) << 2) | rd.bits(2)
        if v == 0:
            return 0
        if v >= 3:
            raise UperDecodeError("unsupported nsnnwn size")
        return rd.bits(8 * v)
    return v


def _put_nsnnwn(wr: BitWriter, v: int) -> None:
    if v < 64:
        wr.bits(v, 7)
    else:
        raise NotImplementedError("large nsnnwn encode not supported")


def _get_nslength(rd: BitReader) -> int:
    if rd.bits(1) == 0:
        return rd.bits(6) + 1
    n, frag = _get_length(rd)
    if frag:
        raise UperDecodeError("fragmented nslength")
    return n


def _put_nslength(wr: BitWriter, n: int) -> None:
    if 1 <= n <= 64:
        wr.bits(0, 1)
        wr.bits(n - 1, 6)
    else:
        wr.bits(1, 1)
        _put_length(wr, n)


def _get_open_type(rd: BitReader) -> bytes:
    out = b""
    while True:
        n, frag = _get_length(rd)
        out += rd.bytes_(n)
        if not frag:
            return out


def _put_open_type(wr: BitWriter, data: bytes) -> None:
    _put_length(wr, len(data))
    wr.bytes_(data)


# -------------------------------------------------------------- decode

def _c(c: Constraint):
    """(extensible, lb, ub) -> (ext, lb, ub) with None handling."""
    if c is None:
        return False, None, None
    return c


def _decode_int(rd: BitReader, c: Constraint) -> int:
    ext, lb, ub = _c(c)
    if ext:
        if rd.bits(1):
            lb = ub = None            # escape to unconstrained
    if lb is not None and ub is not None:
        return lb + rd.bits(_range_bits(lb, ub))
    n, frag = _get_length(rd)
    if frag:
        raise UperDecodeError("fragmented integer")
    data = rd.bytes_(n)
    if lb is not None:                # semi-constrained
        return lb + int.from_bytes(data, "big")
    return int.from_bytes(data, "big", signed=True)


def _decode_size(rd: BitReader, c: Constraint) -> Tuple[int, bool]:
    """Decode a size determinant -> (count, fragmented)."""
    ext, lb, ub = _c(c)
    if ext:
        if rd.bits(1):
            lb = ub = None
    if lb is not None and ub is not None and ub < 65536:
        if lb == ub:
            return lb, False
        return lb + rd.bits(_range_bits(lb, ub)), False
    return _get_length(rd)


def _decode_charstr(rd: BitReader, alpha, size: Constraint) -> str:
    if alpha is not None and alpha[0] == "tab":
        tab = alpha[1]
        bits = _range_bits(0, len(tab) - 1) or 1
        decode_ch = lambda: chr(tab[rd.bits(bits)])
    else:
        _, lo, hi = _c(alpha)
        if lo is None:
            lo, hi = 0, 127
        bits = _range_bits(lo, hi) or 1
        # asn1c: no translation when ub fits the bit width directly
        if hi < (1 << bits):
            lo = 0
        base = lo
        decode_ch = lambda: chr(base + rd.bits(bits))
    out: List[str] = []
    while True:
        n, frag = _decode_size(rd, size)
        for _ in range(n):
            out.append(decode_ch())
        if not frag:
            return "".join(out)


def _decode_octstr(rd: BitReader, size: Constraint) -> bytes:
    out = b""
    while True:
        n, frag = _decode_size(rd, size)
        out += rd.bytes_(n)
        if not frag:
            return out


def _decode_bitstr(rd: BitReader, size: Constraint) -> Tuple[bytes, int]:
    nbits = 0
    data = bytearray()
    while True:
        n, frag = _decode_size(rd, size)
        if n:
            if nbits & 7:
                # fragment boundary not byte-aligned — UPER fragments
                # are 16K-bit multiples so this only happens on
                # malformed input; bit-shift concat keeps it correct
                total = nbits + n
                acc = (int.from_bytes(data, "big")
                       >> ((8 * len(data) - nbits) & 7)) if data else 0
                acc = (acc << n) | rd.bits(n)
                pad = (8 - (total & 7)) & 7
                data = bytearray(
                    (acc << pad).to_bytes((total + 7) // 8, "big"))
                nbits = total
            else:
                # bulk path: one big-int read instead of n 1-bit reads
                val = rd.bits(n)
                nb = (n + 7) // 8
                data += (val << (8 * nb - n)).to_bytes(nb, "big")
                nbits += n
        if not frag:
            break
    return bytes(data), nbits


def _decode_oid(rd: BitReader, relative: bool = False) -> Tuple[int, ...]:
    n, frag = _get_length(rd)
    if frag:
        raise UperDecodeError("fragmented OID")
    data = rd.bytes_(n)
    arcs: List[int] = []
    v = 0
    for i, b in enumerate(data):
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            if not arcs and not relative:
                arcs.extend((min(v // 40, 2), v - 40 * min(v // 40, 2)))
            else:
                arcs.append(v)
            v = 0
    return tuple(arcs)


def decode(schema: Schema, ref: str, rd, mc=None) -> Any:
    """Decode one value of type ``ref``.  ``rd`` may be bytes or a
    BitReader (for recursive calls).  ``mc`` is an optional member-level
    constraint pair (value_constraint, size_constraint) overriding the
    type's own (asn1c: elm->per_constraints)."""
    if isinstance(rd, (bytes, bytearray, memoryview)):
        rd = BitReader(bytes(rd))
    node = schema.resolve(ref)
    return _decode_node(schema, node, rd, mc)


def _decode_node(schema: Schema, node: Node, rd: BitReader,
                 mc=None) -> Any:
    vc = mc[0] if mc else None
    sc = mc[1] if mc else None
    kind = node[0]
    if kind == "null":
        return None
    if kind == "bool":
        return bool(rd.bits(1))
    if kind == "int":
        return _decode_int(rd, vc or node[1])
    if kind == "enum":
        _, items, root_count, extensible = node
        if extensible and rd.bits(1):
            idx = _get_nsnnwn(rd) + root_count
        else:
            idx = rd.bits(_range_bits(0, root_count - 1))
            if idx >= root_count:
                raise UperDecodeError("enum index out of root range")
        if idx < len(items):
            return items[idx][1]
        return idx                     # unknown extension value
    if kind == "octstr":
        return _decode_octstr(rd, sc or node[1])
    if kind == "bitstr":
        return _decode_bitstr(rd, sc or node[1])
    if kind == "charstr":
        return _decode_charstr(rd, vc or node[1], sc or node[2])
    if kind == "oid":
        return _decode_oid(rd)
    if kind == "roid":
        return _decode_oid(rd, relative=True)
    if kind == "any":
        return _get_open_type(rd)
    if kind == "rest":
        # Consume every remaining bit ("unparsed tail"): used for FANS
        # message-element arguments whose types are not modelled yet.
        # Returns (bytes, nbits) like a BIT STRING.
        n = rd.remaining()
        data = bytes((rd.bits(min(8, n - i)) << max(0, 8 - (n - i))) & 0xFF
                     for i in range(0, n, 8)) if n else b""
        return (data, n)
    if kind == "alias":
        _, base, avc, asc = node
        basenode = schema.resolve(base)
        if basenode[0] == "charstr":
            return _decode_charstr(rd, vc or avc or basenode[1],
                                   sc or asc or basenode[2])
        if basenode[0] == "int":
            return _decode_int(rd, vc or avc or basenode[1])
        if basenode[0] == "octstr":
            return _decode_octstr(rd, sc or asc or basenode[1])
        if basenode[0] == "bitstr":
            return _decode_bitstr(rd, sc or asc or basenode[1])
        return _decode_node(schema, basenode, rd)
    if kind == "seqof":
        _, elem, size = node
        elemnode = schema.resolve(elem)
        out = []
        while True:
            n, frag = _decode_size(rd, sc or size)
            for _ in range(n):
                out.append(_decode_node(schema, elemnode, rd))
            if not frag:
                return out
    if kind == "seq":
        return _decode_seq(schema, node, rd)
    if kind == "choice":
        return _decode_choice(schema, node, rd)
    raise UperDecodeError(f"unhandled IR kind {kind}")


def _seq_split(schema: Schema, node: Node):
    """Per-schema memo of a seq node's root/extension split with the
    root members' type references pre-resolved.  Keyed by id(node);
    the entry keeps a strong reference to the node, so the id can
    never be recycled while the cache lives (and the cache lives
    exactly as long as its schema)."""
    try:
        cache = schema._seq_cache
    except AttributeError:
        cache = schema._seq_cache = {}
    ent = cache.get(id(node))
    if ent is None or ent[0] is not node:
        _, members, ext_after = node
        extensible = ext_after >= 0
        root = [m for i, m in enumerate(members)
                if not (extensible and i > ext_after)]
        exts = [m for i, m in enumerate(members)
                if extensible and i > ext_after]
        rootres = tuple(
            (name, schema.resolve(tref), optional, mc, dfl)
            for name, tref, optional, mc, dfl in root)
        ent = (node, extensible, rootres, tuple(exts))
        cache[id(node)] = ent
    return ent


def _decode_seq(schema: Schema, node: Node, rd: BitReader) -> dict:
    _node, extensible, root, exts = _seq_split(schema, node)
    ext_present = bool(rd.bits(1)) if extensible else False
    presence = {}
    for name, _tnode, optional, _mc, _dfl in root:
        if optional:
            presence[name] = bool(rd.bits(1))
    out: dict = {}
    for name, tnode, optional, mc, dfl in root:
        if optional and not presence[name]:
            if dfl is not None:
                out[name] = dfl
            continue
        out[name] = _decode_node(schema, tnode, rd, mc)
    if ext_present:
        bmlen = _get_nslength(rd)
        bitmap = [rd.bits(1) for _ in range(bmlen)]
        for i, present in enumerate(bitmap):
            if not present:
                continue
            blob = _get_open_type(rd)
            if i < len(exts):
                name, tref, _opt, mc, _dfl = exts[i]
                try:
                    out[name] = decode(schema, tref, blob, mc)
                except UperDecodeError:
                    out[name] = blob
            else:
                out.setdefault("_unknown_extensions", []).append(blob)
    return out


def _alt(alts, j):
    a = alts[j]
    return (a[0], a[1], a[2] if len(a) > 2 else None)


def _decode_choice(schema: Schema, node: Node, rd: BitReader
                   ) -> Tuple[Any, Any]:
    _, alts, root_count, extensible = node
    if extensible and rd.bits(1):
        idx = _get_nsnnwn(rd)
        blob = _get_open_type(rd)
        j = root_count + idx
        if j < len(alts):
            name, tref, mc = _alt(alts, j)
            try:
                return name, decode(schema, tref, blob, mc)
            except UperDecodeError:
                return name, blob
        return f"_ext{idx}", blob
    idx = rd.bits(_range_bits(0, root_count - 1)) if root_count > 1 else 0
    if idx >= root_count:
        raise UperDecodeError("choice index out of range")
    name, tref, mc = _alt(alts, idx)
    return name, _decode_node(schema, schema.resolve(tref), rd, mc)


# -------------------------------------------------------------- encode

def encode(schema: Schema, ref: str, value: Any,
           wr: Optional[BitWriter] = None, mc=None) -> bytes:
    top = wr is None
    if top:
        wr = BitWriter()
    node = schema.resolve(ref)
    _encode_node(schema, node, value, wr, mc)
    if top:
        out = wr.getvalue()
        return out if out else b"\x00"   # X.691: empty encoding -> 1 octet
    return b""


def _encode_int(wr: BitWriter, v: int, c: Constraint) -> None:
    ext, lb, ub = _c(c)
    if ext:
        inside = lb is not None and ub is not None and lb <= v <= ub
        wr.bits(0 if inside else 1, 1)
        if not inside:
            lb = ub = None
    if lb is not None and ub is not None:
        wr.bits(v - lb, _range_bits(lb, ub))
        return
    if lb is not None:
        off = v - lb
        data = off.to_bytes(max(1, (off.bit_length() + 7) // 8), "big")
    else:
        nbytes = max(1, (v.bit_length() + 8) // 8)
        data = v.to_bytes(nbytes, "big", signed=True)
    _put_length(wr, len(data))
    wr.bytes_(data)


def _encode_size(wr: BitWriter, n: int, c: Constraint) -> None:
    ext, lb, ub = _c(c)
    if ext:
        inside = lb is not None and ub is not None and lb <= n <= ub
        wr.bits(0 if inside else 1, 1)
        if not inside:
            lb = ub = None
    if lb is not None and ub is not None and ub < 65536:
        if lb != ub:
            wr.bits(n - lb, _range_bits(lb, ub))
        return
    _put_length(wr, n)


def _encode_node(schema: Schema, node: Node, v: Any, wr: BitWriter,
                 mc=None) -> None:
    vc = mc[0] if mc else None
    sc = mc[1] if mc else None
    kind = node[0]
    if kind == "null":
        return
    if kind == "bool":
        wr.bits(1 if v else 0, 1)
        return
    if kind == "int":
        _encode_int(wr, v, vc or node[1])
        return
    if kind == "enum":
        _, items, root_count, extensible = node
        if isinstance(v, str):
            idx = next(i for i, (_val, lbl) in enumerate(items) if lbl == v)
        else:
            idx = int(v)
        if idx < root_count:
            if extensible:
                wr.bits(0, 1)
            wr.bits(idx, _range_bits(0, root_count - 1))
        else:
            wr.bits(1, 1)
            _put_nsnnwn(wr, idx - root_count)
        return
    if kind == "octstr":
        _encode_size(wr, len(v), sc or node[1])
        wr.bytes_(v)
        return
    if kind == "bitstr":
        data, nbits = v
        _encode_size(wr, nbits, sc or node[1])
        for i in range(nbits):
            wr.bits((data[i >> 3] >> (7 - (i & 7))) & 1, 1)
        return
    if kind == "charstr":
        _, alpha, size = node
        alpha = vc or alpha
        size = sc or size
        if alpha is not None and alpha[0] == "tab":
            tab = alpha[1]
            bits = _range_bits(0, len(tab) - 1) or 1
            code = {chr(c): i for i, c in enumerate(tab)}
            _encode_size(wr, len(v), size)
            for ch in v:
                wr.bits(code[ch], bits)
            return
        _, lo, hi = _c(alpha)
        if lo is None:
            lo, hi = 0, 127
        bits = _range_bits(lo, hi) or 1
        if hi < (1 << bits):
            lo = 0
        _encode_size(wr, len(v), size)
        for ch in v:
            wr.bits(ord(ch) - lo, bits)
        return
    if kind in ("oid", "roid"):
        arcs = list(v)
        body = bytearray()
        vals = (arcs if kind == "roid"
                else [arcs[0] * 40 + arcs[1]] + arcs[2:])
        for val in vals:
            tmp = [val & 0x7F]
            val >>= 7
            while val:
                tmp.append(0x80 | (val & 0x7F))
                val >>= 7
            body.extend(reversed(tmp))
        _put_length(wr, len(body))
        wr.bytes_(bytes(body))
        return
    if kind == "any":
        _put_open_type(wr, v)
        return
    if kind == "rest":
        data, nbits = v
        for i in range(nbits):
            wr.bits((data[i >> 3] >> (7 - (i & 7))) & 1, 1)
        return
    if kind == "alias":
        _, base, avc, asc = node
        basenode = schema.resolve(base)
        if basenode[0] == "charstr":
            _encode_node(schema, ("charstr", vc or avc or basenode[1],
                                  sc or asc or basenode[2]), v, wr)
        elif basenode[0] == "int":
            _encode_int(wr, v, vc or avc or basenode[1])
        elif basenode[0] == "octstr":
            _encode_node(schema, ("octstr", sc or asc or basenode[1]), v, wr)
        elif basenode[0] == "bitstr":
            _encode_node(schema, ("bitstr", sc or asc or basenode[1]), v, wr)
        else:
            _encode_node(schema, basenode, v, wr)
        return
    if kind == "seqof":
        _, elem, size = node
        _encode_size(wr, len(v), sc or size)
        for item in v:
            encode(schema, elem, item, wr)
        return
    if kind == "seq":
        _encode_seq(schema, node, v, wr)
        return
    if kind == "choice":
        _encode_choice(schema, node, v, wr)
        return
    raise ValueError(f"unhandled IR kind {kind}")


def _encode_seq(schema: Schema, node: Node, v: dict, wr: BitWriter
                ) -> None:
    _, members, ext_after = node
    extensible = ext_after >= 0
    root = [m for i, m in enumerate(members)
            if not (extensible and i > ext_after)]
    exts = [m for i, m in enumerate(members)
            if extensible and i > ext_after]
    ext_present = [m for m in exts if m[0] in v]
    if extensible:
        wr.bits(1 if ext_present else 0, 1)
    for name, _tref, optional, _mc, dfl in root:
        if optional:
            present = name in v and (dfl is None or v[name] != dfl)
            wr.bits(1 if present else 0, 1)
    for name, tref, optional, mc, dfl in root:
        if optional and (name not in v or
                         (dfl is not None and v[name] == dfl)):
            continue
        if name not in v:
            raise ValueError(f"missing mandatory member {name}")
        _encode_node(schema, schema.resolve(tref), v[name], wr, mc)
    if ext_present:
        # X.691 18.7 / asn1c: bitmap covers ALL defined extension
        # members, not just up to the last present one
        _put_nslength(wr, len(exts))
        for i in range(len(exts)):
            wr.bits(1 if exts[i][0] in v else 0, 1)
        for i in range(len(exts)):
            name, tref, _opt, mc, _dfl = exts[i]
            if name not in v:
                continue
            sub = BitWriter()
            _encode_node(schema, schema.resolve(tref), v[name], sub, mc)
            blob = sub.getvalue() or b"\x00"
            _put_open_type(wr, blob)


def _encode_choice(schema: Schema, node: Node, v: Tuple[str, Any],
                   wr: BitWriter) -> None:
    _, alts, root_count, extensible = node
    name, val = v
    idx = next(i for i, a in enumerate(alts) if a[0] == name)
    _n, tref, mc = _alt(alts, idx)
    if idx < root_count:
        if extensible:
            wr.bits(0, 1)
        if root_count > 1:
            wr.bits(idx, _range_bits(0, root_count - 1))
        _encode_node(schema, schema.resolve(tref), val, wr, mc)
    else:
        wr.bits(1, 1)
        _put_nsnnwn(wr, idx - root_count)
        sub = BitWriter()
        _encode_node(schema, schema.resolve(tref), val, sub, mc)
        _put_open_type(wr, sub.getvalue() or b"\x00")
