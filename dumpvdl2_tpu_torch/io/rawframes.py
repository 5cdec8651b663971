"""Raw AVLC frame archive format (binary formatter + replay input).

Wire-compatible with the reference's protobuf-based format
(proto/dumpvdl2.proto, fmtr-binary.c, input-raw_frames_file.c): each
record is a big-endian u16 length prefix (which includes the 2 prefix
bytes themselves) followed by a proto3-encoded ``raw_avlc_frame``
message.  The codec below implements exactly that message — field
numbers per the published schema — without a protobuf library
dependency.  Files are concatenation-safe, enabling the archive/replay
("checkpoint") workflow.
"""
from __future__ import annotations

import ctypes
import struct
from typing import BinaryIO, Iterator, Optional

from .. import native
from ..core.metadata import DecodedFrame, MsgMetadata

# field numbers from the published schema
_F_STATION_ID = 1
_F_FREQUENCY = 2
_F_SYND_WEIGHT = 3
_F_DATALEN_OCTETS = 4
_F_FRAME_PWR = 5
_F_NF_PWR = 6
_F_PPM_ERROR = 7
_F_VERSION = 8
_F_NUM_FEC = 9
_F_IDX = 10
_F_TIMESTAMP = 11
_TS_SEC = 1
_TS_USEC = 2
_RAW_METADATA = 1
_RAW_DATA = 2


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzagless_int(value: int) -> bytes:
    # proto3 int32/int64 use plain varint (negative -> 10 bytes)
    return _varint(value)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _field_varint(field: int, value: int) -> bytes:
    if value == 0:
        return b""
    return _tag(field, 0) + _zigzagless_int(value)


def _field_float(field: int, value: float) -> bytes:
    if value == 0.0:
        return b""
    return _tag(field, 5) + struct.pack("<f", value)


def _field_bytes(field: int, value: bytes) -> bytes:
    if not value:
        return b""
    return _tag(field, 2) + _varint(len(value)) + value


def encode_metadata(md: MsgMetadata) -> bytes:
    ts_sec = int(md.burst_timestamp)
    ts_usec = int(round((md.burst_timestamp - ts_sec) * 1e6))
    ts = _field_varint(_TS_SEC, ts_sec) + _field_varint(_TS_USEC, ts_usec)
    out = b""
    if md.station_id:
        out += _field_bytes(_F_STATION_ID, md.station_id.encode())
    out += _field_varint(_F_FREQUENCY, md.freq)
    out += _field_varint(_F_SYND_WEIGHT, md.synd_weight)
    out += _field_varint(_F_DATALEN_OCTETS, md.datalen_octets)
    out += _field_float(_F_FRAME_PWR, md.frame_pwr_dbfs)
    out += _field_float(_F_NF_PWR, md.nf_pwr_dbfs)
    out += _field_float(_F_PPM_ERROR, md.ppm_error)
    out += _field_varint(_F_VERSION, md.version)
    out += _field_varint(_F_NUM_FEC, md.num_fec_corrections)
    out += _field_varint(_F_IDX, md.idx)
    out += _field_bytes(_F_TIMESTAMP, ts)
    return out


def encode_raw_frame(md: MsgMetadata, frame: bytes) -> bytes:
    body = _field_bytes(_RAW_METADATA, encode_metadata(md)) + \
        _field_bytes(_RAW_DATA, frame)
    return body


def frame_record(md: MsgMetadata, frame: bytes) -> bytes:
    """One length-prefixed archive record."""
    body = encode_raw_frame(md, frame)
    return struct.pack(">H", len(body) + 2) + body


# ------------------------------------------------------------------ decoder

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _decode_fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    pos = 0
    L = len(buf)
    while pos < L:
        # single-byte fast paths: every field key here is < 0x80, and
        # most varint values fit one byte
        key = buf[pos]
        pos += 1
        if key & 0x80:
            key, pos = _read_varint(buf, pos - 1)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value = buf[pos]
            if value & 0x80:
                value, pos = _read_varint(buf, pos)
            else:
                pos += 1
        elif wire == 5:
            value = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif wire == 1:
            value = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            value = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


class _RawMeta(ctypes.Structure):
    """Mirror of l2h_raw_meta (native/l2host.c)."""
    _fields_ = [("ts", ctypes.c_double),
                ("frame_pwr", ctypes.c_float),
                ("nf_pwr", ctypes.c_float),
                ("ppm", ctypes.c_float),
                ("freq", ctypes.c_uint64),
                ("synd_weight", ctypes.c_uint64),
                ("datalen_octets", ctypes.c_uint64),
                ("version", ctypes.c_uint64),
                ("num_fec", ctypes.c_uint64),
                ("idx", ctypes.c_uint64),
                ("station_off", ctypes.c_int32),
                ("station_len", ctypes.c_int32),
                ("frame_off", ctypes.c_int32),
                ("frame_len", ctypes.c_int32)]


_NATIVE_LIB = False                   # False = not resolved yet

# One struct.unpack of the returned l2h_raw_meta replaces 14 ctypes
# attribute reads (each ~0.5 us); the format is validated against the
# ctypes layout at import so an ABI change cannot silently skew it.
_RAWMETA_FMT = struct.Struct("=d3f4x6Q4i")
assert _RAWMETA_FMT.size == ctypes.sizeof(_RawMeta), \
    (_RAWMETA_FMT.size, ctypes.sizeof(_RawMeta))


def _native():
    """The native library, or None with DUMPVDL2_TPU_NATIVE=0; raises
    when it cannot be built (no quiet Python path)."""
    global _NATIVE_LIB
    if _NATIVE_LIB is False:
        _NATIVE_LIB = native.load_l2host()
    return _NATIVE_LIB


def decode_raw_frame(body: bytes) -> DecodedFrame:
    lib = _native()
    if lib is not None:
        m = _RawMeta()
        native.calls["l2h_parse_raw_frame"] += 1
        if lib.l2h_parse_raw_frame(body, len(body),
                                   ctypes.byref(m)) == 0:
            (ts, frame_pwr, nf_pwr, ppm, freq, synd_weight,
             datalen_octets, version, num_fec, idx,
             station_off, station_len, frame_off, frame_len) = \
                _RAWMETA_FMT.unpack(bytes(m))
            md = MsgMetadata(
                version=version,
                freq=freq,
                frame_pwr_dbfs=frame_pwr,
                nf_pwr_dbfs=nf_pwr,
                ppm_error=ppm,
                burst_timestamp=ts,
                datalen_octets=datalen_octets,
                synd_weight=synd_weight,
                num_fec_corrections=num_fec,
                idx=idx)
            if station_len:
                md.station_id = body[station_off:
                                     station_off + station_len] \
                    .decode(errors="replace")
            # plain bytes: every consumer does bytes(d.frame), which is
            # a no-op here but a copy for an ndarray
            return DecodedFrame(
                metadata=md,
                frame=body[frame_off:frame_off + frame_len])
        # malformed for the strict native parser: the Python decoder
        # below is the executable spec (and raises informatively)
    md = MsgMetadata()
    frame = b""
    for field, wire, value in _decode_fields(body):
        if field == _RAW_METADATA and wire == 2:
            sec = usec = 0
            for f2, w2, v2 in _decode_fields(value):
                if f2 == _F_STATION_ID:
                    md.station_id = bytes(v2).decode(errors="replace")
                elif f2 == _F_FREQUENCY:
                    md.freq = int(v2)
                elif f2 == _F_SYND_WEIGHT:
                    md.synd_weight = int(v2)
                elif f2 == _F_DATALEN_OCTETS:
                    md.datalen_octets = int(v2)
                elif f2 == _F_FRAME_PWR:
                    md.frame_pwr_dbfs = float(v2)
                elif f2 == _F_NF_PWR:
                    md.nf_pwr_dbfs = float(v2)
                elif f2 == _F_PPM_ERROR:
                    md.ppm_error = float(v2)
                elif f2 == _F_VERSION:
                    md.version = int(v2)
                elif f2 == _F_NUM_FEC:
                    md.num_fec_corrections = int(v2)
                elif f2 == _F_IDX:
                    md.idx = int(v2)
                elif f2 == _F_TIMESTAMP:
                    for f3, _w3, v3 in _decode_fields(v2):
                        if f3 == _TS_SEC:
                            sec = int(v3)
                        elif f3 == _TS_USEC:
                            usec = int(v3)
            md.burst_timestamp = sec + usec / 1e6
        elif field == _RAW_DATA and wire == 2:
            frame = bytes(value)
    return DecodedFrame(metadata=md, frame=frame)


def read_raw_bodies(fh: BinaryIO) -> Iterator[bytes]:
    """Yield undecoded record bodies (length framing only) — the
    parallel decoder ships these to workers and defers the protobuf
    decode there."""
    while True:
        prefix = fh.read(2)
        if len(prefix) < 2:
            return
        (total,) = struct.unpack(">H", prefix)
        if total < 2:
            raise ValueError("corrupted record length")
        body = fh.read(total - 2)
        if len(body) < total - 2:
            return
        yield body


def frame_data_peek(body: bytes) -> bytes:
    """Return the raw AVLC frame field without decoding the metadata
    submessage (cheap top-level scan for sharding keys)."""
    pos = 0
    while pos < len(body):
        key, pos = _read_varint(body, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            _, pos = _read_varint(body, pos)
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(body, pos)
            if field == _RAW_DATA:
                return bytes(body[pos:pos + ln])
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return b""


def read_records(fh: BinaryIO) -> Iterator[DecodedFrame]:
    """Replay a raw-frames archive (input-raw_frames_file.c equivalent)."""
    for body in read_raw_bodies(fh):
        yield decode_raw_frame(body)
