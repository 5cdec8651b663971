"""Frame formatters: decoded/raw frames -> serialized messages.

The reference's formatter registry (output-common.c, fmtr-*.c) maps
(input type, format) to serializer functions.  Formats: text (human
readable), json, pp_acars (Planeplotter one-liner), binary (raw-frames
protobuf archive).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from .. import __version__
from ..config import Config
from ..core.metadata import MsgMetadata
from ..proto.base import (JsonObj, ProtoNode, TextOut, json_dumps,
                          tree_format_json, tree_format_text)
from . import rawframes


# One-entry timestamp cache: bulk replay emits thousands of frames per
# wall-clock second, and the two strftime calls were ~6% of formatting
# time.  Keyed on (integer second, utc flag); the milliseconds part is
# inserted per call.
_TS_CACHE: tuple = (None, None, "", "")


def format_timestamp(ts: float) -> str:
    global _TS_CACHE
    sec = int(ts)
    utc = Config.utc
    csec, cutc, base, tz = _TS_CACHE
    if sec != csec or utc != cutc:
        tm = time.gmtime(sec) if utc else time.localtime(sec)
        base = time.strftime("%Y-%m-%d %H:%M:%S", tm)
        tz = time.strftime("%Z", tm)
        _TS_CACHE = (sec, utc, base, tz)
    if Config.milliseconds:
        return base + ".%03d %s" % (int(ts * 1000) % 1000, tz)
    return base + " " + tz


def format_text(metadata: MsgMetadata, root: ProtoNode) -> Optional[bytes]:
    out = TextOut()
    out.append("[%s] [%.3f] [%.1f/%.1f dBFS] [%.1f dB] [%.1f ppm]" % (
        format_timestamp(metadata.burst_timestamp),
        metadata.freq / 1e6, metadata.frame_pwr_dbfs, metadata.nf_pwr_dbfs,
        metadata.frame_pwr_dbfs - metadata.nf_pwr_dbfs,
        metadata.ppm_error))
    if Config.extended_header:
        out.append(" [S:%d] [L:%u] [F:%d] [#%u]" % (
            metadata.synd_weight, metadata.datalen_octets,
            metadata.num_fec_corrections, metadata.idx))
    out.append("\n")
    tree_format_text(out, root)
    return out.getvalue().encode()


def format_json(metadata: MsgMetadata, root: ProtoNode) -> Optional[bytes]:
    vdl2 = JsonObj()
    vdl2["app"] = JsonObj(name="dumpvdl2_tpu", ver=__version__)
    if metadata.station_id:
        vdl2["station"] = metadata.station_id
    sec = int(metadata.burst_timestamp)
    vdl2["t"] = JsonObj(sec=sec,
                        usec=int(round((metadata.burst_timestamp - sec) * 1e6)))
    vdl2["freq"] = metadata.freq
    vdl2["burst_len_octets"] = metadata.datalen_octets
    vdl2["hdr_bits_fixed"] = metadata.synd_weight
    vdl2["octets_corrected_by_fec"] = metadata.num_fec_corrections
    vdl2["idx"] = metadata.idx
    vdl2["sig_level"] = metadata.frame_pwr_dbfs
    vdl2["noise_level"] = metadata.nf_pwr_dbfs
    vdl2["freq_skew"] = metadata.ppm_error
    tree = tree_format_json(root)
    vdl2.update(tree)
    return json_dumps(JsonObj(vdl2=vdl2)).encode()


def format_pp_acars(metadata: MsgMetadata, root: ProtoNode
                    ) -> Optional[bytes]:
    """Planeplotter one-liner; None for non-ACARS messages."""
    node = root
    while node is not None and node.json_key != "acars":
        node = node.next
    if node is None or getattr(node, "err", True):
        return None
    txt = node.txt.replace("\n", " ").replace("\r", " ")
    line = "AC%1s %7s %1s %2s %1s %3s%1s %6s %s" % (
        node.mode, node.reg, node.ack, node.label, node.block_id,
        node.msg_num, node.msg_num_seq, node.flight_id, txt)
    return line.encode()


def format_raw_binary(metadata: MsgMetadata, frame: bytes
                      ) -> Optional[bytes]:
    return rawframes.encode_raw_frame(metadata, bytes(frame))


@dataclass
class FormatterDescriptor:
    name: str
    description: str
    output_format: str
    format_decoded_msg: Optional[Callable] = None
    format_raw_msg: Optional[Callable] = None

    def supports_data_type(self, intype: str) -> bool:
        if intype == "decoded":
            return self.format_decoded_msg is not None
        if intype == "raw":
            return self.format_raw_msg is not None
        return False


FORMATTERS = {
    "text": FormatterDescriptor(
        name="text", description="Human readable text",
        output_format="text", format_decoded_msg=format_text),
    "json": FormatterDescriptor(
        name="json", description="Javascript object notation",
        output_format="json", format_decoded_msg=format_json),
    "pp_acars": FormatterDescriptor(
        name="pp_acars", description="Planeplotter ACARS format",
        output_format="pp_acars", format_decoded_msg=format_pp_acars),
    "binary": FormatterDescriptor(
        name="binary", description="Binary format (raw frames + metadata)",
        output_format="binary", format_raw_msg=format_raw_binary),
}


def formatter_get(fmt: str) -> FormatterDescriptor:
    if fmt not in FORMATTERS:
        raise ValueError(f"unknown output format: {fmt!r}")
    return FORMATTERS[fmt]
