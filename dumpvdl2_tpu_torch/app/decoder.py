"""Frame decoder + output dispatcher.

Equivalent of the reference's decoder thread (decode.c:422-527): for
each decoded AVLC frame, parse the protocol tree once, apply the
message filter, serialize per formatter instance, and fan out to every
attached output queue.
"""
from __future__ import annotations

import time
from typing import Iterable, Optional

from ..app.stats import stats
from ..config import Config
from ..core.metadata import DecodedFrame
from ..io.outputs import FormatterInstance
from ..proto.avlc import avlc_parse
from ..proto.reasm import ReasmContexts
from ..utils.debug import (D_PROTO, D_PROTO_DETAIL, debug_print,
                           debug_print_buf_hex)


class FrameDecoder:
    def __init__(self, fmtr_list: list[FormatterInstance]) -> None:
        self.fmtr_list = fmtr_list
        self.reasm = ReasmContexts()

    def start_outputs(self) -> None:
        for fmtr in self.fmtr_list:
            for output in fmtr.outputs:
                output.start()

    def process(self, decoded: DecodedFrame) -> None:
        metadata = decoded.metadata
        frame = bytes(decoded.frame)
        stats.increment_per_channel(metadata.freq, "avlc.frames.processed")
        debug_print(D_PROTO, "frame on %d Hz, %d octets",
                    metadata.freq, len(frame))
        debug_print_buf_hex(D_PROTO_DETAIL, frame, "AVLC frame:")
        t0 = time.monotonic()
        root = None
        msg_type = 0
        decoded_once = False
        for fmtr in self.fmtr_list:
            if fmtr.intype == "decoded":
                if not decoded_once:
                    root, msg_type = avlc_parse(frame, metadata, self.reasm)
                    decoded_once = True
                if root is None:
                    continue
                if (msg_type & Config.msg_filter) != msg_type:
                    continue
                msg = fmtr.descriptor.format_decoded_msg(metadata, root)
                if msg is None:
                    continue
                for output in fmtr.outputs:
                    output.push(metadata, msg)
            elif fmtr.intype == "raw":
                msg = fmtr.descriptor.format_raw_msg(metadata, frame)
                if msg is None:
                    continue
                for output in fmtr.outputs:
                    output.push(metadata, msg)
        stats.timing("decoder.msg.processing_time",
                     (time.monotonic() - t0) * 1000.0)

    def process_all(self, frames: Iterable[DecodedFrame]) -> None:
        for decoded in frames:
            self.process(decoded)

    def shutdown(self) -> None:
        for fmtr in self.fmtr_list:
            for output in fmtr.outputs:
                output.push(None, None, shutdown=True)
        for fmtr in self.fmtr_list:
            for output in fmtr.outputs:
                output.join()
