"""Parallel host protocol stack: ``--decode-workers N``.

The reference funnels every demodulated frame through ONE decoder
thread (decode.c:422-527) because its reassembly tables are stateful.
That stage caps a single receiver process at a few thousand frames/s —
fine for 1-8 channels, but this framework's wideband configs demodulate
hundreds of channels per chip, and bulk raw-frames archive replays are
limited by protocol parsing alone.

This module scales L3/L4 across worker PROCESSES while preserving the
single-thread semantics the reference gets for free:

* **Reassembly affinity** — frames are sharded by the aircraft DLC
  address (or the unordered address pair when no aircraft is present),
  so every fragment of an X.25 / COTP / CLNP / ACARS / MIAM
  conversation reaches the same worker and its private reassembly
  tables.  The aircraft side is the stable key across ground-station
  handoffs.
* **Deterministic output** — the parent assigns a sequence number per
  frame and re-emits serialized messages strictly in that order, so
  the byte stream equals the single-process decoder's (asserted by
  tests/test_parallel_decoder.py).
* **Metrics parity** — workers run an ordinary in-process StatsSink
  and ship per-batch counter/timing deltas back; the parent merges
  them into the global sink (and through it the optional StatsD
  client), keeping the reference counter funnel intact.

Workers are ``spawn``-started so they never inherit a CUDA context,
and their import graph stays free of the device pipeline (protocol
stack + formatters only).
"""
from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import sys
import time
import traceback
from typing import Iterable, Optional

from ..app.stats import stats
from ..config import Config
from ..core.metadata import DecodedFrame, MsgMetadata
from ..io.outputs import FormatterInstance
from ..proto.avlc import parse_dlc_addr

# Parent-side flush tuning: a replay loop feeds frames one by one, so
# buffer up to FLUSH_BATCH before paying an IPC roundtrip; a live
# pipeline calls process_all() per block, which always flushes.
FLUSH_BATCH = 256
MAX_IN_FLIGHT = 8192


def shard_key(frame: bytes) -> int:
    """Stable reassembly-affinity key for one AVLC frame."""
    if len(frame) < 8:
        return 0
    dst = parse_dlc_addr(frame[0:4])
    src = parse_dlc_addr(frame[4:8])
    if src.is_aircraft:
        return src.addr
    if dst.is_aircraft:
        return dst.addr
    a, b = sorted((src.addr, dst.addr))
    return (a << 24) | b


# --------------------------------------------------------------- worker side

def _worker_main(worker_id: int, inq, outq, fmtr_specs, config_fields,
                 debug_mask: int, gs_file: Optional[str],
                 bs_db: Optional[str]) -> None:
    """Worker process entry point (top-level for spawn picklability)."""
    import signal
    signal.signal(signal.SIGINT, signal.SIG_IGN)   # parent drives shutdown

    for k, v in config_fields.items():
        setattr(Config, k, v)
    from ..utils.debug import set_debug_mask
    set_debug_mask(debug_mask)
    if gs_file:
        from ..io import gs_data
        gs_data.gs_data_import(gs_file)
    if bs_db:
        from ..io import ac_data
        ac_data.ac_data_init(bs_db)

    from ..io.formatters import formatter_get
    from ..proto.avlc import avlc_parse
    from ..proto.reasm import ReasmContexts
    fmtrs = [(formatter_get(fmt), intype) for fmt, intype in fmtr_specs]
    reasm = ReasmContexts()

    from ..io.rawframes import decode_raw_frame
    from ..native import load_l2host
    # outside the per-record fence below: a worker that cannot load the
    # native library dies here, loudly, instead of decoding in Python
    load_l2host()

    while True:
        msg = inq.get()
        if msg[0] == "stop":
            outq.put(("stopped", worker_id))
            return
        results = []
        # this batch's processing times: the parent's sink adds them to
        # its count and sum and pushes each to StatsD, as in-process
        # decode does
        times = []
        for seq, metadata, frame in msg[1]:
            # worker-decoded metadata shipped back to the parent so
            # output.push sees the same metadata as in-process decode
            shipped_meta = None
            msgs: list = [None] * len(fmtrs)
            # the whole per-record body is fenced: a corrupt raw-frames
            # record (or any per-frame decode crash) is reported and
            # skipped, never kills the worker — the parent relies on
            # every seq coming back to keep its in-order emission and
            # backpressure accounting live
            try:
                if metadata is None:   # raw archive record: decode here
                    decoded = decode_raw_frame(frame)
                    metadata = shipped_meta = decoded.metadata
                    frame = bytes(decoded.frame)
                t0 = time.monotonic()
                stats.increment_per_channel(metadata.freq,
                                            "avlc.frames.processed")
                root = None
                msg_type = 0
                decoded_once = False
                for i, (fd, intype) in enumerate(fmtrs):
                    if intype == "decoded":
                        if not decoded_once:
                            root, msg_type = avlc_parse(frame, metadata,
                                                        reasm)
                            decoded_once = True
                        if root is None:
                            continue
                        if (msg_type & Config.msg_filter) != msg_type:
                            continue
                        msgs[i] = fd.format_decoded_msg(metadata, root)
                    else:
                        msgs[i] = fd.format_raw_msg(metadata, frame)
                times.append((time.monotonic() - t0) * 1000.0)
            except Exception:
                traceback.print_exc(file=sys.stderr)
            results.append((seq, msgs, shipped_meta))
        counters = dict(stats.counters)
        stats.reset()
        outq.put(("results", results, counters,
                  {"decoder.msg.processing_time": times}))


# --------------------------------------------------------------- parent side

class ParallelFrameDecoder:
    """Drop-in FrameDecoder replacement fanning L3/L4 over N processes."""

    def __init__(self, fmtr_list: list[FormatterInstance], workers: int,
                 gs_file: Optional[str] = None,
                 bs_db: Optional[str] = None) -> None:
        if workers < 1:
            raise ValueError("decode workers must be >= 1 "
                             "(use FrameDecoder for in-process decode)")
        from ..io.formatters import FORMATTERS
        self.fmtr_list = fmtr_list
        fmtr_specs = []
        for f in fmtr_list:
            name = next(n for n, fd in FORMATTERS.items()
                        if fd is f.descriptor)
            fmtr_specs.append((name, f.intype))

        # build the native library once, before the workers start (they
        # load it; a failed build raises here)
        from ..native import load_l2host
        load_l2host()

        from dataclasses import fields
        config_fields = {fld.name: getattr(Config, fld.name)
                         for fld in fields(Config)}
        from ..utils.debug import debug_mask

        ctx = mp.get_context("spawn")
        self._outq = ctx.Queue()
        self._inqs = []
        self._procs = []
        for wid in range(workers):
            inq = ctx.Queue()
            p = ctx.Process(
                target=_worker_main,
                args=(wid, inq, self._outq, fmtr_specs, config_fields,
                      debug_mask, gs_file, bs_db),
                daemon=True)
            p.start()
            self._inqs.append(inq)
            self._procs.append(p)

        # DecodedFrame entries (live pipeline) or raw record bytes
        # (archive replay); sequence order == emission order
        self._buffer: list = []
        self._seq = 0                   # next sequence number to assign
        self._emit_seq = 0              # next sequence number to emit
        self._ready: dict[int, list] = {}
        self._meta: dict[int, MsgMetadata] = {}
        self._stopped = 0

    # ------------------------------------------------------------- dispatch
    def start_outputs(self) -> None:
        for fmtr in self.fmtr_list:
            for output in fmtr.outputs:
                output.start()

    def process(self, decoded: DecodedFrame) -> None:
        self._buffer.append(decoded)
        if len(self._buffer) >= FLUSH_BATCH:
            self._flush()
            self._drain(block=False)

    def process_record(self, body: bytes) -> None:
        """Enqueue one UNDECODED raw-frames archive record; the worker
        performs the protobuf decode too (bulk replay fast path)."""
        self._buffer.append(body)
        if len(self._buffer) >= FLUSH_BATCH:
            self._flush()
            self._drain(block=False)

    def process_all(self, frames: Iterable[DecodedFrame]) -> None:
        self._buffer.extend(frames)
        self._flush()
        self._drain(block=False)

    def _flush(self) -> None:
        if not self._buffer:
            return
        from ..io.rawframes import frame_data_peek
        nw = len(self._inqs)
        batches: list[list] = [[] for _ in range(nw)]
        for item in self._buffer:
            seq = self._seq
            self._seq += 1
            if isinstance(item, bytes):            # raw archive record
                self._meta[seq] = None
                try:
                    key = shard_key(frame_data_peek(item))
                except Exception:
                    key = 0    # corrupt record: let a worker report it
                batches[key % nw].append((seq, None, item))
            else:
                frame = bytes(item.frame)
                self._meta[seq] = item.metadata
                batches[shard_key(frame) % nw].append(
                    (seq, item.metadata, frame))
        self._buffer.clear()
        for wid, batch in enumerate(batches):
            if batch:
                self._inqs[wid].put(("batch", batch))
        while self._seq - self._emit_seq > MAX_IN_FLIGHT:
            # blocking backpressure must not spin forever if a worker
            # process died: its in-flight seqs would never come back
            if self._drain(block=True) == 0 \
                    and any(not p.is_alive() for p in self._procs):
                lost = self._seq - self._emit_seq
                print(f"warning: parallel decoder lost {lost} in-flight "
                      f"frames (worker process died)", file=sys.stderr)
                raise RuntimeError("decode worker process died; aborting "
                                   "(rerun without --decode-workers to "
                                   "decode in-process)")

    # --------------------------------------------------------------- results
    def _merge_stats(self, counters: dict, timings: dict) -> None:
        for k, n in counters.items():
            stats.increment(k, n)
        for k, vals in timings.items():
            for v in vals:
                stats.timing(k, v)

    def _drain(self, block: bool) -> int:
        """Collect available worker results; emit in sequence order.
        Returns the number of result messages consumed."""
        got = 0
        while True:
            try:
                msg = self._outq.get(timeout=1.0) if (block and not got) \
                    else self._outq.get_nowait()
            except queue_mod.Empty:
                break
            if msg[0] == "results":
                for seq, msgs, shipped_meta in msg[1]:
                    self._ready[seq] = (msgs, shipped_meta)
                self._merge_stats(msg[2], msg[3])
                got += 1
            elif msg[0] == "stopped":
                self._stopped += 1
                got += 1
        while self._emit_seq in self._ready:
            msgs, shipped_meta = self._ready.pop(self._emit_seq)
            metadata = self._meta.pop(self._emit_seq)
            if metadata is None:       # raw record: worker decoded it
                metadata = shipped_meta
            for i, fmtr in enumerate(self.fmtr_list):
                if msgs[i] is None:
                    continue
                for output in fmtr.outputs:
                    output.push(metadata, msgs[i])
            self._emit_seq += 1
        return got

    def flush_wait(self) -> None:
        """Block until every queued frame has been decoded and emitted
        in order (steady-state barrier: benchmarks/tests measure
        sustained throughput without paying spawn/teardown)."""
        self._flush()
        while self._emit_seq < self._seq:
            if self._drain(block=True) == 0 \
                    and any(not p.is_alive() for p in self._procs):
                raise RuntimeError(
                    "decode worker process died during flush")

    # -------------------------------------------------------------- shutdown
    def shutdown(self) -> None:
        self._flush()
        for inq in self._inqs:
            inq.put(("stop",))
        deadline = time.monotonic() + 30.0
        while self._stopped < len(self._procs) \
                and time.monotonic() < deadline:
            if self._drain(block=True) == 0 \
                    and all(not p.is_alive() for p in self._procs):
                break              # dead workers will never ack "stop"
        self._drain(block=False)
        if self._emit_seq != self._seq:
            print(f"warning: parallel decoder lost "
                  f"{self._seq - self._emit_seq} in-flight frames",
                  file=sys.stderr)
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
        for fmtr in self.fmtr_list:
            for output in fmtr.outputs:
                output.push(None, None, shutdown=True)
        for fmtr in self.fmtr_list:
            for output in fmtr.outputs:
                output.join()
