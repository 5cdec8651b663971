"""The receive pipeline's span log: host spans of each block on the main
and fetch threads, the block's device time by step, and the frames its
drain returned.

A :class:`SpanLog` belongs to one ``VDL2Pipeline`` and is always on, at
block granularity.  Each block (a ``feed``/``feed_raw``/``feed_planar``
call that dispatched one, or a ``finish()``, whose EOF flush gets a
record of its own) has a :class:`Block` record in a bounded ring.  A
record holds each span of :data:`PARENT` at most once, as two
``perf_counter_ns`` stamps in slots made with the record
(:meth:`SpanLog.open`, :meth:`SpanLog.close`; a ``feed_raw`` record's
``read``, the file read that filled its buffer, by
:meth:`SpanLog.stamp` after the fact); :attr:`Block.spans` gives them as
:class:`Span` tuples.  A span's parent is fixed by its name, but for a
drain's or a finish's, which runs inside a later call: the record keeps
that call as ``outer``, (sequence number, name).

On CUDA the log records timing events in stream order at span
boundaries (detect's start, each step's end, and the main thread's
start of the block's fetch, before its copy; for ``feed_raw``, before
the raw copy and after the ingest kernel), on one record in EVENT_EVERY
and on every record of a measuring call (``step_ms``, a profiler);
:meth:`SpanLog.fetched` turns them into milliseconds on the fetch
thread once the copy is done: the copy follows every event in the
stream, so each has completed and none is waited for.  These are
intervals of the device's timeline between two events, not the step's
kernel time: they also hold the device's idle time while the host is
still enqueuing the step.

While a torch profiler records, each span is also a ``vdl2.<name>``
range (a user annotation, as ``record_function`` makes), so profiler
traces carry the spans beside the kernels (the fetch thread's only
where the profiler records every thread); a span's stamps lie inside
its range.  Outside a profiler no range is entered; each call (and each
fetch) checks once.
:meth:`SpanLog.wall_ns` puts a span on the trace's clock.

:func:`latest` is the log of the newest pipeline built, so that it can
be read after the pipeline is gone.  Nothing here writes a file.
"""
from __future__ import annotations

import time
from collections import deque, namedtuple
from itertools import starmap
from operator import call

import torch
from torch.autograd import profiler as _autograd_profiler

from ..utils.fetch import nbytes

RING_BLOCKS = 8192        # block records kept
# CUDA events go on one record in EVENT_EVERY (and on every record of a
# call with step_ms or under a profiler): as the pipeline runs, a CUDA
# call costs 5-70 us on an H100's host, and five a block were most of
# the log's cost.  Odd, so that a stream fed from a pool of 2**k blocks
# samples each of them.
EVENT_EVERY = 15
MAIN, FETCH = "main", "fetch"
STEPS = ("detect", "l2", "gate")     # event names of dispatch's steps
# Every span a record can hold, with its parent in the same record:
# feed.h2d's and feed_planar's the feed() or feed_raw() call that ran
# them (:data:`FEEDS`), if any; a drain's or a finish's is the record's
# ``outer``.  ``fetch`` runs on the fetch thread; ``read`` precedes
# feed_raw.
PARENT = {"read": None, "feed": None, "feed_raw": None,
          "feed.h2d": "feed", "feed_planar": "feed",
          "dispatch": "feed_planar", "detect": "dispatch",
          "l2": "dispatch", "gate": "dispatch", "fetch": None,
          "drain": None, "drain.wait": "drain", "drain.verdicts": "drain",
          "fetch_host": "feed_planar", "finish": None}
SLOT = {name: 2 * i for i, name in enumerate(PARENT)}  # start; end at +1
_STAMPS = 2 * len(SLOT)
_CALLS = ("feed_planar", "finish")    # the calls a drain or finish runs in
_OUTER = ("drain", "finish")
FEEDS = ("feed", "feed_raw")          # the calls that hold feed.h2d

Span = namedtuple("Span", "name seq parent thread start end")
Span.__doc__ = """A host span: ``name``, the block's sequence number
``seq``, ``parent`` as (seq, name) or None, ``thread`` (MAIN or FETCH),
``start`` and ``end`` in time.perf_counter_ns()."""

_latest = None


def latest():
    """The span log of the newest pipeline built, or None."""
    return _latest


_RANGE_ENTER = torch._C._autograd._record_function_with_args_enter
_RANGE_EXIT = torch._C._autograd._record_function_with_args_exit


def _enter(name: str) -> tuple:
    """Start the profiler range ``name`` (a user annotation, as
    ``record_function`` makes); returns its handle and a perf_counter_ns
    stamp read right after the range read its clock.  This entry holds
    the GIL throughout: ``record_function``'s enter releases it, so a
    thread's first range under a profiler (which registers the thread
    there) can wait milliseconds for the GIL before the range reads its
    clock; and it runs no CUPTI-monitor hook, whose first call imports a
    module (~1 ms).  Both calls run from C (``starmap``): between two
    calls made from Python, a thread waiting for the GIL takes it, most
    often right after the range's start, the longest call, and the
    stamp would lag the range by as long as that thread keeps it."""
    return tuple(starmap(call, ((_RANGE_ENTER, name),
                                (time.perf_counter_ns,))))


def _leave(handle) -> int:
    """A perf_counter_ns stamp, then the end of the range ``handle``,
    both run from C as in :func:`_enter`; returns the stamp."""
    return tuple(starmap(call, ((time.perf_counter_ns,),
                                (_RANGE_EXIT, handle))))[0]


def _clock_anchor(reads: int = 8) -> tuple[int, int]:
    """(perf_counter_ns, time_ns) of one moment: of ``reads`` readings
    of time_ns each between two of perf_counter_ns, the most narrowly
    bracketed, against its bracket's middle (a thread preempted between
    two reads would put every span off on the trace's clock)."""
    best = None
    for _ in range(reads):
        a, wall, b = time.perf_counter_ns(), time.time_ns(), \
            time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, wall)
    return best[1:]


def profiling() -> bool:
    """Whether a torch profiler records (~0.05 us): the flag a profiler
    sets for every thread while it runs.  (``_profiler_enabled()`` reads
    only this thread's profiler, and none where the profiler records
    every thread.)"""
    return _autograd_profiler._is_profiler_enabled


class Block:
    """One block's record: its span stamps ``t`` (start and end of each
    span of PARENT at SLOT[name] and SLOT[name] + 1, None where it did
    not run), the call its drain or finish ran in (``outer``), the
    frames its drain returned (``frames``; the drain's end is their
    emission stamp), in a ``synced`` record the bytes its fetch copied
    by part of the fetched tree (``fetch_bytes``), whether a call that
    dispatched or drained it ran with ``step_ms`` (``synced``) or under
    a profiler (``profiled``), whether its dispatch replayed the steps'
    CUDA graphs (``graphed``, core/graphs.py), whether its channelizer
    ran the polyphase filter bank (``pfb``, dsp/pfb_kernel.py; for a
    graphed block as decided at the capture), and on CUDA the
    milliseconds of the device's timeline between its events: before
    and after each step (``detect_dev``, ``l2_dev``, ``gate_dev``), from
    its last step to the start of its fetch (``fetch_lag_dev``),
    and from the start of feed_raw's copy to the end of its ingest
    kernel (``ingest_dev``); None where not measured (``timed``: the
    record gets events)."""

    __slots__ = ("seq", "t", "outer", "frames", "fetch_bytes", "synced",
                 "profiled", "graphed", "pfb", "detect_dev", "l2_dev",
                 "gate_dev", "fetch_lag_dev", "ingest_dev", "events")

    def __init__(self, seq: int, synced: bool, profiled: bool,
                 timed: bool):
        self.seq, self.synced, self.profiled = seq, synced, profiled
        self.graphed = self.pfb = False
        self.t = [None] * _STAMPS
        self.outer = self.frames = self.fetch_bytes = None
        self.detect_dev = self.l2_dev = self.gate_dev = None
        self.fetch_lag_dev = self.ingest_dev = None
        self.events = {} if timed else None

    def span(self, name: str, thread: str = MAIN):
        """Span ``name`` on ``thread``, or None where it did not run."""
        i = SLOT.get(name)
        if i is None or thread != (FETCH if name == "fetch" else MAIN):
            return None
        start, end = self.t[i], self.t[i + 1]
        if start is None or end is None:
            return None
        if name in _OUTER:
            parent = self.outer
        elif name in ("feed.h2d", "feed_planar"):
            feeds = [f for f in FEEDS if self.t[SLOT[f]] is not None]
            parent = (self.seq, feeds[0]) if feeds else None
        else:
            parent = PARENT[name] and (self.seq, PARENT[name])
        return Span(name, self.seq, parent, thread, start, end)

    @property
    def spans(self) -> list:
        """Every span of the record, in order of their start."""
        got = [self.span(name, FETCH if name == "fetch" else MAIN)
               for name in SLOT]
        return sorted((s for s in got if s is not None),
                      key=lambda s: s.start)

    def ms(self, name: str, thread: str = MAIN):
        """Milliseconds of span ``name`` on ``thread``, or None."""
        s = self.span(name, thread)
        return None if s is None else (s.end - s.start) / 1e6

    def _resolve(self) -> bool:
        """Device milliseconds from the events, if the fetch's has
        completed (the earlier ones precede it in stream order)."""
        ev = self.events
        fetch = ev.get("fetch")
        if fetch is None or not fetch.query():
            return False
        prev = ev["start"]
        for step in STEPS:
            e = ev.get(step)
            if e is not None:
                setattr(self, step + "_dev", prev.elapsed_time(e))
                prev = e
        self.fetch_lag_dev = prev.elapsed_time(fetch)
        if "ingested" in ev:
            self.ingest_dev = ev["ingest"].elapsed_time(ev["ingested"])
        self.events = None
        return True


class SpanLog:
    """The block records of one pipeline on ``device``, the newest
    RING_BLOCKS kept, the clock anchor ``anchor`` = (perf_counter_ns,
    time_ns) of one moment at the start (:func:`_clock_anchor`), and
    ``counts`` of a file's input (io/iqfile.py::feed_iq_file):
    ``read_bytes`` read, and ``staging_waits``, reads that waited for a
    staging buffer's copy."""

    def __init__(self, device: torch.device):
        global _latest
        self.device = device
        self.blocks: deque = deque(maxlen=RING_BLOCKS)
        self.anchor = _clock_anchor()
        self._seq = 0
        self.current = None           # the record of the current call
        self._calls: list = []        # open feed_planar/finish (seq, name)
        self._synced = self._profiled = False    # of the current call
        self._ranges: dict = {}       # (seq, name) -> its range's handle
        self._free: list = []         # resolved events, to record again
        self._streams: dict = {}      # current-stream key -> Stream
        self._cuda = device.type == "cuda"
        self._index = None
        self.counts = {"read_bytes": 0, "staging_waits": 0}
        if self._cuda:
            self._index = device.index if device.index is not None \
                else torch.cuda.current_device()
        _latest = self

    def new_block(self, synced: bool) -> Block:
        """A new record for the call that starts now (``synced``: it
        runs with ``step_ms``); checks once whether a profiler records,
        which decides the profiler ranges of the call's
        spans."""
        self._synced, self._profiled = synced, profiling()
        blk = Block(self._seq, synced, self._profiled, self._cuda and (
            synced or self._profiled or self._seq % EVENT_EVERY == 0))
        self._seq += 1
        self.current = blk
        self.blocks.append(blk)
        return blk

    def open(self, blk: Block, name: str) -> None:
        """Start span ``name`` of ``blk``: ``fetch`` on the fetch
        thread, the others on the main thread.  A drain marks its block
        ``synced`` or ``profiled`` as its call runs.  On CUDA, detect's
        start records the event ``start``."""
        if name == "fetch":
            on = profiling()
            blk.profiled |= on
        else:
            on = self._profiled
            if name in _OUTER:
                calls = self._calls
                blk.outer = calls[-1] if calls else None
                blk.synced |= self._synced
                blk.profiled |= on
            if name == "feed_planar":      # outermost: drop what an
                self._calls = [(blk.seq, name)]   # exception left
            elif name == "finish":
                self._calls.append((blk.seq, name))
        if on:     # stamped inside the range
            self._ranges[(blk.seq, name)], blk.t[SLOT[name]] = _enter(
                "vdl2." + name)
        else:
            blk.t[SLOT[name]] = time.perf_counter_ns()
        if name == "detect" and blk.events is not None \
                and "start" not in blk.events:
            self._event(blk, "start")

    def close(self, blk: Block, name: str) -> None:
        """End span ``name`` of ``blk``.  A step's end (STEPS) records
        the step's event on CUDA, and in a ``synced`` record waits for
        the device first, so that the span holds the step's device
        work."""
        if name in STEPS and self._cuda:
            if blk.events is not None:
                self._event(blk, name)
            if blk.synced:
                torch.cuda.synchronize(self.device)
        handle = self._ranges.pop((blk.seq, name), None) \
            if self._ranges else None
        blk.t[SLOT[name] + 1] = time.perf_counter_ns() if handle is None \
            else _leave(handle)
        if name in _CALLS and self._calls:
            self._calls.pop()

    def event(self, blk: Block, name: str) -> None:
        """A timing event ``name`` of ``blk`` in stream order now, on a
        record that gets events: ``fetch`` as the main thread starts the
        block's fetch, before its copy (core/pipeline.py), and
        feed_raw's ``ingest`` before its copy and ``ingested`` after its
        kernel."""
        if blk.events is not None and self._cuda:
            self._event(blk, name)

    def stamp(self, blk: Block, name: str, start: int, end: int) -> None:
        """Span ``name`` of ``blk`` from ``start`` to ``end``
        (perf_counter_ns), for work that ran before the record was made
        (feed_raw's ``read``); no profiler range."""
        i = SLOT[name]
        blk.t[i], blk.t[i + 1] = start, end

    def add(self, blk: Block, name: str, start: int) -> None:
        """Span ``name`` of ``blk`` from ``start`` to now, for a span
        that closes where another began; in a ``synced`` record, to
        after a wait for the device."""
        if blk.synced and self._cuda:
            torch.cuda.synchronize(self.device)
        i = SLOT[name]
        blk.t[i], blk.t[i + 1] = start, time.perf_counter_ns()

    def _event(self, blk: Block, name: str) -> None:
        """A timing event ``name`` of ``blk`` on the device's current
        stream of this thread (an event of a resolved block again where
        there is one)."""
        try:
            ev = self._free.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        # the Stream object of the current stream, made once per stream
        key = torch._C._cuda_getCurrentStream(self._index)
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        ev.record(stream)
        blk.events[name] = ev

    def fetched(self, blk: Block, out) -> None:
        """After ``blk``'s fetch brought ``out`` (a tuple of trees) to the
        host: its device times if its events have completed (after the
        copy they have; the events go back to the pool), and in a
        ``synced`` record the bytes copied by part."""
        if blk.synced:
            blk.fetch_bytes = tuple(nbytes(part) for part in out)
        events = blk.events
        if events and blk._resolve():
            self._free.extend(events.values())

    def wall_ns(self, t: int) -> int:
        """perf_counter_ns ``t`` on the wall clock (time_ns), the clock
        of a torch profiler trace's ``ts`` + ``baseTimeNanoseconds``."""
        return self.anchor[1] + (t - self.anchor[0])
