"""The receive pipeline's span log: host spans of each block on the main
and fetch threads, the block's device time by step, and the frames its
drain returned.

A :class:`SpanLog` belongs to one ``VDL2Pipeline`` and is always on, at
block granularity.  Each block (a ``feed``/``feed_planar`` call that
dispatched one, or a ``finish()``, whose EOF flush gets a record of its
own) has a :class:`Block` record in a bounded ring.  A record holds each
span of :data:`PARENT` at most once, as two ``perf_counter_ns`` stamps
in slots made with the record (:meth:`SpanLog.open`,
:meth:`SpanLog.close`); :attr:`Block.spans` gives them as :class:`Span`
tuples.  A span's parent is fixed by its name, but for a drain's or a
finish's, which runs inside a later call: the record keeps that call
as ``outer``, (sequence number, name).

On CUDA the log records timing events in stream order at span
boundaries (detect's start, each step's end, and the fetch's start on
the fetch thread, or for a graphed block the main thread's enqueue of
its fetch copy), on one record in EVENT_EVERY and on every record of
a measuring call (``step_ms``, a profiler);
:meth:`SpanLog.fetched` turns them into milliseconds on the fetch
thread once its copy is done: the copy waits for the stream, so every
event has completed and none is waited for.  These are intervals of the
device's timeline between two events, not the step's kernel time: they
also hold the device's idle time while the host is still enqueuing the
step, and any work of the fetch thread (an earlier block's copy) that
the stream ran between the two events.

While a torch profiler records, each span is also a
``record_function("vdl2.<name>")`` range, so profiler traces carry the
spans beside the kernels (the fetch thread's only where the profiler
records every thread).  Outside a profiler no ``record_function`` is
entered; each call (and each fetch) checks once.
:meth:`SpanLog.wall_ns` puts a span on the trace's clock.

:func:`latest` is the log of the newest pipeline built, so that it can
be read after the pipeline is gone.  Nothing here writes a file.
"""
from __future__ import annotations

import time
from collections import deque, namedtuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

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
# feed_planar's only where feed() called it; a drain's or a finish's is
# the record's ``outer``.  ``fetch`` runs on the fetch thread.
PARENT = {"feed": None, "feed.h2d": "feed", "feed_planar": "feed",
          "dispatch": "feed_planar", "detect": "dispatch",
          "l2": "dispatch", "gate": "dispatch", "fetch": None,
          "drain": None, "drain.wait": "drain", "drain.verdicts": "drain",
          "fetch_host": "feed_planar", "finish": None}
SLOT = {name: 2 * i for i, name in enumerate(PARENT)}  # start; end at +1
_STAMPS = 2 * len(SLOT)
_CALLS = ("feed_planar", "finish")    # the calls a drain or finish runs in
_OUTER = ("drain", "finish")
_EVENT_AT_OPEN = {"detect": "start", "fetch": "fetch"}  # and STEPS at close

Span = namedtuple("Span", "name seq parent thread start end")
Span.__doc__ = """A host span: ``name``, the block's sequence number
``seq``, ``parent`` as (seq, name) or None, ``thread`` (MAIN or FETCH),
``start`` and ``end`` in time.perf_counter_ns()."""

_latest = None


def latest():
    """The span log of the newest pipeline built, or None."""
    return _latest


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
    CUDA graphs (``graphed``, core/graphs.py), and on CUDA the
    milliseconds of the device's timeline between its events: before
    and after each step (``detect_dev``, ``l2_dev``, ``gate_dev``) and
    from its last step to its fetch's first operation
    (``fetch_lag_dev``); None where not measured (``timed``: the record
    gets events)."""

    __slots__ = ("seq", "t", "outer", "frames", "fetch_bytes", "synced",
                 "profiled", "graphed", "detect_dev", "l2_dev", "gate_dev",
                 "fetch_lag_dev", "events")

    def __init__(self, seq: int, synced: bool, profiled: bool,
                 timed: bool):
        self.seq, self.synced, self.profiled = seq, synced, profiled
        self.graphed = False
        self.t = [None] * _STAMPS
        self.outer = self.frames = self.fetch_bytes = None
        self.detect_dev = self.l2_dev = self.gate_dev = None
        self.fetch_lag_dev = None
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
        elif name == "feed_planar" and self.t[SLOT["feed"]] is None:
            parent = None
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
        self.events = None
        return True


class SpanLog:
    """The block records of one pipeline on ``device``, the newest
    RING_BLOCKS kept, and the clock anchor ``anchor`` =
    (perf_counter_ns, time_ns) taken together at the start."""

    def __init__(self, device: torch.device):
        global _latest
        self.device = device
        self.blocks: deque = deque(maxlen=RING_BLOCKS)
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self._seq = 0
        self.current = None           # the record of the current call
        self._calls: list = []        # open feed_planar/finish (seq, name)
        self._synced = self._profiled = False    # of the current call
        self._ranges: dict = {}       # (seq, name) -> its record_function
        self._free: list = []         # resolved events, to record again
        self._streams: dict = {}      # current-stream key -> Stream
        self._cuda = device.type == "cuda"
        self._index = None
        if self._cuda:
            self._index = device.index if device.index is not None \
                else torch.cuda.current_device()
        _latest = self

    def new_block(self, synced: bool) -> Block:
        """A new record for the call that starts now (``synced``: it
        runs with ``step_ms``); checks once whether a profiler records,
        which decides the ``record_function`` ranges of the call's
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
        start records the event ``start``, the fetch's ``fetch``."""
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
        # the stamps enclose the record_function range, whose first
        # enter under a new profiler can take a millisecond
        blk.t[SLOT[name]] = time.perf_counter_ns()
        if on:
            rf = self._ranges[(blk.seq, name)] = record_function(
                "vdl2." + name)
            rf.__enter__()
        if blk.events is not None and name in _EVENT_AT_OPEN \
                and _EVENT_AT_OPEN[name] not in blk.events:
            self._event(blk, _EVENT_AT_OPEN[name])

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
        if self._ranges:
            rf = self._ranges.pop((blk.seq, name), None)
            if rf is not None:
                rf.__exit__(None, None, None)
        blk.t[SLOT[name] + 1] = time.perf_counter_ns()
        if name in _CALLS and self._calls:
            self._calls.pop()

    def fetch_enqueued(self, blk: Block) -> None:
        """``blk``'s fetch copy is enqueued now on this (the main)
        thread's stream, as for a graphed block (core/pipeline.py): the
        ``fetch`` event goes here, in stream order before the copy, and
        the fetch thread's span records none."""
        if blk.events is not None and self._cuda:
            self._event(blk, "fetch")

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
        """After ``blk``'s fetch copied ``out`` (a tuple of trees): its
        device times if its events have completed (after the copy they
        have; the events go back to the pool), and in a ``synced``
        record the bytes copied by part."""
        if blk.synced:
            blk.fetch_bytes = tuple(nbytes(part) for part in out)
        events = blk.events
        if events and blk._resolve():
            self._free.extend(events.values())

    def wall_ns(self, t: int) -> int:
        """perf_counter_ns ``t`` on the wall clock (time_ns), the clock
        of a torch profiler trace's ``ts`` + ``baseTimeNanoseconds``."""
        return self.anchor[1] + (t - self.anchor[0])
