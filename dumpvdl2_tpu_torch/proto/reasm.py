"""Fragment reassembly engines.

The reference relies on two engines with different keying models
(decode.c:431-442):

* sequence-number based (libacars ``la_reasm_*``): X.25 M-bit chains,
  COTP DT/ED chains, multi-block ACARS; fragments arrive in order with
  a wrapping sequence counter and a final-fragment marker;
* offset based (reference reassembly.c): CLNP segmentation, where each
  fragment carries a byte offset and the total length comes from the
  final fragment.

Both engines here share timeout-based expiry and the same status
vocabulary so formatters can render identical "reasm status" fields.

Expiry semantics: an entry's staleness is decided PER KEY at access
time (``rx_time - first_seen > timeout`` → the stale entry is dropped
and the fragment starts a fresh sequence).  The table-wide ``_expire``
sweep only reclaims memory; it can never change a decode outcome for a
time-monotonic stream, because any entry it removes would fail the
access-time check anyway.  This makes reassembly decisions depend only
on each conversation's own fragment times — a property the parallel
decoder (app/parallel_decoder.py) relies on: sharding conversations
across workers cannot change any decision.  (The reference instead
expires entries during periodic table sweeps, reassembly.c:215-350, so
its outcomes near the timeout boundary depend on unrelated traffic;
ours are deterministic per conversation.)
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Optional


class ReasmStatus(enum.Enum):
    UNKNOWN = "unknown"
    COMPLETE = "complete"
    IN_PROGRESS = "in progress"
    SKIPPED = "skipped"
    DUPLICATE = "duplicate"
    FRAG_OUT_OF_SEQUENCE = "out of sequence"
    ARGS_INVALID = "invalid args"
    # offset-engine specific
    OVERLAP = "fragment overlap"
    BOGUS_FINAL = "bogus final fragment"
    BAD_LEN = "bad length"


SEQ_FIRST_NONE = -1


@dataclass
class _SeqEntry:
    fragments: list[bytes] = field(default_factory=list)
    prev_seq: int = SEQ_FIRST_NONE
    first_seen: float = 0.0
    timeout: float = 0.0
    total_len: int = 0


class SeqReasmTable:
    """Sequence-based reassembly for one protocol."""

    def __init__(self, seq_wrap: int = -1) -> None:
        self.entries: dict[Hashable, _SeqEntry] = {}
        self.seq_wrap = seq_wrap

    def _expire(self, now: float) -> None:
        dead = [k for k, e in self.entries.items()
                if e.timeout > 0 and now - e.first_seen > e.timeout]
        for k in dead:
            del self.entries[k]

    def add_fragment(self, key: Hashable, data: bytes, seq_num: int,
                     is_final: bool, rx_time: float, timeout: float,
                     seq_num_first: int = SEQ_FIRST_NONE,
                     seq_num_wrap: int = -1) -> ReasmStatus:
        self._expire(rx_time)
        entry = self.entries.get(key)
        if entry is not None and entry.timeout > 0 \
                and rx_time - entry.first_seen > entry.timeout:
            del self.entries[key]          # stale: start fresh
            entry = None
        if entry is None:
            # A lone final fragment needs no reassembly at all.
            if is_final:
                if seq_num_first != SEQ_FIRST_NONE and seq_num != seq_num_first:
                    return ReasmStatus.SKIPPED
                return ReasmStatus.SKIPPED
            if seq_num_first != SEQ_FIRST_NONE and seq_num != seq_num_first:
                return ReasmStatus.SKIPPED
            entry = _SeqEntry(first_seen=rx_time, timeout=timeout,
                              prev_seq=seq_num)
            entry.fragments.append(bytes(data))
            self.entries[key] = entry
            return ReasmStatus.IN_PROGRESS
        wrap = seq_num_wrap if seq_num_wrap > 0 else self.seq_wrap
        expected = entry.prev_seq + 1
        if wrap > 0:
            expected %= wrap
        if seq_num == entry.prev_seq:
            return ReasmStatus.DUPLICATE
        if seq_num != expected:
            del self.entries[key]
            return ReasmStatus.FRAG_OUT_OF_SEQUENCE
        entry.fragments.append(bytes(data))
        entry.prev_seq = seq_num
        if is_final:
            return ReasmStatus.COMPLETE
        return ReasmStatus.IN_PROGRESS

    def payload_get(self, key: Hashable) -> Optional[bytes]:
        entry = self.entries.pop(key, None)
        if entry is None:
            return None
        return b"".join(entry.fragments)


@dataclass
class _OffsetFragment:
    offset: int
    data: bytes


@dataclass
class _OffsetEntry:
    fragments: list[_OffsetFragment] = field(default_factory=list)
    total_len: int = -1
    first_seen: float = 0.0
    timeout: float = 0.0


class OffsetReasmTable:
    """Offset-based reassembly (reference reassembly.c:215-404)."""

    def __init__(self) -> None:
        self.entries: dict[Hashable, _OffsetEntry] = {}

    def _expire(self, now: float) -> None:
        dead = [k for k, e in self.entries.items()
                if e.timeout > 0 and now - e.first_seen > e.timeout]
        for k in dead:
            del self.entries[k]

    def add_fragment(self, key: Hashable, data: bytes, offset: int,
                     is_final: bool, total_len: int, rx_time: float,
                     timeout: float) -> ReasmStatus:
        self._expire(rx_time)
        if offset < 0 or (is_final and total_len < offset + len(data)):
            return ReasmStatus.ARGS_INVALID
        entry = self.entries.get(key)
        if entry is not None and entry.timeout > 0 \
                and rx_time - entry.first_seen > entry.timeout:
            del self.entries[key]          # stale: start fresh
            entry = None
        if entry is None:
            if offset == 0 and is_final:
                return ReasmStatus.SKIPPED  # unfragmented PDU
            entry = _OffsetEntry(first_seen=rx_time, timeout=timeout)
            self.entries[key] = entry
        for frag in entry.fragments:
            if frag.offset == offset:
                del_status = (ReasmStatus.DUPLICATE
                              if frag.data == bytes(data)
                              else ReasmStatus.OVERLAP)
                if del_status is ReasmStatus.OVERLAP:
                    del self.entries[key]
                return del_status
            if frag.offset < offset < frag.offset + len(frag.data) or \
                    offset < frag.offset < offset + len(data):
                del self.entries[key]
                return ReasmStatus.OVERLAP
        entry.fragments.append(_OffsetFragment(offset, bytes(data)))
        if is_final:
            if entry.total_len >= 0:
                del self.entries[key]
                return ReasmStatus.BOGUS_FINAL
            entry.total_len = offset + len(data)
        if entry.total_len >= 0:
            have = sum(len(f.data) for f in entry.fragments)
            if have == entry.total_len:
                return ReasmStatus.COMPLETE
            if have > entry.total_len:
                del self.entries[key]
                return ReasmStatus.BAD_LEN
        return ReasmStatus.IN_PROGRESS

    def payload_get(self, key: Hashable) -> Optional[bytes]:
        entry = self.entries.pop(key, None)
        if entry is None:
            return None
        frags = sorted(entry.fragments, key=lambda f: f.offset)
        out = bytearray()
        for f in frags:
            if f.offset != len(out):
                return None
            out.extend(f.data)
        return bytes(out)


class ReasmContexts:
    """Both engines bundled, keyed per protocol (decode.c reasm_contexts)."""

    def __init__(self) -> None:
        self._seq_tables: dict[str, SeqReasmTable] = {}
        self._offset_tables: dict[str, OffsetReasmTable] = {}

    def seq_table(self, proto: str) -> SeqReasmTable:
        if proto not in self._seq_tables:
            self._seq_tables[proto] = SeqReasmTable()
        return self._seq_tables[proto]

    def offset_table(self, proto: str) -> OffsetReasmTable:
        if proto not in self._offset_tables:
            self._offset_tables[proto] = OffsetReasmTable()
        return self._offset_tables[proto]
