"""Metrics sink: in-process counters, optionally pushed to StatsD.

The reference pushes ~40 counter families to an Etsy StatsD daemon
(statsd.c).  Here a process-global sink collects the same counters;
``enable_statsd`` attaches a UDP push client (io/statsd_client.py).
A timer keeps its count and sum in the process; each sample goes to the
client as it comes.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional


class StatsSink:
    def __init__(self) -> None:
        self.counters: dict[str, int] = defaultdict(int)
        self.gauges: dict[str, float] = {}
        # timer -> [count, sum of ms]
        self.timings: dict[str, list] = defaultdict(lambda: [0, 0.0])
        self._client = None   # optional statsd pusher
        # (freq, counter) -> prebuilt key: the f-string build was
        # measurable in bulk replay (a few per frame)
        self._chan_keys: dict[tuple, str] = {}

    def attach_client(self, client) -> None:
        self._client = client

    def increment(self, counter: str, n: int = 1) -> None:
        self.counters[counter] += n
        if self._client is not None:
            self._client.increment(counter, n)

    def increment_per_channel(self, freq: int, counter: str, n: int = 1) -> None:
        key = self._chan_keys.get((freq, counter))
        if key is None:
            key = f"channels.{freq}.{counter}"
            self._chan_keys[(freq, counter)] = key
        self.increment(key, n)

    def increment_per_msgdir(self, msg_dir: str, counter: str) -> None:
        self.increment(f"msg_dir.{msg_dir}.{counter}")

    def gauge_set(self, gauge: str, value: float) -> None:
        self.gauges[gauge] = value
        if self._client is not None:
            self._client.gauge(gauge, value)

    def timing(self, timer: str, ms: float) -> None:
        t = self.timings[timer]
        t[0] += 1
        t[1] += ms
        if self._client is not None:
            self._client.timing(timer, ms)

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.timings.clear()


stats = StatsSink()
