"""Minimal Etsy-StatsD UDP push client (reference statsd.c equivalent).

Namespace is ``dumpvdl2_tpu[.<station_id>]``; counters, gauges and
timing metrics use the standard plaintext wire format.
"""
from __future__ import annotations

import socket
from typing import Optional


class StatsdClient:
    def __init__(self, addr: str, namespace: str = "dumpvdl2_tpu",
                 station_id: Optional[str] = None) -> None:
        if ":" not in addr:
            raise ValueError("statsd address must be host:port")
        host, port = addr.rsplit(":", 1)
        self._target = (host, int(port))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.prefix = namespace
        if station_id:
            self.prefix += "." + station_id.replace(":", "_")

    def _send(self, line: str) -> None:
        try:
            self._sock.sendto(line.encode(), self._target)
        except OSError:
            pass

    def increment(self, counter: str, n: int = 1) -> None:
        self._send(f"{self.prefix}.{counter}:{n}|c")

    def gauge(self, gauge: str, value: float) -> None:
        self._send(f"{self.prefix}.{gauge}:{value}|g")

    def timing(self, timer: str, ms: float) -> None:
        self._send(f"{self.prefix}.{timer}:{ms:.3f}|ms")
