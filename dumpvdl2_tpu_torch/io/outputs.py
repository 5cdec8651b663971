"""Output sinks and the formatter x output dispatch matrix.

Mirrors the reference's pluggable output layer (output-common.c,
output-{file,udp,zmq}.c, dumpvdl2.c:200-321):

* output spec strings ``<intype>:<format>:<type>:<k=v,...>``,
* one worker thread per output instance with a bounded queue
  (high-water-mark drop + "throttling" warning),
* file output with append mode and hourly/daily rotation (suffix
  ``_YYYYMMDD[_HH]`` inserted before the extension),
* UDP fire-and-forget and ZMQ PUB (server=bind / client=connect),
* binary framing: big-endian u16 length prefix including itself.
"""
from __future__ import annotations

import os
import queue
import socket
import struct
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..config import Config
from ..utils.debug import D_OUTPUT, debug_print
from ..core.metadata import MsgMetadata


class OutputError(Exception):
    pass


def kvargs_from_string(spec: str) -> dict[str, str]:
    """Parse ``k1=v1,k2=v2`` (kvargs.c:54-96)."""
    kv: dict[str, str] = {}
    if not spec:
        return kv
    for part in spec.split(","):
        if not part:
            continue
        if "=" not in part:
            raise OutputError(f"kvargs: no value for key {part!r}")
        k, v = part.split("=", 1)
        if not k:
            raise OutputError("kvargs: empty key")
        if not v:
            raise OutputError(f"kvargs: no value for key {k!r}")
        kv[k] = v
    return kv


class Output:
    """Base output instance; subclasses implement produce()."""
    name = "base"
    supported_formats: tuple[str, ...] = ()

    def __init__(self, kv: dict[str, str], fmt: str) -> None:
        self.format = fmt
        self.active = True
        self.q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None

    def init(self) -> None:
        pass

    def produce(self, metadata: Optional[MsgMetadata], msg: bytes) -> None:
        raise NotImplementedError

    def handle_shutdown(self) -> None:
        pass

    def handle_failure(self) -> None:
        pass

    # --------------------------------------------------------- thread loop
    def start(self) -> None:
        self.init()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:                     # ordered shutdown sentinel
                self.handle_shutdown()
                self.active = False
                return
            metadata, msg = item
            try:
                self.produce(metadata, msg)
            except Exception as exc:             # noqa: BLE001
                print(f"{self.name} output failed: {exc}; deactivating",
                      file=sys.stderr)
                self.handle_failure()
                self.active = False
                # drain remaining entries
                while True:
                    try:
                        if self.q.get_nowait() is None:
                            return
                    except queue.Empty:
                        return

    def push(self, metadata: Optional[MsgMetadata], msg: Optional[bytes],
             shutdown: bool = False) -> None:
        if shutdown:
            self.q.put(None)
            return
        if not self.active:
            return
        hwm = Config.output_queue_hwm
        if hwm and self.q.qsize() >= hwm:
            print(f"{self.name} output queue overflow, throttling",
                  file=sys.stderr)
            return
        debug_print(D_OUTPUT, "%s: queue message (%d bytes)",
                    self.name, len(msg) if msg else 0)
        self.q.put((metadata, msg))

    def join(self, timeout: float = 10.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout)


class FileOutput(Output):
    name = "file"
    supported_formats = ("text", "json", "pp_acars", "binary")

    def __init__(self, kv: dict[str, str], fmt: str) -> None:
        super().__init__(kv, fmt)
        self.path = kv.get("path", "-")
        rotate = kv.get("rotate", "")
        if rotate not in ("", "hourly", "daily"):
            raise OutputError(f"invalid rotate value: {rotate!r}")
        if rotate and self.path == "-":
            raise OutputError("rotate not supported on standard output")
        self.rotate = rotate
        self._fh = None
        self._open_hour = None

    def _suffixed_path(self, now: float) -> str:
        if not self.rotate:
            return self.path
        tm = time.gmtime(now) if Config.utc else time.localtime(now)
        suffix = time.strftime("_%Y%m%d", tm)
        if self.rotate == "hourly":
            suffix += time.strftime("_%H", tm)
        base, ext = os.path.splitext(self.path)
        return base + suffix + ext

    def _current_period(self, now: float) -> int:
        if self.rotate == "hourly":
            return int(now // 3600)
        return int(now // 86400)

    def init(self) -> None:
        self._open(time.time())

    def _open(self, now: float) -> None:
        if self.path == "-":
            self._fh = sys.stdout.buffer
        else:
            self._fh = open(self._suffixed_path(now), "ab")
        self._open_hour = self._current_period(now)

    def produce(self, metadata, msg: bytes) -> None:
        now = time.time()
        if self.rotate and self._current_period(now) != self._open_hour:
            self._fh.close()
            self._open(now)
        if self.format == "binary":
            self._fh.write(struct.pack(">H", len(msg) + 2))
            self._fh.write(msg)
        else:
            self._fh.write(msg)
            if self.format in ("text", "json", "pp_acars"):
                self._fh.write(b"\n")
        self._fh.flush()

    def handle_shutdown(self) -> None:
        if self._fh is not None and self.path != "-":
            self._fh.close()


class UdpOutput(Output):
    name = "udp"
    supported_formats = ("text", "json", "pp_acars", "binary")

    def __init__(self, kv: dict[str, str], fmt: str) -> None:
        super().__init__(kv, fmt)
        if "address" not in kv or "port" not in kv:
            raise OutputError("udp output requires address= and port=")
        self.address = kv["address"]
        self.port = int(kv["port"])
        self._sock: Optional[socket.socket] = None

    def init(self) -> None:
        infos = socket.getaddrinfo(self.address, self.port,
                                   type=socket.SOCK_DGRAM)
        family, type_, proto, _cname, sockaddr = infos[0]
        self._sock = socket.socket(family, type_, proto)
        self._sock.connect(sockaddr)

    def produce(self, metadata, msg: bytes) -> None:
        try:
            self._sock.send(msg)
        except OSError:
            pass                                 # fire and forget

    def handle_shutdown(self) -> None:
        if self._sock is not None:
            self._sock.close()


class ZmqOutput(Output):
    name = "zmq"
    supported_formats = ("text", "json", "pp_acars", "binary")

    def __init__(self, kv: dict[str, str], fmt: str) -> None:
        super().__init__(kv, fmt)
        if "endpoint" not in kv or "mode" not in kv:
            raise OutputError("zmq output requires endpoint= and mode=")
        if kv["mode"] not in ("server", "client"):
            raise OutputError("zmq mode must be server or client")
        self.endpoint = kv["endpoint"]
        self.mode = kv["mode"]
        self._sock = None
        self._ctx = None

    def init(self) -> None:
        import zmq
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.PUB)
        if Config.output_queue_hwm:
            self._sock.setsockopt(zmq.SNDHWM, Config.output_queue_hwm)
        if self.mode == "server":
            self._sock.bind(self.endpoint)
        else:
            self._sock.connect(self.endpoint)

    def produce(self, metadata, msg: bytes) -> None:
        self._sock.send(msg)

    def handle_shutdown(self) -> None:
        # linger long enough to flush queued PUB messages on exit —
        # close(0) would silently drop everything still in flight
        if self._sock is not None:
            self._sock.close(linger=2000)


OUTPUTS = {
    "file": FileOutput,
    "udp": UdpOutput,
    "zmq": ZmqOutput,
}


@dataclass
class FormatterInstance:
    descriptor: object                 # FormatterDescriptor
    intype: str                        # "decoded" | "raw"
    outputs: list[Output] = field(default_factory=list)


def output_params_from_string(spec: str
                              ) -> tuple[str, str, str, dict[str, str]]:
    """Split ``intype:format:type:k=v,...`` (dumpvdl2.c:200-238)."""
    parts = spec.split(":", 3)
    if len(parts) < 3:
        raise OutputError(
            f"invalid output spec {spec!r}: expected "
            "<intype>:<format>:<type>[:<options>]")
    intype, fmt, outtype = parts[0], parts[1], parts[2]
    kv = kvargs_from_string(parts[3]) if len(parts) == 4 else {}
    return intype, fmt, outtype, kv


def setup_output(spec: str, fmtr_list: list[FormatterInstance]
                 ) -> list[FormatterInstance]:
    """Instantiate one output spec, reusing formatter instances."""
    from .formatters import formatter_get
    intype, fmt, outtype, kv = output_params_from_string(spec)
    if intype not in ("decoded", "raw"):
        raise OutputError(f"unknown input type: {intype!r}")
    fd = formatter_get(fmt)
    if not fd.supports_data_type(intype):
        raise OutputError(
            f"format {fmt!r} does not support {intype!r} input")
    if outtype not in OUTPUTS:
        raise OutputError(f"unknown output type: {outtype!r}")
    cls = OUTPUTS[outtype]
    if fmt not in cls.supported_formats:
        raise OutputError(f"output {outtype!r} does not support "
                          f"format {fmt!r}")
    output = cls(kv, fmt)
    inst = next((f for f in fmtr_list
                 if f.descriptor is fd and f.intype == intype), None)
    if inst is None:
        inst = FormatterInstance(descriptor=fd, intype=intype)
        fmtr_list.append(inst)
    inst.outputs.append(output)
    return fmtr_list
