"""Native host helpers: build and ctypes-load ``l2host.c`` at first use.

The port's copy of the JAX package's ``native/`` loader.  The library
compiles with the system C compiler (``$CC``, else ``cc``, ``gcc``,
``clang``; ``-O2 -shared -fPIC``) into ``_build/`` beside the CUDA
kernels, named by a hash of the source and the flags, and loads with
ctypes.  It computes the host's per-burst L2 tail: HDLC unstuffing
(``link/unstuff.py``), the AVLC FCS (``link/crc.py``) and the raw-frame
archive parse (``io/rawframes.py``).

One deliberate difference from the JAX loader, which returns None on
any failure: a library that cannot be built or loaded raises
RuntimeError with the compilers' messages.  ``DUMPVDL2_TPU_NATIVE=0``
is the one way to run the pure-Python spec, and then nothing is built.

``calls`` counts the calls each wrapper makes into the library, by C
function name, as the CUDA kernels' wrappers count their launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "l2host.c"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CFLAGS = ["-O2", "-shared", "-fPIC"]

calls = {"l2h_unstuff_frames": 0, "l2h_crc16_ccitt": 0,
         "l2h_parse_raw_frame": 0}

_lib: ctypes.CDLL | None = None
_tried = False
_LOCK = threading.Lock()


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return BUILD / f"l2host.{h.hexdigest()[:12]}.so"


def build() -> dict:
    """Compile ``l2host.c`` unless it is built already.

    Returns ``{"path", "compiler", "seconds"}`` (``compiler`` None when
    the library was there already).  Raises RuntimeError with every
    compiler's messages when none of them builds it.  The library is
    written to a temporary file and moved into place, so processes that
    build at once never load a partial file.
    """
    out = lib_path()
    if out.exists():
        return {"path": str(out), "compiler": None, "seconds": 0.0}
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    errors = []
    t0 = time.perf_counter()
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if not cc:
            continue
        try:
            r = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SRC)],
                               capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{cc}: {e}")
            continue
        if r.returncode == 0:
            os.replace(tmp, out)
            return {"path": str(out), "compiler": cc,
                    "seconds": time.perf_counter() - t0}
        errors.append(f"{cc} exited {r.returncode}:\n{r.stderr.strip()}")
    raise RuntimeError(
        f"cannot build the native host library {SRC.name}:\n"
        + "\n".join(errors)
        + "\n(DUMPVDL2_TPU_NATIVE=0 runs the pure-Python path instead)")


def load_l2host() -> ctypes.CDLL | None:
    """The native L2 helper library, built at first use; None when
    DUMPVDL2_TPU_NATIVE=0.  Raises RuntimeError when it cannot be built
    or loaded."""
    global _lib, _tried
    if _tried:
        return _lib
    with _LOCK:
        if not _tried:
            if os.environ.get("DUMPVDL2_TPU_NATIVE", "1") != "0":
                path = build()["path"]
                try:
                    lib = ctypes.CDLL(path)
                except OSError as e:
                    raise RuntimeError(f"cannot load the native host "
                                       f"library {path}: {e}") from e
                u8p = ctypes.POINTER(ctypes.c_uint8)
                i32p = ctypes.POINTER(ctypes.c_int32)
                lib.l2h_unstuff_frames.restype = ctypes.c_int32
                lib.l2h_unstuff_frames.argtypes = [
                    u8p, ctypes.c_int32, u8p, i32p, ctypes.c_int32, i32p]
                lib.l2h_crc16_ccitt.restype = ctypes.c_uint16
                # c_char_p lets ctypes pass Python bytes straight through
                # with no per-call cast/copy (the function only reads)
                lib.l2h_crc16_ccitt.argtypes = [
                    ctypes.c_char_p, ctypes.c_int32, ctypes.c_uint16]
                lib.l2h_descramble.restype = None
                lib.l2h_descramble.argtypes = [
                    u8p, ctypes.c_int32, ctypes.c_uint16]
                lib.l2h_parse_raw_frame.restype = ctypes.c_int32
                lib.l2h_parse_raw_frame.argtypes = [
                    ctypes.c_char_p, ctypes.c_int32, ctypes.c_void_p]
                _lib = lib
            _tried = True
    return _lib
