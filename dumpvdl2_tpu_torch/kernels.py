"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C entry point, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  Builds
happen at first use into ``_build/`` beside this file, named by a hash
of the source and the flags so a changed source never loads a stale
library.
:func:`build_all` starts one ``nvcc`` per source, all at once;
:func:`build_file` builds any other source (a variant under test) the
same way.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{src.stem}.{h.hexdigest()[:12]}.so"


def _start_build(src: Path) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _lib_path(src)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(src: Path, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, dict]:
    """Compile every kernel source in parallel (one nvcc each).

    Returns ``{name: {"seconds": wall seconds of the whole build,
    "log": nvcc's -Xptxas -v report}}``; already built sources report
    an empty log.
    """
    t0 = time.perf_counter()
    with _LOCK:
        jobs = {n: _start_build(CSRC / f"{n}.cu") for n in sources()}
        logs = {n: _finish_build(CSRC / f"{n}.cu", j) if j is not None
                else "" for n, j in jobs.items()}
    dt = time.perf_counter() - t0
    return {n: {"seconds": dt, "log": logs[n]} for n in logs}


def build_file(src: Path) -> tuple[Path, str]:
    """Build one CUDA source, at any path, as the kernels are built.

    Returns the library's path and nvcc's -Xptxas -v report (empty if
    it was built already).
    """
    with _LOCK:
        job = _start_build(src)
        log = _finish_build(src, job) if job is not None else ""
    return _lib_path(src), log


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path, _ = build_file(CSRC / f"{name}.cu")
        lib = _LIBS.setdefault(name, ctypes.CDLL(str(path)))
    return lib
