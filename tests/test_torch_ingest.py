"""Raw-sample ingest: ``VDL2Pipeline.feed_raw`` and
``io/iqfile.py::feed_iq_file`` against the JAX package's file reader
(``dumpvdl2_tpu/io/iqfile.py``) and the port's host path.

* ``feed_raw``'s planar blocks are bit for bit those of the JAX
  package's ``iq_blocks`` (``dequantize_block``) on the same reads, cut
  as ``feed`` cuts them, and those of the port's ``iq_blocks`` +
  ``feed``, for U8 and S16_LE: every U8 value, the S16 extremes, reads
  of odd byte counts and of lengths that are no multiple of the
  oversample factor, a residual and a partial sample pair carried over
  many calls.
* ``feed_iq_file`` gives the frames and metadata of the JAX package's
  ``iq_blocks`` blocks fed through ``feed`` on a synthesized scene, at
  three read sizes and from a reader that returns short reads; the mesh
  gets ``iq_blocks``' blocks through its ``feed``.
* The span log holds the read, ``feed_raw`` and its ``feed.h2d``, and
  the input's counts.
* On the card (``cuda``): kernel KI equals its plain twin and launches
  once a block.

The JAX package is imported inside the CPU tests only: the ``cuda``
tests run where it is not installed.
"""
import dataclasses
import io

import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
from dumpvdl2_tpu_torch.dsp import ingest_kernel
from dumpvdl2_tpu_torch.dsp.frontend import to_planar
from dumpvdl2_tpu_torch.io import iqfile
from dumpvdl2_tpu_torch.sim import synthesize_iq_raw

OS = 10
CENTER = 136975000
FREQS = [CENTER + 25000, CENTER, CENTER - 25000]


def _jax_iqfile():
    """The JAX package's raw-file reader, the reference."""
    from dumpvdl2_tpu.io import iqfile as jax_iqfile
    return jax_iqfile


def _planar(iq: np.ndarray) -> np.ndarray:
    return np.stack([iq.real, iq.imag]).astype(np.float32)


def _jax_blocks(data: bytes, fmt: str, sizes) -> list:
    """The planar blocks of the JAX package's ``iq_blocks`` on reads of
    ``sizes`` bytes (cycled), each after the samples the one before left
    over and cut at the largest multiple of the oversample factor, as
    ``feed`` cuts them."""
    out, rest = [], np.zeros(0, np.complex64)
    for blk in _jax_iqfile().iq_blocks(_Reads(data, sizes), fmt):
        both = np.concatenate([rest, blk])
        n = both.size // OS * OS
        rest = both[n:]
        if n:
            out.append(_planar(both[:n]))
    return out


def _pipe(device="cpu"):
    return VDL2Pipeline(FREQS, CENTER, 105000 * OS, OS, device=device)


def _blocks(monkeypatch, run) -> list:
    """The planar blocks ``run(pipe)`` hands to the pipeline's steps (on
    a pipeline whose steps are stubbed out)."""
    got = []

    def feed_planar(self, iq, eof, blk):
        if iq.shape[1]:
            got.append(torch.as_tensor(iq).cpu().numpy().copy())
        return []
    monkeypatch.setattr(VDL2Pipeline, "_feed_planar", feed_planar)
    run(_pipe())
    return got


def _host_blocks(monkeypatch, data: bytes, fmt: str, sizes) -> list:
    """Today's path on reads of ``sizes`` bytes (cycled): iq_blocks,
    which carries a partial pair into the next read, and feed."""
    def run(pipe):
        for blk in iqfile.iq_blocks(_Reads(data, sizes), fmt):
            pipe.feed(blk)
    return _blocks(monkeypatch, run)


class _Reads:
    """A stream whose read(n) returns the next of ``sizes`` bytes
    (cycled), whatever n: a raw stream with short reads."""

    def __init__(self, data: bytes, sizes):
        self.data, self.sizes, self.pos, self.i = data, list(sizes), 0, 0

    def _next(self, n: int) -> int:
        k = min(n, self.sizes[self.i % len(self.sizes)],
                len(self.data) - self.pos)
        self.i += 1
        return k

    def read(self, n: int = -1) -> bytes:
        k = self._next(n if n >= 0 else len(self.data))
        out = self.data[self.pos:self.pos + k]
        self.pos += k
        return out

    def readinto(self, b) -> int:
        k = self._next(len(b))
        b[:k] = self.data[self.pos:self.pos + k]
        self.pos += k
        return k


def _chunks(data: bytes, sizes):
    pos, i = 0, 0
    while pos < len(data):
        k = sizes[i % len(sizes)]
        yield data[pos:pos + k]
        pos, i = pos + k, i + 1


def _raw(fmt: str, n_pairs: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if fmt == "U8":
        return rng.integers(0, 256, 2 * n_pairs, dtype=np.uint8).tobytes()
    v = rng.integers(-32768, 32768, 2 * n_pairs).astype("<i2")
    v[:4] = [-32768, 32767, 0, -1]
    return v.tobytes()


def test_u8_every_value_and_s16_extremes():
    """The plain twin against the JAX package's dequantize_block, and
    the port's dequantize_block + to_planar."""
    u8 = bytes(range(256))
    s16 = np.array([-32768, 32767, 0, -1, 1, 12345, -12345, 2],
                   "<i2").tobytes()
    for fmt, data in (("U8", u8), ("S16_LE", s16)):
        block, res = ingest_kernel.ingest_plain(
            torch.frombuffer(bytearray(data), dtype=torch.uint8), b"", fmt,
            torch.zeros((2, 0)), 1)
        want = _planar(_jax_iqfile().dequantize_block(data, fmt))
        port = to_planar(iqfile.dequantize_block(data, fmt))
        assert res.shape == (2, 0)
        assert np.array_equal(block.numpy().view(np.uint32),
                              want.view(np.uint32))
        assert np.array_equal(block.numpy().view(np.uint32),
                              port.view(np.uint32))


@pytest.mark.parametrize("fmt,sizes", [
    ("U8", [1001]),                       # odd bytes: a pair split
    ("U8", [333, 7, 2048, 1]),
    ("S16_LE", [1003, 4001, 3]),          # a value split, then a pair
    ("S16_LE", [4000, 1236]),             # whole pairs, ragged blocks
])
def test_feed_raw_blocks_are_the_host_path(fmt, sizes, monkeypatch):
    data = _raw(fmt, 9000, seed=len(sizes))
    want = _jax_blocks(data, fmt, sizes)
    port = _host_blocks(monkeypatch, data, fmt, sizes)

    def raw(pipe):
        for chunk in _chunks(data, sizes):
            pipe.feed_raw(torch.frombuffer(bytearray(chunk),
                                           dtype=torch.uint8), fmt)
    got = _blocks(monkeypatch, raw)
    assert len(got) == len(want) == len(port) > 3
    for a, b, c in zip(got, want, port):
        assert a.shape == b.shape and a.shape[1] % OS == 0
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
        assert np.array_equal(a.view(np.uint32), c.view(np.uint32))


def test_feed_raw_takes_a_numpy_array(monkeypatch):
    data = _raw("S16_LE", 2000, seed=5)
    want = _jax_blocks(data, "S16_LE", [len(data)])
    port = _host_blocks(monkeypatch, data, "S16_LE", [len(data)])
    buf = np.frombuffer(data, "<i2").copy()
    got = _blocks(monkeypatch, lambda p: p.feed_raw(buf, "S16_LE"))
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    assert [g.tobytes() for g in got] == [w.tobytes() for w in port]


# ------------------------------------------------------------ the file path
def _scene() -> bytes:
    """S16_LE bytes of a 3-channel scene at oversample 10: noise and six
    bursts, two of them across the reads' boundaries."""
    n = 720_000
    rng = np.random.default_rng(11)
    sig = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
           * 0.007).astype(np.complex64)
    for k, (at, ch) in enumerate([(30_000, 0), (150_000, 1), (230_000, 2),
                                  (330_000, 0), (470_000, 2),
                                  (560_000, 1)]):
        b = synthesize_iq_raw([b"ingest test burst %d " % k * 3],
                              oversample=OS,
                              carrier_offset_hz=FREQS[ch] - CENTER, seed=k)
        sig[at:at + b.size] += b * 0.3
    inter = np.empty(2 * n, np.float32)
    inter[0::2], inter[1::2] = sig.real, sig.imag
    return (np.clip(inter, -1, 1) * 32767).astype("<i2").tobytes()


class _Collect:
    def __init__(self):
        self.frames = []

    def process_all(self, frames):
        self.frames.extend(frames)


def _frames(run) -> list:
    dec = _Collect()
    run(_pipe(), dec)
    return [(bytes(f.frame), dataclasses.replace(f.metadata,
                                                 burst_timestamp=0.0))
            for f in dec.frames]


@pytest.fixture(scope="module")
def scene_frames():
    """The scene's bytes and its frames through the JAX package's
    iq_blocks (whose blocks are the port's) + feed at each read size (on
    one torch thread, as the tests run: the thread count changes the
    channelizer's sums)."""
    data = _scene()
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for size in (480_000, 262_147, 1 << 20):
            blocks = list(_jax_iqfile().iq_blocks(
                io.BytesIO(data), "S16_LE", bufsize=size))
            port = iqfile.iq_blocks(io.BytesIO(data), "S16_LE",
                                    bufsize=size)
            assert [b.tobytes() for b in blocks] == \
                [b.tobytes() for b in port]

            def today(pipe, dec, blocks=blocks):
                for blk in blocks:
                    dec.process_all(pipe.feed(blk))
                dec.process_all(pipe.finish())
            out[size] = _frames(today)
    finally:
        torch.set_num_threads(threads)
    return data, out


@pytest.mark.parametrize("size", [480_000, 262_147, 1 << 20])
def test_feed_iq_file_frames_are_the_host_path(size, scene_frames):
    data, want = scene_frames
    assert len(want[size]) >= 6
    got = _frames(lambda p, d: iqfile.feed_iq_file(
        p, d, io.BytesIO(data), "S16_LE", read_bytes=size))
    assert got == want[size]


def test_feed_iq_file_fills_short_reads(scene_frames):
    data, want = scene_frames
    got = _frames(lambda p, d: iqfile.feed_iq_file(
        p, d, _Reads(data, [65_537, 3, 100_000]), "S16_LE",
        read_bytes=480_000))
    assert got == want[480_000]


def test_the_mesh_reads_through_iq_blocks_and_feed(monkeypatch):
    from dumpvdl2_tpu_torch.core.mesh_pipeline import MeshPipeline
    fed = []
    monkeypatch.setattr(MeshPipeline, "feed",
                        lambda self, iq, eof=False: fed.append(iq) or [])
    monkeypatch.setattr(MeshPipeline, "finish", lambda self: [])
    pipe = MeshPipeline(FREQS, CENTER, 105000 * OS, OS, mesh_shape=(1, 2),
                        devices=[torch.device("cpu")] * 2)
    data = _raw("S16_LE", 3000, seed=6)
    iqfile.feed_iq_file(pipe, _Collect(), io.BytesIO(data), "S16_LE",
                        read_bytes=5002)
    want = list(_jax_iqfile().iq_blocks(io.BytesIO(data), "S16_LE", 5002))
    port = list(iqfile.iq_blocks(io.BytesIO(data), "S16_LE", 5002))
    assert len(fed) == len(want) == len(port) == 3
    assert all(np.array_equal(a, b) for a, b in zip(fed, want))
    assert all(np.array_equal(a, b) for a, b in zip(fed, port))


def _mesh_feeds(monkeypatch):
    """A (1, 2) mesh on the CPU whose feed and finish are stubbed: the
    blocks feed got, and the stream's finish() calls."""
    from dumpvdl2_tpu_torch.core.mesh_pipeline import MeshPipeline
    fed, finished = [], []
    monkeypatch.setattr(MeshPipeline, "feed", lambda self, iq, eof=False:
                        fed.append(iq) or [len(fed)])
    monkeypatch.setattr(MeshPipeline, "finish",
                        lambda self: finished.append(1) or ["eof"])
    pipe = MeshPipeline(FREQS, CENTER, 105000 * OS, OS, mesh_shape=(1, 2),
                        devices=[torch.device("cpu")] * 2)
    return pipe, fed, finished


@pytest.mark.parametrize("stop_after,n_blocks", [(None, 5), (2, 2)])
def test_the_mesh_feed_raw_carries_odd_reads_and_stops(
        stop_after, n_blocks, monkeypatch):
    """U8 reads of an odd byte count: the split pair carried into the
    next read; a stop between two blocks; finish() once."""
    data = _raw("U8", 5000, seed=3)
    pipe, fed, finished = _mesh_feeds(monkeypatch)
    dec = _Collect()
    iqfile.feed_iq_file(
        pipe, dec, io.BytesIO(data), "U8", read_bytes=2001,
        stop=None if stop_after is None
        else lambda: len(fed) >= stop_after)
    want = list(_jax_iqfile().iq_blocks(io.BytesIO(data), "U8", 2001))
    assert len(fed) == n_blocks and finished == [1]
    for a, b in zip(fed, want):
        assert np.array_equal(a, b)
    assert dec.frames == list(range(1, n_blocks + 1)) + ["eof"]


def test_span_log_holds_the_read_and_the_ingest(monkeypatch):
    data = _raw("S16_LE", 8000, seed=9)
    pipe = _pipe()
    monkeypatch.setattr(VDL2Pipeline, "_feed_planar",
                        lambda self, iq, eof, blk: [])
    iqfile.feed_iq_file(pipe, _Collect(), io.BytesIO(data), "S16_LE",
                        read_bytes=12_000, finish=False)
    log = pipe.span_log
    assert log.counts == {"read_bytes": len(data), "staging_waits": 0}
    recs = list(log.blocks)
    assert len(recs) == -(-len(data) // 12_000)
    for b in recs:
        names = {s.name: s for s in b.spans}
        assert {"read", "feed_raw", "feed.h2d"} <= set(names)
        assert names["feed.h2d"].parent == (b.seq, "feed_raw")
        assert names["read"].end <= names["feed_raw"].start
        assert b.ms("read") >= 0 and b.ingest_dev is None   # no events


def test_staging_buffers_are_kept_across_calls():
    """feed_iq_file's buffers are the pipeline's, made once for a read
    size: a file fed in several calls pins them once."""
    pipe = _pipe()
    bufs, events = pipe.staging(12_000)
    assert [b.numel() for b in bufs] == [12_000, 12_000]
    assert events == [None, None]                 # no device: no copy
    data = _raw("S16_LE", 8000, seed=10)
    fh = io.BytesIO(data)
    for i in (1, 2):
        iqfile.feed_iq_file(pipe, _Collect(), fh, "S16_LE",
                            read_bytes=12_000, finish=False,
                            stop=lambda: fh.tell() >= 12_000 * i)
    assert pipe.staging(12_000)[0] is bufs
    assert pipe.span_log.counts["read_bytes"] == 24_000
    assert pipe.staging(4_000)[0][0].numel() == 4_000


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_kernel_equals_its_twin_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cases = []
    for fmt in ("U8", "S16_LE"):
        w = ingest_kernel.pair_bytes(fmt)
        # (bytes, pend, residual columns, oversample): aligned wideband,
        # ragged, pending bytes, a residual, a tiny buffer
        for nbytes, pend, R, os_ in ((4194240 * w, b"", 0, 80),
                                     (1 << 20, b"", 48, 80),
                                     (12_345, b"\x07" * (w - 1), 13, 10),
                                     (3, b"\x01", 5, 10),
                                     (256 * w, b"", 0, 1)):
            cases.append((fmt, nbytes, pend[:w - 1], R, os_))
    for i, (fmt, nbytes, pend, R, os_) in enumerate(cases):
        rng = np.random.default_rng(i)
        raw = torch.from_numpy(rng.integers(0, 256, nbytes, dtype=np.uint8))
        if fmt == "U8" and nbytes == 256 * 2:
            raw[:256] = torch.arange(256, dtype=torch.uint8)
        res = torch.randn((2, R))
        want = ingest_kernel.ingest_plain(raw, pend, fmt, res, os_)
        n0 = ingest_kernel.launches
        got = ingest_kernel.ingest(raw.to(dev), pend, fmt, res.to(dev), os_)
        torch.cuda.synchronize(dev)
        assert ingest_kernel.launches == n0 + 1
        for g, w_ in zip(got, want):
            assert g.shape == w_.shape, (fmt, nbytes)
            assert torch.equal(g.cpu().view(torch.int32),
                               w_.view(torch.int32)), (fmt, nbytes, R)


@pytest.mark.cuda
def test_feed_raw_on_the_card_launches_once_a_block(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data = _raw("S16_LE", 40_000, seed=4)
    sizes = [40_002, 30_001]
    want = _host_blocks(monkeypatch, data, "S16_LE", sizes)
    got = []

    def feed_planar(self, iq, eof, blk):
        if iq.shape[1]:
            got.append(iq.cpu().numpy().copy())
        return []
    monkeypatch.setattr(VDL2Pipeline, "_feed_planar", feed_planar)
    pipe = _pipe("cuda")
    n0 = ingest_kernel.launches
    calls = 0
    for chunk in _chunks(data, sizes):
        host = torch.frombuffer(bytearray(chunk),
                                dtype=torch.uint8).pin_memory()
        pipe.feed_raw(host, "S16_LE")
        calls += 1
    assert ingest_kernel.launches == n0 + calls
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
