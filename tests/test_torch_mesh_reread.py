"""PyTorch port vs JAX: the mesh path on scenes with a re-read.

* The host-L2 mesh (DUMPVDL2_TPU_L2=0 in JAX, ``device_l2=False`` in the
  port) on the prepend scene of tests/test_torch_mesh.py: frames against
  JAX's mesh and the port's single-device host-L2 run, per-channel
  counters against JAX's.
* A deferred burst that the JAX package's mesh loses and the port's
  keeps, gated and host-gated, against the port's single-device run.

Tolerances and the helpers are tests/test_torch_mesh.py's.
"""
import os
import tempfile

from _torch_port import (assert_frames_match, frame_keys,  # noqa: F401
                         one_torch_thread)
from test_torch_mesh import (CENTER, FEED, FS, K_SLOTS, OS,
                             _assert_stats_match, _by_key, _feed, _jax_mesh,
                             _port_mesh, _prepend_scene, _single)

from dumpvdl2_tpu_torch.core.mesh_pipeline import MeshPipeline
from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline


def test_mesh_host_l2(monkeypatch):
    """The host-L2 mesh (DUMPVDL2_TPU_L2=0 in JAX, device_l2=False in
    the port) on the prepend scene."""
    span, want_frames = _prepend_scene()
    jp = _jax_mesh(monkeypatch, [CENTER], (1, 4), l2="0")
    assert not jp.use_device_l2
    want = _feed(jp, span, FEED)
    tp = _port_mesh([CENTER], (1, 4), device_l2=False)
    assert not tp.use_device_l2 and not tp.use_device_gate
    got = _feed(tp, span, FEED)
    assert sorted(bytes(f.frame) for f in got) == want_frames
    assert frame_keys(got) == frame_keys(want)
    _assert_stats_match(tp, jp, tracker=False)
    single = _feed(_single([CENTER], device_l2=False), span, FEED)
    assert_frames_match(_by_key(got), _by_key(single))


def test_mesh_keeps_a_deferred_burst_the_reference_loses():
    """The file of tests/test_torch_cli.py (seed 31) in 120 000-sample
    reads under a 1x2 mesh: the 271-octet burst across the second read
    boundary is deferred, and the read block after it holds a later
    candidate on that channel (a neighbour's burst leaking in).  The
    JAX package's mesh decides that candidate before the re-read and
    loses the burst (7 frames where the single-device path gives 9,
    ROADMAP.md queue 3), and reads its re-read bursts' noise floors
    after later samples; the port leaves the channel to the re-read and
    gives the single-device frames, floors included, gated and
    host-gated."""
    from dumpvdl2_tpu_torch.io import iqfile
    from test_torch_cli import CENTER as C0, FREQS as F0, READ_BYTES
    from test_torch_cli import _write_iq
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.s16")
        _write_iq(path)
        with open(path, "rb") as fh:
            blocks = list(iqfile.iq_blocks(fh, "S16_LE",
                                           bufsize=READ_BYTES))

    def run(pipe):
        frames = []
        for blk in blocks:
            frames += pipe.feed(blk)
        return _by_key(frames + pipe.finish())

    want = run(VDL2Pipeline(F0, C0, int(FS), OS, device="cpu",
                            max_candidates=K_SLOTS))
    assert sum(k[2] == 271 for k in frame_keys(want)) == 2
    for kw in ({}, {"device_gate": False}):
        assert_frames_match(run(MeshPipeline(
            F0, C0, int(FS), OS, mesh_shape=(1, 2), devices=["cpu"] * 2,
            max_candidates=K_SLOTS, **kw)), want)
