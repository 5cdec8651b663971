"""PyTorch port vs JAX: the multi-process path (parallel/multihost.py).

The port's counterpart of every case of tests/test_multihost.py: the
bring-up is a no-op in one process; the mesh layout and its refusals
(too few devices, a time row longer than a rank's devices or straddling
two ranks, checked by setting the world size and rank without a second
process) and a rank that owns no row; the spans, the ingest and the
gather; the sharded step fed by distribute_block; the worker's block
equal to the JAX worker's.  Then two real gloo processes, each with a
(1, 4) row of the CPU repeated: each rank's count, det_idx, sync_idx and
sym_valid must equal, exactly, its channel column of a single-process
(2, 4) run of the port and of JAX's make_sharded_step.
"""
import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu.parallel import multihost as jmh
from dumpvdl2_tpu.parallel import sharded as jsh
from dumpvdl2_tpu_torch.dsp.demod import Candidates
from dumpvdl2_tpu_torch.parallel import multihost as mh
from dumpvdl2_tpu_torch.parallel.mesh import make_mesh
from dumpvdl2_tpu_torch.parallel.sharded import (init_sharded_state,
                                                 make_sharded_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "dumpvdl2_tpu_torch", "tools",
                      "multihost_worker.py")
JAX_WORKER = os.path.join(REPO, "tools", "multihost_worker.py")
FIELDS = ("count", "det_idx", "sync_idx", "sym_valid")
CPU4 = ["cpu"] * 4


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def worker():
    return _load(WORKER, "torch_mh_worker")


@pytest.fixture
def world(monkeypatch):
    """Set the (world size, rank) the mesh sees, with no process group."""
    def set_world(size, rank):
        monkeypatch.setattr(mh, "_world", lambda: (size, rank))
    return set_world


@pytest.mark.parametrize("size", [None, "1"])
def test_init_distributed_noop_single_process(monkeypatch, size):
    if size is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", size)
    assert mh.init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_multihost_mesh_layout():
    mesh = mh.make_multihost_mesh(2, 4, ["cpu"] * 8)
    assert mesh.shape == {"channel": 2, "time": 4}
    assert mesh.global_shape == {"channel": 2, "time": 4}
    assert (mesh.rows, mesh.first_row, mesh.rank, mesh.world_size) == \
        (2, 0, 0, 1)
    assert mesh.home == torch.device("cpu")
    assert mh.local_channels(mesh, 256) == slice(0, 256)
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        mh.make_multihost_mesh(4, 4, ["cpu"] * 8)


@pytest.mark.parametrize("rank", [0, 1])
def test_multihost_mesh_rank_rows(world, rank):
    """Two ranks of four devices: rank r owns row r of a (2, 4) mesh,
    and its half of the channels."""
    world(2, rank)
    mesh = mh.make_multihost_mesh(2, 4, CPU4)
    assert mesh.shape == {"channel": 1, "time": 4}
    assert (mesh.rows, mesh.first_row, mesh.rank, mesh.world_size) == \
        (1, rank, rank, 2)
    assert mesh.devices == [torch.device("cpu")] * 4
    assert mh.local_channels(mesh, 256) == slice(128 * rank,
                                                 128 * (rank + 1))


@pytest.mark.parametrize("shape,devices,match", [
    ((4, 4), CPU4, "need 16 devices, have 8"),
    ((1, 4), ["cpu"] * 2, "exceeds the per-rank device count 2"),
    ((2, 2), ["cpu"] * 3, "time row 1 .* would straddle ranks 0 and 1"),
])
def test_multihost_mesh_refusals(world, shape, devices, match):
    world(2, 0)
    with pytest.raises(ValueError, match=match):
        mh.make_multihost_mesh(*shape, devices)


def test_multihost_mesh_default_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mh.make_multihost_mesh(1, 1)


def test_rank_without_rows(world, worker):
    """The mesh needs fewer devices than the world has: the rank past
    them owns no row, takes no block and reports no channel column."""
    world(2, 1)
    mesh = mh.make_multihost_mesh(1, 4, CPU4)
    assert (mesh.rows, mesh.first_row, mesh.grid, mesh.home) == \
        (0, 1, [], None)
    assert mh.local_time_spans(mesh, 4000) == []
    assert mh.local_channels(mesh, 8) == slice(8, 8)
    with pytest.raises(ValueError, match="owns no row"):
        mh.distribute_block(mesh, np.zeros((2, 0), np.float32), 4000)
    scene = worker.load_scene("tiny")
    scene["mesh"] = (1, 4)
    res = worker.run_rank(scene, CPU4)
    assert res["rows"] == 0 and res["channels"] == [2, 2]
    for f in worker.FIELDS:
        assert np.asarray(res[f]).shape == (1, 4, 0)


def test_local_time_spans_cover_block():
    mesh = mh.make_multihost_mesh(2, 4, ["cpu"] * 8)
    n = 4000
    spans = mh.local_time_spans(mesh, n)
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert sum(e - s for s, e in spans) == n


def test_distribute_and_gather_roundtrip():
    mesh = mh.make_multihost_mesh(2, 4, ["cpu"] * 8)
    n = 4096
    data = np.arange(2 * n, dtype=np.float32).reshape(2, n)
    block = mh.distribute_block(mesh, data, n)
    assert block.device == mesh.home and block.dtype == torch.float32
    np.testing.assert_array_equal(block.numpy(), data)
    with pytest.raises(ValueError, match=r"expected \(2, 4096\)"):
        mh.distribute_block(mesh, data[:, :-1], n)

    z = torch.zeros
    c = Candidates(count=z((4, 2), dtype=torch.int32),
                   det_idx=z((4, 2, 3), dtype=torch.int32),
                   sync_idx=z((4, 2, 3), dtype=torch.int32),
                   dphi=z((4, 2, 3)), pherr=z((4, 2, 3)),
                   symbols=z((4, 2, 3, 8), dtype=torch.uint8),
                   sym_valid=z((4, 2, 3), dtype=torch.int32),
                   power=z((4, 2, 3, 8)))
    got = mh.gather_candidates(c)
    assert set(got) == set(Candidates._fields)
    assert got["det_idx"].shape == (4, 2, 3)
    assert got["symbols"].dtype == np.uint8


def _jax_full(block, scene):
    """JAX's single-process (2, 4) step over its 8 virtual devices."""
    mesh = jmh.make_multihost_mesh(*scene["mesh"])
    step = jsh.make_sharded_step(mesh, **scene["step"])
    state = jsh.init_sharded_state(mesh, scene["dphi"].size,
                                   scene["taps"].size)
    n = block.shape[1]
    cands, _pwr3, _state = step(jmh.distribute_block(mesh, block, n),
                                scene["taps"], scene["dphi"], state)
    return jmh.gather_candidates(cands)


def _port_full(block, scene):
    """The port's single-process (2, 4) step, fed by distribute_block."""
    mesh = mh.make_multihost_mesh(*scene["mesh"], ["cpu"] * 8)
    step = make_sharded_step(mesh, **scene["step"])
    state = init_sharded_state(mesh, scene["dphi"].size, scene["taps"].size)
    n = block.shape[1]
    cands, _pwr3, _state = step(
        mh.distribute_block(mesh, block, n), torch.as_tensor(scene["taps"]),
        torch.as_tensor(scene["dphi"].astype(np.int64)), state)
    return mh.gather_candidates(cands)


@pytest.mark.parametrize("data", ["noise", "burst"])
def test_sharded_step_with_distributed_ingest(worker, data):
    """distribute_block feeds make_sharded_step; the candidates equal
    JAX's (integers exactly, floats within the sharded step's limits,
    tests/test_torch_sharded.py)."""
    scene = worker.load_scene("tiny")
    block = scene["blocks"][0]
    if data == "noise":
        rng = np.random.default_rng(0)
        block = rng.standard_normal(block.shape).astype(np.float32) * 0.1
    got, want = _port_full(block, scene), _jax_full(block, scene)
    assert got["count"].shape == (4, 2)
    for f in ("count", "det_idx", "sync_idx", "sym_valid", "symbols"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["dphi"], want["dphi"], atol=1e-5)
    np.testing.assert_allclose(got["pherr"], want["pherr"], atol=1e-3)
    np.testing.assert_allclose(got["power"], want["power"], rtol=1e-5,
                               atol=1e-7)
    if data == "burst":
        assert int(got["count"].sum()) >= 1


def test_make_block_matches_jax_worker(worker):
    jw = _load(JAX_WORKER, "jax_mh_worker")
    for n, os_ in ((2048 * 10 * 4, 10), (2048 * 20 * 2, 20)):
        got, want = worker.make_block(n, os_), jw.make_block(n, os_)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_worker_single_process(worker, monkeypatch, capsys):
    """The worker in one process owns the whole (2, 4) grid."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert worker.main(["--device", "cpu", "--local-devices",
                        ",".join(["cpu"] * 8)]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("RESULT ")]
    r = json.loads(line[0][7:])
    assert (r["process_count"], r["process_index"], r["rows"]) == (1, 0, 2)
    assert r["k1_launches"] == 0 and r["k1_plain_calls"] == 8
    full = _port_full(worker.load_scene("tiny")["blocks"][0],
                      worker.load_scene("tiny"))
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(r[f])[0], full[f])


# --------------------------------------------------------------------------
# two gloo processes on a localhost port

def _run_two_ranks(timeout=120):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "--device", "cpu", "--local-devices",
             ",".join(CPU4)], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            results.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


@pytest.mark.golden
def test_two_process_distributed_parity(worker):
    """Two real processes join a gloo group on a localhost port; each
    owns one (1, 4) row of the (2, 4) mesh and runs the sharded step on
    its channel; its candidates equal its channel column of the
    single-process run, the port's and JAX's, exactly."""
    parsed = {}
    for rc, out, err in _run_two_ranks():
        assert rc == 0, f"rank failed:\n{err[-2000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out
        r = json.loads(line[0][7:])
        assert (r["process_count"], r["local_devices"], r["rows"]) == \
            (2, 4, 1)
        parsed[r["process_index"]] = r
    assert set(parsed) == {0, 1}

    scene = worker.load_scene("tiny")
    block = scene["blocks"][0]
    port, jax_ = _port_full(block, scene), _jax_full(block, scene)
    for pid in (0, 1):
        got = parsed[pid]
        assert got["channels"] == [pid, pid + 1]
        for f in FIELDS:
            g = np.asarray(got[f])[0]
            for name, full in (("port", port), ("jax", jax_)):
                want = full[f][:, pid:pid + 1]
                assert g.shape == want.shape, (pid, f, name)
                assert np.array_equal(g, want), (pid, f, name)
