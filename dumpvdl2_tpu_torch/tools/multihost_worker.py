"""One rank of the port's multi-process sharded step.

Counterpart of the JAX package's ``tools/multihost_worker.py``.  Each
rank runs this script with torchrun's variables set (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), joins the process group
through ``parallel.multihost.init_distributed`` and drives the
multi-process path: ``make_multihost_mesh`` -> ``local_time_spans`` ->
``distribute_block`` -> the sharded step over the rank's rows on its
slice of the channels -> ``gather_candidates``.  It prints one line,
``RESULT {json}``: the world, the rank's rows and channels, and its
candidate fields ``count``, ``det_idx``, ``sync_idx`` and ``sym_valid``
stacked over the blocks, shapes (blocks, Tn, C_local[, K]); with K1's
launches and plain-version calls, and the peak device memory on CUDA.
A rank that owns no row of the mesh reports zero channel columns.

Scenes (``--scene``):

* ``tiny``: the JAX worker's block, one synthesized burst in padding,
  2 channels at oversample 10, one block of 2048*10*4 samples, mesh
  (2, 4), 8 candidate slots of 64 symbols;
* ``wideband``: the 256-channel 8.4 Msps signal of ``sim.wideband_scene``
  (made on ``--device`` from its seed), its first two blocks with
  carried state, mesh (2, 2), the mesh pipeline's slots and
  halo.

Two ranks on the CPU, four devices each (the CPU repeated):

    MASTER_ADDR=127.0.0.1 MASTER_PORT=29511 WORLD_SIZE=2 RANK=0 \\
        python dumpvdl2_tpu_torch/tools/multihost_worker.py \\
        --device cpu --local-devices cpu,cpu,cpu,cpu &
    (the same with RANK=1)

Two ranks on one GPU, a (1, 2) row each of the (2, 2) mesh:

    torchrun --nproc-per-node 2 dumpvdl2_tpu_torch/tools/multihost_worker.py \\
        --scene wideband --local-devices cuda:0,cuda:0
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from dumpvdl2_tpu_torch import sim  # noqa: E402
from dumpvdl2_tpu_torch.constants import SPS, SYMBOL_RATE  # noqa: E402
from dumpvdl2_tpu_torch.dsp import sync_kernel  # noqa: E402
from dumpvdl2_tpu_torch.dsp.chebyshev import fir_taps  # noqa: E402
from dumpvdl2_tpu_torch.dsp.frontend import (nco_dphi,  # noqa: E402
                                             prepare_taps)
from dumpvdl2_tpu_torch.parallel import multihost  # noqa: E402
from dumpvdl2_tpu_torch.parallel.sharded import (  # noqa: E402
    init_sharded_state, make_sharded_step)

FIELDS = ("count", "det_idx", "sync_idx", "sym_valid")
CENTER = 136.975e6


def make_block(n: int, oversample: int) -> np.ndarray:
    """The tiny scene's block: one synthesized burst in padding, as the
    JAX worker's ``make_block`` makes it (same samples, float32)."""
    burst = sim.synthesize_iq_raw([b"two-process multihost parity"],
                              oversample=oversample).astype(np.complex64)
    stream = np.zeros(n, np.complex64)
    stream[20000:20000 + burst.size] = burst
    return np.stack([stream.real, stream.imag]).astype(np.float32)


def load_scene(name: str, device: str = "cuda") -> dict:
    """A scene's mesh shape, blocks, channel NCO steps (uint32, every
    channel), taps and sharded-step keywords.  The wideband scene is
    made on ``device``."""
    if name == "tiny":
        cn, tn, os_ = 2, 4, 10
        fs = SYMBOL_RATE * SPS * os_
        n = 2048 * os_ * tn
        return {"mesh": (cn, tn), "blocks": [make_block(n, os_)],
                "dphi": np.array([nco_dphi(CENTER, CENTER - 25e3 * i, fs)
                                  for i in range(cn)], np.uint32),
                "taps": prepare_taps(fir_taps(fs), os_),
                "step": {"oversample": os_, "fwd_halo": 641,
                         "max_candidates": 8, "max_symbols": 64}}
    if name == "wideband":
        from dumpvdl2_tpu_torch.core.mesh_pipeline import FWD_HALO
        from dumpvdl2_tpu_torch.core.pipeline import MAX_BURST_SYMS
        freqs, fs, os_, sig, _, _ = sim.wideband_scene(device=device)
        B = sim.WIDEBAND_BLOCK
        return {"mesh": (2, 2), "blocks": [sig[:, b * B:(b + 1) * B]
                                           for b in range(2)],
                "dphi": np.array([nco_dphi(sim.WIDEBAND_CENTER, f, fs)
                                  for f in freqs], np.uint32),
                "taps": prepare_taps(fir_taps(fs), os_),
                "step": {"oversample": os_, "fwd_halo": FWD_HALO,
                         "max_candidates": 64,
                         "max_symbols": MAX_BURST_SYMS}}
    raise ValueError(f"unknown scene {name!r}")


def run_rank(scene: dict, devices) -> dict:
    """The multi-process path for this rank over ``scene``'s blocks:
    the RESULT fields but the scene's name, the local device count and
    the seconds."""
    cn, tn = scene["mesh"]
    mesh = multihost.make_multihost_mesh(cn, tn, devices)
    chans = multihost.local_channels(mesh, scene["dphi"].size)
    n_blocks = len(scene["blocks"])
    out = {"process_count": mesh.world_size, "process_index": mesh.rank,
           "rows": mesh.rows, "first_row": mesh.first_row,
           "channels": [chans.start, chans.stop], "blocks": n_blocks}
    if not mesh.rows:
        out.update({f: np.zeros((n_blocks, tn, 0), np.int32).tolist()
                    for f in FIELDS})
        out.update(k1_launches=0, k1_plain_calls=0, peak_bytes=None)
        return out
    plain = {"calls": 0}
    orig_plain = sync_kernel.sync_error_metric_plain

    def counted_plain(ph):
        plain["calls"] += 1
        return orig_plain(ph)

    home = mesh.home
    taps = torch.as_tensor(scene["taps"], device=home)
    dphi = torch.as_tensor(scene["dphi"][chans].astype(np.int64),
                           device=home)
    step = make_sharded_step(mesh, **scene["step"])
    state = init_sharded_state(mesh, chans.stop - chans.start, taps.shape[0])
    if home.type == "cuda":
        torch.cuda.reset_peak_memory_stats(home)
    got = {f: [] for f in FIELDS}
    sync_kernel.launches = 0
    sync_kernel.sync_error_metric_plain = counted_plain
    try:
        for data in scene["blocks"]:
            n = data.shape[1]
            spans = multihost.local_time_spans(mesh, n)
            local = torch.cat([torch.as_tensor(data[:, s:e])
                               for s, e in spans], dim=1)
            block = multihost.distribute_block(mesh, local, n)
            cands, _pwr3, state = step(block, taps, dphi, state)
            fields = multihost.gather_candidates(cands)
            for f in FIELDS:
                got[f].append(fields[f])
    finally:
        sync_kernel.sync_error_metric_plain = orig_plain
    out.update({f: np.stack(v).tolist() for f, v in got.items()})
    out.update(k1_launches=sync_kernel.launches,
               k1_plain_calls=plain["calls"],
               peak_bytes=torch.cuda.max_memory_allocated(home)
               if home.type == "cuda" else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("tiny", "wideband"), default="tiny")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the rank runs, when --local-devices is "
                    "not given: four CPU devices, or every visible GPU")
    ap.add_argument("--local-devices",
                    help="the rank's devices, comma-separated (e.g. "
                    "cpu,cpu,cpu,cpu or cuda:0,cuda:0)")
    args = ap.parse_args(argv)
    if args.local_devices:
        devices = args.local_devices.split(",")
    else:
        devices = ["cpu"] * 4 if args.device == "cpu" else None
    if args.device == "cpu":
        # several ranks (and test workers) share the host's cores
        torch.set_num_threads(1)

    t0 = time.perf_counter()
    multi = multihost.init_distributed()
    res = run_rank(load_scene(args.scene, args.device), devices)
    if multi:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps({
        **res, "scene": args.scene,
        "local_devices": len(devices) if devices
        else torch.cuda.device_count(),
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
