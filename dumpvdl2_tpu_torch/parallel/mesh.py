"""Device mesh for the sharded VDL2 pipeline.

Port of ``dumpvdl2_tpu/parallel/mesh.py``.  The reference's
thread-per-channel + shared-buffer-barrier topology (dumpvdl2.c:117-135,
demod.c:299-336) becomes a 2-D logical mesh:

* ``channel`` axis -- each shard demodulates a subset of the VDL2
  channel frequencies over the full time range (no communication);
* ``time`` axis -- overlap-save sequence parallelism: the raw IQ block
  is split into contiguous time shards, and FIR carry and sync-lookback
  / burst-extension halos move between neighbouring shards
  (parallel/sharded.py).

One process drives every shard (the JAX package's single-controller
design).  A mesh may name one device more than once: shards then run
one after another on that device.
"""
from __future__ import annotations

import torch

from ..utils.devices import resolve_device

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


class Mesh:
    """A (channel_shards, time_shards) grid of torch devices.

    ``grid[c][t]`` is the device of channel shard c, time shard t;
    ``shape`` maps each axis name to its size, as a JAX mesh's does;
    ``home`` (``grid[0][0]``) is where the shards' results are gathered.
    """

    def __init__(self, grid: list[list[torch.device]]):
        self.grid = grid
        self.shape = {CHANNEL_AXIS: len(grid), TIME_AXIS: len(grid[0])}
        self.home = grid[0][0]

    @property
    def devices(self) -> list[torch.device]:
        return [d for row in self.grid for d in row]


def make_mesh(channel_shards: int, time_shards: int, devices=None) -> Mesh:
    """Build a (channel, time) mesh over ``channel_shards*time_shards``
    devices: ``devices`` (names or torch devices, repeats allowed), or
    by default every visible CUDA device.  Raises when there are fewer
    than the mesh needs, or when a named CUDA device is missing."""
    if channel_shards < 1 or time_shards < 1:
        raise ValueError(f"invalid mesh {channel_shards}x{time_shards}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = channel_shards * time_shards
    if len(devices) < n:
        raise ValueError(
            f"need {n} devices for a {channel_shards}x{time_shards} mesh, "
            f"have {len(devices)}")
    devs = [resolve_device(d) for d in devices[:n]]
    # "cuda" names the current device: pin it, so that each shard's
    # tensors compare equal to its device
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh's devices must be of one type: {devs}")
    return Mesh([devs[c * time_shards:(c + 1) * time_shards]
                 for c in range(channel_shards)])
