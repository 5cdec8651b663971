"""Multi-process deployment over torch.distributed: bring-up, the rank's
rows of the mesh, ingest and result gather.

Port of ``dumpvdl2_tpu/parallel/multihost.py``.  The reference lays the
(channel, time) mesh out so that every time row (whose shards trade
halos every block) stays inside one process, while the channel axis
(no steady traffic) spans processes.  Here that layout is the whole
design: each rank owns whole rows of the grid and runs the
single-process sharded step (parallel/sharded.py) over its own devices
on its slice of the channel set.  So no tensor moves between ranks:

* ``init_distributed()`` -- process-group bring-up from torchrun's
  variables; a no-op in a single process;
* ``make_multihost_mesh()`` -- the rank's rows of the global mesh, as a
  local :class:`~.mesh.Mesh` that also carries the global layout;
* ``local_time_spans()`` -- the raw spans this rank must ingest: the
  whole block, since a row spans every time shard;
* ``distribute_block()`` -- the rank's (2, N) block on its home device;
* ``gather_candidates()`` -- the rank's channel columns of the global
  (Tn, C, ...) candidate grid, fetched to the host;
* ``local_channels()`` -- the rank's slice of the channel set.

Devices are numbered rank-major, as ``jax.devices()`` numbers them:
the l-th local device of rank r is global device r*L + l (L local
devices a rank), and grid row c holds global devices c*Tn ... c*Tn+Tn-1.
A rank whose devices hold no whole row of the mesh (the mesh needs
fewer than world*L devices) owns no rows: its mesh is empty
(``rows == 0``, ``home`` None), its spans and channel slice are empty,
and it has no block to take; it only joins the group.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..utils.devices import resolve_device
from .mesh import CHANNEL_AXIS, TIME_AXIS, Mesh, make_mesh


# The process group's backend and how long a rank waits for the others.
# Gloo is enough: this design moves no tensor between ranks (each rank
# owns whole rows of the mesh), so the only distributed traffic is the
# bring-up and a barrier, which gloo serves on any host and for any
# number of ranks a GPU (NCCL refuses two ranks on one GPU).
BACKEND = "gloo"
TIMEOUT = datetime.timedelta(seconds=120)


def init_distributed() -> bool:
    """Join the process group that torchrun's variables describe.

    Reads ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
    With ``WORLD_SIZE`` unset or 1 it does nothing and returns False;
    otherwise it joins the ``BACKEND`` group (unless one is up already),
    waiting at most ``TIMEOUT`` for the other ranks, and returns True
    when the world has more than one rank.
    """
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ["MASTER_PORT"]
        dist.init_process_group(
            BACKEND, init_method=f"tcp://{addr}:{port}", world_size=world,
            rank=int(os.environ["RANK"]), timeout=TIMEOUT)
    return dist.get_world_size() > 1


def _world() -> tuple[int, int]:
    """(world size, rank) of the process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class MultihostMesh(Mesh):
    """The rows of a global (channel, time) mesh that one rank owns.

    ``grid``, ``shape`` and ``home`` are those of the local mesh the
    rank's sharded step runs on (``shape[CHANNEL_AXIS] == rows``);
    ``global_shape`` is the whole mesh's, ``first_row`` the global index
    of the rank's first row (rows before it belong to lower ranks).
    """

    def __init__(self, grid, *, global_shape: dict, first_row: int,
                 rank: int, world_size: int):
        if grid:
            super().__init__(grid)
        else:
            self.grid, self.home = [], None
            self.shape = {CHANNEL_AXIS: 0,
                          TIME_AXIS: global_shape[TIME_AXIS]}
        self.global_shape = global_shape
        self.first_row = first_row
        self.rows = len(grid)
        self.rank = rank
        self.world_size = world_size


def make_multihost_mesh(channel_shards: int, time_shards: int,
                        devices=None) -> MultihostMesh:
    """This rank's rows of a (channel_shards, time_shards) mesh over the
    devices of every rank.

    ``devices`` are the rank's local devices (names or torch devices,
    repeats allowed), every visible CUDA device by default; every rank
    must pass as many.  Raises when the world has fewer devices than
    the mesh needs, and, with several ranks, when a time row would not
    fit in one rank (more time shards than local devices) or would
    straddle two ranks: the sharded step moves its halos only between
    devices of one process.
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    world, rank = _world()
    n_local = len(devices)
    n = channel_shards * time_shards
    if world * n_local < n:
        raise ValueError(f"need {n} devices, have {world * n_local}")
    if world > 1 and time_shards > n_local:
        raise ValueError(
            f"time_shards={time_shards} exceeds the per-rank device "
            f"count {n_local}: halo exchange would cross ranks")
    for c in range(channel_shards):
        lo, hi = c * time_shards, (c + 1) * time_shards - 1
        if lo // n_local != hi // n_local:
            raise ValueError(
                f"time row {c} (global devices {lo}..{hi}) would straddle "
                f"ranks {lo // n_local} and {hi // n_local}: the port moves "
                f"no halo between processes; use a time_shards that "
                f"divides the per-rank device count {n_local}")
    mine = [c for c in range(channel_shards)
            if (c * time_shards) // n_local == rank]
    first = mine[0] if mine else sum(
        1 for c in range(channel_shards)
        if (c * time_shards) // n_local < rank)
    grid = []
    if mine:
        start = first * time_shards - rank * n_local
        grid = make_mesh(len(mine), time_shards,
                         list(devices)[start:start + n]).grid
    return MultihostMesh(
        grid, global_shape={CHANNEL_AXIS: channel_shards,
                            TIME_AXIS: time_shards},
        first_row=first, rank=rank, world_size=world)


def local_channels(mesh: MultihostMesh, n_channels: int) -> slice:
    """The rank's slice of the channel set: its rows' channels (each
    row holds n_channels / channel_shards of them)."""
    cn = mesh.global_shape[CHANNEL_AXIS]
    if n_channels % cn:
        raise ValueError(f"channel count {n_channels} not divisible by "
                         f"channel shards {cn}")
    per_row = n_channels // cn
    return slice(mesh.first_row * per_row,
                 (mesh.first_row + mesh.rows) * per_row)


def local_time_spans(mesh: MultihostMesh, n: int) -> list[tuple[int, int]]:
    """The sorted [start, end) raw spans of the (2, n) block that this
    rank's time shards own: the whole block (a planar block is split
    over time only, and a rank's rows span every time shard), or none
    for a rank that owns no row."""
    return [(0, n)] if mesh.rows else []


def distribute_block(mesh: MultihostMesh, local_data, n: int
                     ) -> torch.Tensor:
    """The rank's (2, n) float32 block on ``mesh.home`` from its
    concatenated time spans (in local_time_spans order; the whole block).
    No collective: every rank reads its own spans."""
    if not mesh.rows:
        raise ValueError(f"rank {mesh.rank} owns no row of the mesh and "
                         f"takes no block")
    want = sum(e - s for s, e in local_time_spans(mesh, n))
    data = torch.as_tensor(local_data, dtype=torch.float32)
    if data.ndim != 2 or data.shape[0] != 2 or data.shape[1] != want:
        raise ValueError(f"local data of shape {tuple(data.shape)}, "
                         f"expected (2, {want})")
    return data.to(mesh.home)


def gather_candidates(cands) -> dict:
    """{field: np.ndarray} of a candidate tuple (any NamedTuple of
    tensors), fetched to the host.  For a rank's sharded step these are
    its channel columns of the global (Tn, C, ...) grid: no collective."""
    return {f: getattr(cands, f).cpu().numpy() for f in cands._fields}
