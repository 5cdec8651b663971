"""The main path's device steps as CUDA graphs.

Eagerly, a steady wideband block enqueues about 115 kernels from
Python (detect ~52, L2 2, the gate ~61), and on an H100's host a CUDA
call costs 5-80 us once Python work runs between calls: the device then
idles while the host enqueues.  A :class:`StepGraph` is one step
captured once (``torch.cuda.CUDAGraph``) on static tensors and replayed
with a single launch; the pipeline (core/pipeline.py) keeps one
detect, L2 and gate graph per steady block shape, sharing one memory
pool, and replays them in order on the current stream.  The kernels,
their inputs, their order and their precision are those of the eager
step.

The pipeline still calls its step functions on a graphed block, with
the graph as an argument (``process_block_detect(..., graph=)``,
``l2_sliced(..., graph=)``), so that whatever wraps them (tests, the
benchmark's check, which keeps some blocks' planes) sees every block.
A replay overwrites what the previous one left in the graph's buffers,
so the results such a call hands back are copies: a :class:`Snapshot`
packs a result tree into one buffer inside the capture and gives,
after each replay, the tree as views of a fresh copy of that buffer
(one launch).

The kernel wrappers count their launches (``launches`` in
dsp/pfb_kernel.py, dsp/sync_kernel.py, dsp/candidates_kernel.py,
fec/l2_kernel.py and core/gate_kernel.py).  A capture launches
nothing, so it leaves the counters as they were, and each replay adds
the launches its capture made, so that the counters read as on the
eager path.
"""
from __future__ import annotations

import torch

from ..dsp import candidates_kernel, pfb_kernel, sync_kernel
from ..fec import l2_kernel
from ..utils import fetch
from . import gate_kernel

# The modules whose ``launches`` counters the kernel wrappers bump: an
# int, or a dict by kernel.
_WRAPPERS = (pfb_kernel, sync_kernel, candidates_kernel, l2_kernel,
             gate_kernel)


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter now: ``{(module, kernel):
    count}``, kernel None for a module's single counter."""
    out = {}
    for mod in _WRAPPERS:
        if isinstance(mod.launches, dict):
            out.update(((mod, k), v) for k, v in mod.launches.items())
        else:
            out[(mod, None)] = mod.launches
    return out


def add_launches(counts: dict) -> None:
    """Add ``counts`` (as :func:`launch_counts` gives them) to the
    wrappers' counters."""
    for (mod, k), n in counts.items():
        if k is None:
            mod.launches += n
        else:
            mod.launches[k] += n


class StepGraph:
    """One step captured as a CUDA graph.

    ``step()`` runs once under capture on ``stream`` (with no other
    work in flight on the device), its allocations in the memory pool
    ``pool``, and returns a function that gives the step's results after
    a replay.  Only this thread's calls are checked during the capture
    (``thread_local``), so a fetch thread's copy cannot break it.
    """

    def __init__(self, step, pool, stream: torch.cuda.Stream):
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                results = step()
            finally:
                graph.capture_end()
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        add_launches({k: -n for k, n in self.launches.items()})
        self._graph, self._results = graph, results

    def replay(self):
        """Run the captured kernels again on the current stream, count
        their launches, and return the step's results."""
        self._graph.replay()
        add_launches(self.launches)
        return self._results()


class Snapshot:
    """The tensors of a tree, packed into one buffer where the snapshot
    is made (inside a capture: at each replay).  The leaves go in order
    of falling element size, so each one's offset is a multiple of its
    element size and a view of that dtype can start there.

    :meth:`copy` gives the tree again, its tensors views of a fresh copy
    of the buffer: one launch, and tensors that later replays leave
    alone."""

    def __init__(self, tree):
        leaves: list = []
        self._spec = fetch._flatten(tree, leaves)
        order = sorted(range(len(leaves)),
                       key=lambda i: -leaves[i].element_size())
        self._buf = fetch.pack([leaves[i] for i in order])
        self._parts = [(i, leaves[i].dtype, tuple(leaves[i].shape),
                        leaves[i].numel() * leaves[i].element_size())
                       for i in order]

    def copy(self):
        buf = self._buf.clone()
        leaves = [None] * len(self._parts)
        chunks = buf.split([n for *_, n in self._parts])
        for (i, dtype, shape, _), chunk in zip(self._parts, chunks):
            leaves[i] = chunk.view(dtype).view(shape)
        return fetch._unflatten(self._spec, leaves)
