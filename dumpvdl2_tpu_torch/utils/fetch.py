"""One-transfer device fetch: a result tree's tensors reach the host in
one copy.

Port of ``dumpvdl2_tpu/utils/fetch.py``.  A drain of ~20 small result
tensors would otherwise cost ~20 device->host copies, each with its own
synchronisation.  :func:`start` reinterprets every CUDA leaf as bytes,
concatenates them into ONE uint8 device buffer (or takes one packed
already, as a CUDA graph's :func:`pack_tree`), enqueues one
non-blocking copy of it into pinned host memory on the current stream
and records an event after it; :meth:`Pending.get` waits for that event
and unpacks zero-copy numpy views.  The copy is ordered in the stream
after the work that made the tree, so the caller may drop the tree's
device tensors, or let later work on the stream overwrite them, as soon
as :func:`start` returns, and the thread that calls ``get`` issues no
device work.  :func:`coalesced_get` is the two in one call.  On the CPU
there is no link to amortize: each tensor leaf becomes its numpy view
as is.

A tree is any nesting of tuples, lists and dicts whose leaves are
tensors, numpy arrays or None (None passes through).
"""
from __future__ import annotations

import functools
import math
from collections import namedtuple
from typing import NamedTuple

import numpy as np
import torch


def _flatten(tree, leaves: list):
    """Replace each leaf by its index in ``leaves``; returns the spec."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_flatten(t, leaves) for t in tree)
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if tree is None:
        return None
    leaves.append(tree)
    return len(leaves) - 1


def _unflatten(spec, leaves: list):
    if isinstance(spec, (tuple, list)):
        return type(spec)(_unflatten(s, leaves) for s in spec)
    if isinstance(spec, dict):
        return {k: _unflatten(v, leaves) for k, v in spec.items()}
    if spec is None:
        return None
    return leaves[spec]


def nbytes(tree) -> int:
    """Bytes of the tree's leaves (None counts 0)."""
    if isinstance(tree, (tuple, list)):
        return sum(nbytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(nbytes(t) for t in tree.values())
    return 0 if tree is None else int(tree.nbytes)


def pack(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, concatenated into one uint8 tensor on their
    device (bool leaves as one byte each)."""
    parts = []
    for x in tensors:
        x = x.contiguous().reshape(-1)
        parts.append(x.to(torch.uint8) if x.dtype == torch.bool
                     else x.view(torch.uint8))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


@functools.cache
def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def unpack(buf: np.ndarray, like: list) -> list[np.ndarray]:
    """Numpy views into ``buf`` (a host copy of :func:`pack`'s result)
    with the dtypes and shapes of ``like`` (tensors, or anything with a
    torch ``dtype`` and a ``shape``)."""
    out, off = [], 0
    for x in like:
        dt = _numpy_dtype(x.dtype)
        wire = np.dtype(np.uint8) if dt == np.bool_ else dt
        n = math.prod(x.shape)
        arr = np.frombuffer(buf, dtype=wire, count=n, offset=off)
        arr = arr.reshape(tuple(x.shape))
        out.append(arr.view(np.bool_) if dt == np.bool_ else arr)
        off += n * wire.itemsize
    return out


def pack_tree(tree) -> torch.Tensor:
    """:func:`pack` of every tensor leaf of ``tree``, in the order
    :func:`start` unpacks a buffer given with the tree."""
    leaves: list = []
    _flatten(tree, leaves)
    return pack([x for x in leaves if isinstance(x, torch.Tensor)])


# a fetched tensor's dtype and shape, in its leaf's place until the copy
# is done
_Leaf = namedtuple("_Leaf", "dtype shape")


class Pending(NamedTuple):
    """A fetch in flight (:func:`start`): the tree's structure ``spec``,
    its ``leaves`` (host leaves as they are, a :class:`_Leaf` for each
    fetched tensor), ``host``, the buffer the fetched tensors' bytes are
    copied into (pinned memory where the copy is from a device), and
    ``ready``, the CUDA event recorded after that copy (None where
    nothing is copied).  It holds no device tensor."""
    spec: object
    leaves: list
    host: torch.Tensor | None
    ready: torch.cuda.Event | None

    def get(self):
        """Wait for the copy and return the tree with numpy arrays
        (views into one backing buffer, to be treated as read-only):
        the values the tensors held when the fetch started."""
        if self.ready is not None:
            self.ready.synchronize()
        like = [x for x in self.leaves if isinstance(x, _Leaf)]
        views = iter(unpack(self.host.numpy(), like) if like else ())
        return _unflatten(self.spec, [next(views) if isinstance(x, _Leaf)
                                      else x for x in self.leaves])


def start(tree, buf: torch.Tensor | None = None) -> Pending:
    """Start fetching ``tree`` to the host, right after the work that
    makes it was enqueued: pack its CUDA leaves (or take ``buf``,
    :func:`pack_tree` of the tree taken earlier, which then holds every
    tensor leaf), enqueue one non-blocking copy of the bytes into pinned
    host memory on the device's current stream, and record an event
    after it.  Tensors on the CPU become numpy views, and a CPU ``buf``
    is read where it is: nothing is copied."""
    leaves: list = []
    spec = _flatten(tree, leaves)
    sent = [isinstance(x, torch.Tensor)
            and (buf is not None or x.device.type == "cuda") for x in leaves]
    host = ready = None
    if any(sent):
        if buf is None:
            buf = pack([x for x, s in zip(leaves, sent) if s])
        if buf.device.type == "cpu":
            host = buf
        else:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(buf.device))
    leaves = [_Leaf(x.dtype, tuple(x.shape)) if s
              else x.numpy() if isinstance(x, torch.Tensor) else x
              for x, s in zip(leaves, sent)]
    return Pending(spec, leaves, host, ready)


def coalesced_get(tree):
    """Fetch a tree of tensors to the host in ONE transfer and wait for
    it: ``start(tree).get()``.  Host numpy leaves are returned as they
    are."""
    return start(tree).get()
