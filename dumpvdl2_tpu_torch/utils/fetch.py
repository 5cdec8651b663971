"""One-transfer device fetch: pack a result tree into a single buffer.

Port of ``dumpvdl2_tpu/utils/fetch.py``.  A drain of ~20 small result
tensors would otherwise cost ~20 device->host copies, each with its own
synchronisation.  :func:`coalesced_get` reinterprets every CUDA leaf as
bytes, concatenates them into ONE uint8 device buffer, copies that to
the host once and unpacks zero-copy numpy views.  On the CPU there is
no link to amortize: each tensor leaf becomes its numpy view as is.

A tree is any nesting of tuples, lists and dicts whose leaves are
tensors, numpy arrays or None (None passes through).
"""
from __future__ import annotations

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


def pack(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, concatenated into one uint8 tensor on their
    device (bool leaves as one byte each)."""
    parts = []
    for x in tensors:
        x = x.contiguous().reshape(-1)
        parts.append(x.to(torch.uint8) if x.dtype == torch.bool
                     else x.view(torch.uint8))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def unpack(buf: np.ndarray, like: list[torch.Tensor]) -> list[np.ndarray]:
    """Numpy views into ``buf`` (a host copy of :func:`pack`'s result)
    with the dtypes and shapes of ``like``."""
    out, off = [], 0
    for x in like:
        dt = torch.empty((), dtype=x.dtype).numpy().dtype
        wire = np.dtype(np.uint8) if dt == np.bool_ else dt
        n = x.numel()
        arr = np.frombuffer(buf, dtype=wire, count=n, offset=off)
        arr = arr.reshape(tuple(x.shape))
        out.append(arr.view(np.bool_) if dt == np.bool_ else arr)
        off += n * wire.itemsize
    return out


def coalesced_get(tree):
    """Fetch a tree of tensors to the host in ONE transfer.

    Returns the same structure with numpy arrays (views into one
    backing buffer, to be treated as read-only).  Host numpy leaves are
    returned as they are.
    """
    leaves: list = []
    spec = _flatten(tree, leaves)
    cuda = [i for i, x in enumerate(leaves)
            if isinstance(x, torch.Tensor) and x.device.type == "cuda"]
    out = [x.numpy() if isinstance(x, torch.Tensor) and x.device.type == "cpu"
           else x for x in leaves]
    if cuda:
        like = [leaves[i] for i in cuda]
        for i, arr in zip(cuda, unpack(pack(like).cpu().numpy(), like)):
            out[i] = arr
    return _unflatten(spec, out)
