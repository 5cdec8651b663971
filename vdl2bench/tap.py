"""What the timed path produced, kept for the check after the window.

The tap wraps the two calls of ``core/pipeline.py`` that a block's
dispatch makes, ``process_block_detect`` and ``l2_sliced``, where the
pipeline module looks them up.  For the blocks it is told to keep (and
always the latest one) it holds references to what they returned: the
block's phase and power planes, its detections and its L2 results.
It copies nothing, synchronizes nothing and launches nothing, so the
blocks run as they would without it; the kept tensors are freed by
``close``.
"""
from __future__ import annotations


class Tap:
    def __init__(self, pipe, keep: set):
        from dumpvdl2_tpu_torch.core import pipeline as mod
        self.mod, self.pipe, self.keep = mod, pipe, set(keep)
        self.kept: dict = {}
        self.latest = None
        self.block = -1
        self._cur = None
        self._detect, self._l2 = mod.process_block_detect, mod.l2_sliced
        mod.process_block_detect = self.detect
        mod.l2_sliced = self.l2

    def detect(self, iq, taps, dphi, n0, carry, hist, *args, **kw):
        out = self._detect(iq, taps, dphi, n0, carry, hist, *args, **kw)
        self.block += 1
        rec = {"block": self.block, "base": int(self.pipe.hist_base),
               "dets": out[0], "phases": out[1], "pwr": out[2],
               "l2": None, "inv": None}
        self._cur = rec
        self.latest = rec
        if self.block in self.keep:
            self.kept[self.block] = rec
        return out

    def l2(self, *args, flush: bool = False, **kw):
        out = self._l2(*args, flush=flush, **kw)
        if not flush and self._cur is not None:
            self._cur["l2"], self._cur["inv"] = out
        self._cur = None
        return out

    def records(self) -> list:
        """The kept blocks and the latest one, in block order."""
        recs = dict(self.kept)
        if self.latest is not None:
            recs[self.latest["block"]] = self.latest
        return [recs[k] for k in sorted(recs)]

    def close(self) -> None:
        self.mod.process_block_detect = self._detect
        self.mod.l2_sliced = self._l2

    def release(self) -> None:
        self.kept, self.latest, self._cur = {}, None, None
