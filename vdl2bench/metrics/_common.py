"""Arithmetic the metric readers share: percentiles over every frame,
due times, and the frames of the window mapped to their bursts."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float | None:
    """The q-th percentile (linear between closest ranks, numpy's
    default) of all values; None when there are none."""
    v = np.asarray(list(values), np.float64)
    return float(np.percentile(v, q)) if v.size else None


def known_frames(run, win):
    """(call, return time, burst row, frame) of each returned frame that
    carries a transmitted burst's bytes."""
    idx = run.scene.payload_index()
    for call, t_ret, fr in win["emitted"]:
        j = idx.get(bytes(fr.frame))
        if j is not None:
            yield call, t_ret, j, fr


def due_time(win: dict, sample: int) -> float:
    """Wall time at which raw sample ``sample`` of a paced stream was
    due from the radio: the stream's start on the wall clock plus the
    sample's index over the sample rate."""
    return win["start"] + sample * win["period"] / win["block"]
