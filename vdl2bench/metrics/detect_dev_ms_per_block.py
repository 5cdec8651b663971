"""detect_dev_ms_per_block: mean milliseconds a block of the device's
timeline between the two CUDA events the pipeline records in stream
order before and after detect (the channelizer, K1, KC), read without a
synchronize, over the blocks that ran untraced.  Not detect's kernel
time: the interval also holds the device's idle time while the host is
still enqueuing the step, and any copy of the fetch thread (an earlier
block's) that the shared stream ran between the two events."""
from ._spans import blocks, mean


def read(run, win, verdict):
    return mean(b.detect_dev for b in blocks())
