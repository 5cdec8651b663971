"""l2_dev_ms_per_block: mean milliseconds a block of the device's
timeline between the CUDA events the pipeline records in stream order
after detect and after L2 (the front and L2P), read without a
synchronize, over the blocks that ran untraced.  Not L2's kernel time:
the interval also holds the device's idle time while the host enqueues
the step, and any fetch-thread copy the stream ran in between."""
from ._spans import blocks, mean


def read(run, win, verdict):
    return mean(b.l2_dev for b in blocks())
