"""fetch_lag_dev_ms_per_block: mean milliseconds a block of the device's
timeline from the CUDA event after its last step to the one its fetch
records before its first operation (both in stream order): about 0 when
the fetch runs right after its block, about a detect when it queues
behind the next block's work; idle time in between counts too.  Over
the blocks that ran untraced."""
from ._spans import blocks, mean


def read(run, win, verdict):
    return mean(b.fetch_lag_dev for b in blocks())
