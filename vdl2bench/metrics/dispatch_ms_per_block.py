"""dispatch_ms_per_block: mean host milliseconds of the pipeline's
``dispatch`` span (``_dispatch_block``: the enqueue of detect, L2 and
the gate) a block, over the blocks that ran untraced."""
from ._spans import mean_ms


def read(run, win, verdict):
    return mean_ms("dispatch")
