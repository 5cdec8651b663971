"""drain_wait_ms_per_block: mean milliseconds the main thread waits in
a block's drain for its fetch (the ``drain.wait`` span: the device's
work and the fetch thread's copy not done yet), over the blocks that
ran untraced."""
from ._spans import mean_ms


def read(run, win, verdict):
    return mean_ms("drain.wait")
