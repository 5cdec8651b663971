"""ingest_ms_per_block.file: mean milliseconds a block of ``feed_raw``'s
``feed.h2d`` span (the staging buffer's copy to the device enqueued from
pinned memory and the ingest kernel launched), over the blocks that ran
untraced.  None where no record holds a ``feed_raw`` span."""
from ._spans import blocks, mean


def read(run, win, verdict):
    return mean(b.ms("feed.h2d") for b in blocks()
                if b.ms("feed_raw") is not None)
