"""ingest_dev_ms_per_block.file: mean milliseconds a block of the
device's timeline between the two CUDA events ``feed_raw`` records in
stream order, before its copy of the raw bytes and after the ingest
kernel, read without a synchronize, over the blocks that ran untraced
(one in ``spans.EVENT_EVERY``).  Not kernel time: the interval also
holds the copy and any idle time while the host enqueues them.  None
where the records carry no such interval."""
from ._spans import blocks, mean


def read(run, win, verdict):
    return mean(getattr(b, "ingest_dev", None) for b in blocks())
