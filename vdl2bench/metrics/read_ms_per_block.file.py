"""read_ms_per_block.file: mean milliseconds a block of the file read
that filled its staging buffer (span ``read`` of a ``feed_raw`` record,
io/iqfile.py::feed_iq_file), over the blocks that ran untraced.  None
where the log has no such span (a program without the file path)."""
from ._spans import mean_ms


def read(run, win, verdict):
    return mean_ms("read")
