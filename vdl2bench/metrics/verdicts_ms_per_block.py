"""verdicts_ms_per_block: mean host milliseconds of a block's
``drain.verdicts`` span (``_process_verdicts``: the frames built from
the fetched verdicts and L2 rows, the counters), unsynchronized, over
the blocks that ran untraced."""
from ._spans import mean_ms


def read(run, win, verdict):
    return mean_ms("drain.verdicts")
