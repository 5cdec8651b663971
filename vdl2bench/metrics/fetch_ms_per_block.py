"""fetch_ms_per_block: mean milliseconds of a block's ``fetch`` span on
the pipeline's fetch thread (``coalesced_get``: the pack, the copy to
the host, the unpack), over the blocks that ran untraced."""
from ._spans import mean_ms


def read(run, win, verdict):
    return mean_ms("fetch", "fetch")
