"""feed_ms_p95.live: 95th percentile of the host time inside each feed
call (dispatch of the block's device work and the drain of finished
blocks)."""
from ._common import percentile


def read(run, win, verdict):
    return percentile((s * 1e3 for s in win["feed_s"]), 95)
