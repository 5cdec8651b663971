"""h2d_ms_p90.live: 90th percentile over blocks of ``feed``'s
``feed.h2d`` span (the residual's concatenation, the planar split and
the pageable copy to the device), over the blocks that ran untraced."""
from ._common import percentile
from ._spans import span_ms


def read(run, win, verdict):
    return percentile(span_ms("feed.h2d"), 90)
