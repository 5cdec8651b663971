"""dispatch_ms_p90.live: 90th percentile over blocks of the pipeline's
``dispatch`` span (the enqueue of detect, L2 and the gate), over the
blocks that ran untraced."""
from ._common import percentile
from ._spans import span_ms


def read(run, win, verdict):
    return percentile(span_ms("dispatch"), 90)
