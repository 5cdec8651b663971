"""ready_wait_ms_p50.live: median over blocks of the time a block's
results sat ready on the host before the next ``feed`` drained them:
its ``drain`` span's start less its ``fetch`` span's end (0 where the
drain began first), over the blocks that ran untraced."""
from ._common import percentile
from ._spans import blocks


def read(run, win, verdict):
    waits = []
    for b in blocks():
        drain, fetch = b.span("drain"), b.span("fetch", "fetch")
        if drain is not None and fetch is not None:
            waits.append(max(drain.start - fetch.end, 0) / 1e6)
    return percentile(waits, 50)
