"""k1_roofline: the sync metric kernel's share of its bound: the least
time for the metric on the block's (C, M) phase plane (trace.k1_bound,
counted from the metric's definition) over the kernel's mean device
time a call in the profiled stretch."""
from .. import trace as tracing

KERNEL = "sync_metric_kernel"


def read(run, win, verdict):
    prof = win.get("profile")
    if prof is None or run.k1_shape is None:
        return None
    calls = sum(v["calls"] for k, v in prof["kernels"].items()
                if KERNEL in k)
    secs = sum(v["seconds"] for k, v in prof["kernels"].items()
               if KERNEL in k)
    if not calls or secs <= 0:
        return None
    bound = tracing.k1_bound(run.k1_shape[0], run.k1_shape[1], run.sms,
                             run.clock_hz)
    return bound["bound_ms"] / (secs / calls * 1e3) * 100.0
