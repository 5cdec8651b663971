"""ingest_roofline.file: the ingest kernel's share of its bound: the
least time to read a block's raw samples and write its planar float32
block at the card's device memory rate (bounds.ingest_bound) over the
kernel's mean device time a call in the profiled stretch, in percent.
None where the trace holds no such kernel."""
from .. import bounds

KERNEL = "ingest_kernel"


def read(run, win, verdict):
    prof = win.get("profile")
    if prof is None:
        return None
    calls = sum(v["calls"] for k, v in prof["kernels"].items()
                if KERNEL in k)
    secs = sum(v["seconds"] for k, v in prof["kernels"].items()
               if KERNEL in k)
    if not calls or secs <= 0:
        return None
    bound = bounds.ingest_bound(run.block, run.cfg["sample_format"])
    return bound["bound_ms"] / (secs / calls * 1e3) * 100.0
