"""What the readers of the pipeline's span log share: the blocks of the
newest pipeline's log (``dumpvdl2_tpu_torch/core/spans.py``,
``spans.latest()``) that ran as untraced blocks run, neither with
``step_ms`` (``synced``) nor under the profiler (``profiled``).  A
program without the log gives no blocks, and each reader then None."""
from __future__ import annotations


def blocks() -> list:
    try:
        from dumpvdl2_tpu_torch.core import spans
    except ImportError:
        return []
    log = spans.latest()
    if log is None:
        return []
    return [b for b in list(log.blocks) if not b.synced and not b.profiled]


def mean(values) -> float | None:
    """Mean of the values that are not None; None when there is none."""
    v = [x for x in values if x is not None]
    return sum(v) / len(v) if v else None


def mean_ms(name: str, thread: str = "main") -> float | None:
    """Mean milliseconds of span ``name`` on ``thread`` a block, over
    the blocks that have it."""
    return mean(b.ms(name, thread) for b in blocks())


def span_ms(name: str) -> list:
    """Milliseconds of span ``name`` (main thread) of each block that
    has it."""
    return [m for m in (b.ms(name) for b in blocks()) if m is not None]
