"""graph_block_share: the share of the blocks that ran untraced whose
``dispatch`` replayed the three device steps' CUDA graphs (the record's
``graphed`` flag, ``dumpvdl2_tpu_torch/core/graphs.py``), over the
blocks with a ``dispatch`` span.  None where the log's records carry no
such flag (a program without graphs)."""
from ._spans import blocks


def read(run, win, verdict):
    flags = [getattr(b, "graphed", None) for b in blocks()
             if b.ms("dispatch") is not None]
    flags = [f for f in flags if f is not None]
    return sum(flags) / len(flags) if flags else None
