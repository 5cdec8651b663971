"""pfb_block_share: the share of the blocks that ran untraced whose
channelizer ran the polyphase filter bank (the record's ``pfb`` flag,
``dumpvdl2_tpu_torch/dsp/pfb_kernel.py``; a graphed block's as decided
at its capture), over the blocks with a ``dispatch`` span.  None where
the log's records carry no such flag (a program without the bank)."""
from ._spans import blocks


def read(run, win, verdict):
    flags = [getattr(b, "pfb", None) for b in blocks()
             if b.ms("dispatch") is not None]
    flags = [f for f in flags if f is not None]
    return sum(flags) / len(flags) if flags else None
