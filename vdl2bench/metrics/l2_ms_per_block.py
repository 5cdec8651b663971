"""l2_ms_per_block: the pipeline's own synchronized timer of the
``l2`` step (``VDL2Pipeline.step_ms``), over the blocks of the
traced run's first stretch."""


def read(run, win, verdict):
    if not run.step_ms or "l2" not in run.step_ms:
        return None
    return run.step_ms["l2"] / run.step_blocks
