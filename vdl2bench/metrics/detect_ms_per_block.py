"""detect_ms_per_block: the pipeline's own synchronized timer of the
``detect`` step (``VDL2Pipeline.step_ms``), over the blocks of the
traced run's first stretch."""


def read(run, win, verdict):
    if not run.step_ms or "detect" not in run.step_ms:
        return None
    return run.step_ms["detect"] / run.step_blocks
