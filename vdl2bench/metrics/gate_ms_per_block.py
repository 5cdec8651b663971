"""gate_ms_per_block: the pipeline's own synchronized timer of the
``gate`` step (``VDL2Pipeline.step_ms``), over the blocks of the
traced run's first stretch."""


def read(run, win, verdict):
    if not run.step_ms or "gate" not in run.step_ms:
        return None
    return run.step_ms["gate"] / run.step_blocks
