"""host_ms_per_block: the pipeline's own synchronized timer of the
``fetch_host`` step (``VDL2Pipeline.step_ms``), over the blocks of the
traced run's first stretch."""


def read(run, win, verdict):
    if not run.step_ms or "fetch_host" not in run.step_ms:
        return None
    return run.step_ms["fetch_host"] / run.step_blocks
