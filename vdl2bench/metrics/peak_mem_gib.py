"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window."""


def read(run, win, verdict):
    return run.peak / 2 ** 30 if run.peak else None
