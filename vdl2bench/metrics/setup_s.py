"""setup_s: process start to the first timed block (imports, kernel
load, the scene made on the device, the warm-up of the cell's shapes,
the pipeline's construction)."""


def read(run, win, verdict):
    return run.setup_s
