"""emit_wait_ms_p50.live: median over frames of the time the frame was
returned less the time the block holding its burst's last sample was
released to feed (the pipeline's queue and drain)."""
from ._common import known_frames, percentile


def read(run, win, verdict):
    rel = win["released"]
    waits = []
    for _, t_ret, j, _ in known_frames(run, win):
        b = int(run.scene.end[j]) // win["block"]
        if b < len(rel):
            waits.append((t_ret - rel[b]) * 1e3)
    return percentile(waits, 50)
