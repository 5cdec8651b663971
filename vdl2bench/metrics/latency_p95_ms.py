"""latency_p95_ms: 95th percentile over every frame of the window that
carries a transmitted burst of: the wall time at which feed or finish
returned it, less the time its burst's last sample was due from the
radio (the stream's start on the wall clock plus the sample's index
over the sample rate).  A stall delays every later frame."""
from ._common import due_time, known_frames, percentile


def read(run, win, verdict):
    return percentile(
        ((t_ret - due_time(win, int(run.scene.end[j]))) * 1e3
         for _, t_ret, j, _ in known_frames(run, win)), 95)
