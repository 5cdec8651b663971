"""stack_ms_per_frame: host milliseconds of the protocol stack and the
JSON output (FrameDecoder.process_all), over the frames it was given,
outside the profiled stretch."""


def read(run, win, verdict):
    n = win.get("stack_frames", 0)
    return win["stack_s"] / n * 1e3 if n else None
