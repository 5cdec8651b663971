"""device_idle_share: one less the union of device intervals over the
wall of the profiled stretch, in percent; nothing where the trace holds
no device operation."""


def read(run, win, verdict):
    prof = win.get("profile")
    if prof is None or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return (1.0 - prof["busy_s"] / prof["window_s"]) * 100.0
