"""realtime_factor: seconds of signal fed in the window over the wall
seconds from the first feed to the return of finish() and the last
frame through the protocol stack and its output."""


def read(run, win, verdict):
    return win["raw_fed"] / run.scene.fs / (win["t1"] - win["t0"])
