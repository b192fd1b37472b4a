"""ntt_gelem_s: the points of every transform completed in the window over
the window's length, in 10^9 points a second (host clock)."""


def read(run):
    return run.window.points / run.window.seconds / 1e9
