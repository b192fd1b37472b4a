"""ntt_p95_ms: the 95th percentile, by nearest rank, of every unit's time in
the window, each on the host clock from its call until the wait for the
card that covers it returns: the time a prover's pipeline stalls on."""

import math


def read(run):
    lat = sorted(run.window.latencies_ms)
    return lat[math.ceil(0.95 * len(lat)) - 1]
