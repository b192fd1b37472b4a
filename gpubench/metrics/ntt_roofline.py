"""ntt_roofline: the least time of the window's transforms under
``gpubench.roofline``'s implementation-free work model over the traced
window's device-busy time (over several cards the least time on all of
them over the cards' mean busy time), in %. The result's ``notes`` say
which bound, operations, bytes or the exchange, sets the least time."""

from gpubench import roofline


def read(run):
    if run.trace.busy_s <= 0 or run.window.points <= 0:
        return None
    least, _ = roofline.least_time(run.n, run.elem_bytes, run.chips)
    transforms = run.window.points / run.n
    return 100.0 * least * transforms / run.trace.busy_s
