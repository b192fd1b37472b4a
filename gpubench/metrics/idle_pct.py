"""idle_pct.<unit>: the share of the traced window in which no operation
ran on the card, in %."""


def read(run):
    return 100.0 * run.trace.idle_share()
