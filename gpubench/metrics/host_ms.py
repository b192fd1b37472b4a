"""host_ms.<unit>: host ms a unit of work spent inside the calls into the
program (the ``step.*`` spans: the API, the runner cache, the drivers'
launches), up to each call's return and before the wait for the card.
Taken under the profiler, so it holds the profiler's own cost a PyTorch
operation."""


def read(run):
    ms = run.trace.span_ms("step.")
    return ms / run.window.units if ms > 0 else None
