"""exchange_ms.<unit>: device ms a unit of work of the distributed
four-step's exchange, kernel K8, found by name (``a2a_pull_kernel``, one
launch a card a transform), summed over the cell's cards."""

K8 = "a2a_pull_kernel"


def read(run):
    ms = run.trace.named_ms(K8)
    return ms / run.window.units if ms > 0 else None
