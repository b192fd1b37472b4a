"""dist_ms.<unit>: host ms a unit of work in the distributed four-step's
own steps: the self time of the ``ntt.dist.*`` spans (each card's local
transforms, the step-2 products, the exchange), outside the program spans
nested in them (the drivers' levels and copies, the kernel launches;
``gpubench.spans.self_intervals``). None where the window holds no
``ntt.api`` span."""

from gpubench import spans

DIST = "ntt.dist."


def pieces(view) -> list:
    """Sorted (start, end) self intervals of the window's ``ntt.dist.*``
    spans."""
    program = [s for s in view.spans if s[2].startswith(spans.PREFIX)]
    return sorted((s, e) for s, e, name in spans.self_intervals(program)
                  if name.startswith(DIST))


def read(run):
    if spans.of(run.trace) is None:
        return None
    return sum(e - s for s, e in pieces(run.trace)) / 1e3 / run.window.units
