"""driver_ms.<unit>: host ms a unit of work in the drivers' own code: the
self time of the ``ntt.level``, ``ntt.base`` and ``ntt.copy`` spans (the
four-step levels, the last base transform, the layout copies), outside the
kernel launches nested in them (``gpubench.spans``). None where the window
holds no ``ntt.api`` span."""

from gpubench import spans


def read(run):
    s = spans.of(run.trace)
    return None if s is None else s.self_ms("drivers") / run.window.units
