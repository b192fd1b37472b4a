"""api_ms.<unit>: host ms a unit of work in the program's API layer: the
self time of its ``ntt.api`` spans (argument checks, the runner cache's key
and lookup, the closures a call runs, the ``donate`` copy), outside the
program spans nested in them (``gpubench.spans``). None where the window
holds no ``ntt.api`` span."""

from gpubench import spans


def read(run):
    s = spans.of(run.trace)
    return None if s is None else s.self_ms("API") / run.window.units
