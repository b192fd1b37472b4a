"""idle_pass_ms.<unit>: ms a unit of work with no operation on the card
while the host was in the self intervals of the ``ntt.pass.*`` spans
(layer: elementwise passes; the program's passes inside its transforms):
the traced window's idle gaps split by overlap, so that the layers' shares
add up (``gpubench.spans``). None where the window holds no ``ntt.api``
span."""

from gpubench import spans


def read(run):
    s = spans.of(run.trace)
    if s is None:
        return None
    return s.idle_ms("elementwise passes") / run.window.units
