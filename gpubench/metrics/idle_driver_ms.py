"""idle_driver_ms.<unit>: ms a unit of work with no operation on the card
while the host was in the self intervals of the ``ntt.level``,
``ntt.base`` and ``ntt.copy`` spans (layer: drivers): the traced window's
idle gaps split by overlap, so that the layers' shares add up
(``gpubench.spans``). None where the window holds no ``ntt.api`` span."""

from gpubench import spans


def read(run):
    s = spans.of(run.trace)
    return None if s is None else s.idle_ms("drivers") / run.window.units
