"""idle_dist_ms.<unit>: ms a unit of work with no operation on a card
while the host was in the self intervals of the ``ntt.dist.*`` spans (the
distributed four-step's own steps, ``dist_ms``), the cards' mean: each
card's idle gaps overlapped with those intervals (``gpubench.spans.
overlap``). None where the window holds no ``ntt.api`` span."""

from gpubench import harness, spans


def read(run):
    if spans.of(run.trace) is None:
        return None
    view = run.trace
    pieces = harness.load_reader("dist_ms").pieces(view)
    idle = sum(spans.overlap(view.gaps(card), pieces) for card in view.cards)
    return idle / len(view.cards) / 1e3 / run.window.units
