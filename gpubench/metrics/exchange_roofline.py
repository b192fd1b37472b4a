"""exchange_roofline.<unit>: the exchange's least time over its device time
a transform a card, in %. The least time is ``roofline.exchange_bytes``,
the elements each card must receive in the four-step's layouts whatever
the exchange does, at NVLink's rate into one card; the device time is K8's
(``a2a_pull_kernel``, found by name) over the window's transforms and the
traced cards. A faster exchange moves only the time. None on one card,
shards of one card included: nothing crosses NVLink there."""

from gpubench import roofline

K8 = "a2a_pull_kernel"


def read(run):
    ms = run.trace.named_ms(K8)
    transforms = run.window.points / run.n
    cards = len(run.trace.cards)
    if ms <= 0 or transforms <= 0 or cards < 2:
        return None
    least = (roofline.exchange_bytes(run.n, run.elem_bytes, cards)
             / roofline.NVLINK_BYTES_PER_S)
    return 100.0 * least / (ms / 1e3 / transforms / cards)
