"""setup_s: seconds from process start to the first timed unit: imports,
the card's start, the kernels' build or load, the inputs, the runners'
tables and the warm-up units."""


def read(run):
    return run.setup_s
