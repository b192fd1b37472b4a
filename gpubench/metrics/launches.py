"""launches.<unit>: the program's kernel launches a unit of work in the
window, from its wrappers' own counter (``kernels/_build.launches``)."""


def read(run):
    return run.launches / run.window.units if run.launches else None
