"""copy_ms.<unit>: device ms a unit of work of the drivers' layout copies
(the transposes between four-step levels): kernels launched inside a step
under a layout operation (``trace.LAYOUT_OPS``)."""


def read(run):
    ms = run.trace.device_ms("copy")
    return ms / run.window.units if ms > 0 else None
