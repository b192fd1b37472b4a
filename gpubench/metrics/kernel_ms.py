"""kernel_ms.<unit>: device ms a unit of work of the program's own CUDA
kernels (every kernel whose name is not a library's)."""


def read(run):
    ms = run.trace.device_ms("port")
    return ms / run.window.units if ms > 0 else None
