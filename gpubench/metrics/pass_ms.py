"""pass_ms.<unit>: device ms a unit of work of the plain elementwise passes:
the PyTorch kernels launched inside the steps under any operation but a
layout copy (limbs' products, subtractions, conversions; the n^-1 scale and
the inverse coset product inside the inverse transforms)."""


def read(run):
    ms = run.trace.device_ms("pass")
    return ms / run.window.units if ms > 0 else None
