"""pass_ms.<unit>: device ms a unit of work of the elementwise passes: the
program's pass kernels, found by name (``passes::field_pass_kernel``, one
launch a pass: limbs' products, subtractions, conversions, the n^-1 scale
and the inverse coset product inside the inverse transforms), and any
PyTorch kernel still launched inside a step under an operation but a
layout copy (class ``pass``). The pass kernels read under
``kernel_ms.<unit>`` too, with every other kernel of the program."""

PASS_KERNEL = "passes::field_pass_kernel"


def read(run):
    ms = run.trace.named_ms(PASS_KERNEL) + run.trace.device_ms("pass")
    return ms / run.window.units if ms > 0 else None
