"""launch_ms.<unit>: host ms a unit of work inside the kernel wrappers'
CUDA branches, the ``ntt.launch.*`` spans: operand checks, plan arguments,
the output's allocation and the ctypes call (``gpubench.spans``). None
where the window holds no ``ntt.api`` span."""

from gpubench import spans


def read(run):
    s = spans.of(run.trace)
    return None if s is None else s.self_ms("kernels") / run.window.units
