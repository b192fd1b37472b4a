"""ntt: the forward transform along axis 1, natural order in and out."""

ARGS = 1


def points(x):
    return x[0].numel()


def program(prog, x):
    return prog.api.ntt(x, prog.field, **prog.io)


def reference(ref, x):
    return ref.ntt(x)
