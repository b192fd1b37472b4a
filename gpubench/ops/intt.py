"""intt: the inverse transform, with its scale by n^-1."""

ARGS = 1


def points(x):
    return x[0].numel()


def program(prog, x):
    return prog.api.intt(x, prog.field, **prog.io)


def reference(ref, x):
    return ref.intt(x)
