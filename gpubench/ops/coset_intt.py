"""coset_intt: the inverse of ``coset_ntt``."""

ARGS = 1


def points(x):
    return x[0].numel()


def program(prog, x):
    return prog.api.coset_intt(x, prog.field, shift=prog.shift, **prog.io)


def reference(ref, x):
    return ref.coset_intt(x)
