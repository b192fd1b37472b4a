"""coset_ntt: the forward transform over the coset shift·<ω_n>, the shift
the configuration's ``coset_shift``."""

ARGS = 1


def points(x):
    return x[0].numel()


def program(prog, x):
    return prog.api.coset_ntt(x, prog.field, shift=prog.shift, **prog.io)


def reference(ref, x):
    return ref.coset_ntt(x)
