"""mont_mul: the Montgomery product a·b·R^-1 of two vectors' words, one of
the plain elementwise passes."""

ARGS = 2


def points(a):
    return 0


def program(prog, a, b):
    return prog.limbs.mont_mul(a, b, prog.field)


def reference(ref, a, b):
    return ref.mont_mul(a, b)
