"""sub_mod: a - b mod p, one of the plain elementwise passes."""

ARGS = 2


def points(a):
    return 0


def program(prog, a, b):
    return prog.limbs.sub_mod(a, b, prog.field)


def reference(ref, a, b):
    return ref.sub_mod(a, b)
