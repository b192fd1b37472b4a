"""div_vanishing: the division by the vanishing polynomial X^n - 1 of the
n-point domain on the coset, where it is the constant shift^n - 1: one
Montgomery product by its inverse (n is the vector's axis 1)."""

ARGS = 1


def points(x):
    return 0


def _inverse(p, shift, n):
    return pow(pow(shift, n, p) - 1, -1, p)


def program(prog, x):
    return prog.scale(x, _inverse(prog.field.p, prog.shift, x.shape[1]))


def reference(ref, x):
    return ref.scale(x, _inverse(ref.f.p, ref.shift, x.shape[1]))
