"""dist_ntt: the forward transform of a vector sharded over the cell's
cards, in the distributed four-step's own layouts
(``ntt_tpu_torch.parallel.dist_ntt``): with n = n1·n2 (n1 >= n2), the
input A[i1, i2] = x[i1·n2 + i2] split by columns, uint32[W, n1, n2/D] a
card, and the output X[k2·n1 + k1] as [k2, k1] split by columns k1,
uint32[W, n2, n1/D] a card. The local transform and the exchange are the
configuration's ``local`` and ``exchange``."""

import torch

from gpubench import shard

ARGS = 1
SHARDED = True


def split(n):
    """n1, n2 of the four-step split, n1 >= n2."""
    log_n = n.bit_length() - 1
    return 1 << (log_n - log_n // 2), 1 << (log_n // 2)


def input_layout(W, n, D):
    n1, n2 = split(n)
    return shard.columns(W, n1, n2, D)


def output_layout(W, n, D):
    n1, n2 = split(n)
    return shard.columns(W, n2, n1, D)


def points(x):
    return x[0][0].numel() * len(x)


def program(prog, x):
    return prog.dist.dist_ntt(x, prog.field, prog.mesh, points(x),
                              mont_io=prog.io["mont_io"],
                              algorithm=prog.options["local"],
                              exchange=prog.options["exchange"])


#: elements a chunk of the plain four-step transforms at once: its int64
#: halves and the product's temporaries stay near 2 GiB at W = 8
CHUNK = 1 << 22


def reference(ref, x):
    """The four-step plainly (the control in the program's place): column
    transforms times the twiddle ω_n^{k1·i2}, the exchange as copies, row
    transforms; in column chunks of about :data:`CHUNK` elements, each
    chunk on every card in turn, so that the cards work together."""
    D = len(x)
    W, n1, n2_loc = x[0].shape
    n, n1_loc = n1 * n2_loc * D, n1 // D
    C = [torch.empty_like(c) for c in x]
    step = max(1, CHUNK // n1)
    for j in range(0, n2_loc, step):
        for d in range(D):
            C[d][:, :, j:j + step] = ref.ntt_twiddled(
                x[d][:, :, j:j + step], n, d * n2_loc + j)
    rows = []               # card e: [W, n2, n1_loc], k1 = e·n1_loc + k
    for e in range(D):
        parts = [C[d].view(torch.int32)[:, e * n1_loc:(e + 1) * n1_loc]
                 .to(x[e].device) for d in range(D)]
        rows.append(torch.cat(parts, dim=2).transpose(1, 2).contiguous()
                    .view(torch.uint32))
        del parts
    del C
    out = [torch.empty_like(r) for r in rows]
    step = max(1, CHUNK // (n2_loc * D))
    for k in range(0, n1_loc, step):
        for e in range(D):
            out[e][:, :, k:k + step] = ref.ntt(rows[e][:, :, k:k + step])
    return out


def reference_at(ref, blocks, n, S, r):
    """The outputs X[r + S·t], t < n/S, from the input's natural-order
    blocks."""
    return ref.ntt_residue(blocks, n, S, r)
