"""#13: the LN-MLP backward. Its own work, without recomputing fc1's output:
the input and weight gradients of fc2 and of fc1, four products of
2 rows D H each (8 in all). Bytes of x, dy and the weights read once; dx
(x's type) and the fp32 parameter gradients written once."""

from port_bench.flops import nbytes


def count(x, gamma, beta, w1, b1, w2, row_scale, eps, dy):
    rows = x.numel() // x.shape[-1]
    d, hidden = x.shape[-1], w1.shape[0]
    grads = 4 * (2 * d * hidden + hidden + 3 * d)
    return 8 * rows * d * hidden, nbytes(x, gamma, beta, w1, b1, w2, row_scale, dy) + nbytes(x) + grads
