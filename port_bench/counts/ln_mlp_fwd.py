"""#12: x + s * fc2(GELU(fc1(LN(x)))). FLOPs of fc1 and fc2; bytes of x and
the weights read once, the output written once."""

from port_bench.flops import nbytes


def count(x, gamma, beta, w1, b1, w2, b2, row_scale, eps):
    rows = x.numel() // x.shape[-1]
    d, hidden = x.shape[-1], w1.shape[0]
    return 4 * rows * d * hidden, nbytes(x, gamma, beta, w1, b1, w2, b2, row_scale) + nbytes(x)
