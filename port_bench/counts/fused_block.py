"""Kernel B: the rest of a v1 block after kernel A (LN1, Q, attention over
K/V, the out-projection and residual, LN2 and the MLP and residual). FLOPs
of the products; bytes of x, K, V and the weights read once, the output
written once."""

from port_bench.flops import nbytes


def count(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, ln2_weight, ln2_bias, w1, b1, w2, b2,
          *, heads, eps1, eps2):
    b, n, d = x.shape
    m = k.shape[2]
    hidden = w1.shape[0]
    flops = 2 * b * n * d * d * 2 + 2 * 2 * b * n * m * d + 2 * 2 * b * n * d * hidden
    return flops, nbytes(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, ln2_weight, ln2_bias,
                         w1, b1, w2, b2) + nbytes(x)
