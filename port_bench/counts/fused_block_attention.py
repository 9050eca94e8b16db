"""Kernel C: the attention half of a v2 block after kernel A (LN1, Q,
attention over K/V, the out-projection and residual). FLOPs of the products;
bytes of x, K, V and the weights read once, the output written once."""

from port_bench.flops import nbytes


def count(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, *, heads, eps):
    b, n, d = x.shape
    m = k.shape[2]
    flops = 2 * b * n * d * d * 2 + 2 * 2 * b * n * m * d
    return flops, nbytes(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp) + nbytes(x)
