"""#10: softmax(q k^T * scale) v with its log-sum-exp. FLOPs of q k^T and
p v; bytes of q, k, v read once, o and the fp32 lse written once."""

from port_bench.flops import nbytes


def count(q, k, v, scale):
    b, h, n, hd = q.shape
    m = k.shape[2]
    return 4 * b * h * n * m * hd, nbytes(q, k, v) + nbytes(q) + b * h * n * 4
