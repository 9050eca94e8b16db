"""#11: the attention backward from o and lse. Its own work, without
recomputing the probabilities: dV = P^T dO, dP = dO V^T, dQ = dS K and
dK = dS^T Q, four products of 2 B H N M hd each (8 in all). Bytes of q, k,
v, o, dO and lse read once, dq, dk, dv written once."""

from port_bench.flops import nbytes


def count(q, k, v, o, lse, do, scale):
    b, h, n, hd = q.shape
    m = k.shape[2]
    return 8 * b * h * n * m * hd, nbytes(q, k, v, o, lse, do) + nbytes(q, k, v)
